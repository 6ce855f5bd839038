"""Whether the window's answers are right: a sample of them, drawn from
the seed, against the plain reference (reference.py).

The candidates are the problems of the pool of stages the window
cycles through; the sample is `check_problems` of them drawn uniformly
from the seed, and always the longest, each judged by its answer in the
last round that answered it.  A problem the window never reached is
not judged.  Each answer is compared with the reference's on every
field an Alignment holds (reference.summary): an answer that never came,
or that differs in any field, is wrong.  The limit is 0.
"""

from __future__ import annotations

import numpy as np

from . import reference
from .generate import rng_for

WRONG_LIMIT = 0


def program_summary(al) -> tuple | None:
    """reference.summary() of one of the program's Alignments (lean, or
    with its edit string); None for a missing answer."""
    if al is None:
        return None
    if al.lean is not None:
        n, matches, first, last = al.lean
        homology = al.homology
        return (int(al.begin_a), int(al.begin_b), int(al.a_size),
                int(al.b_size), int(al.score), homology, int(n), int(matches),
                (bool(first[0]), (int(first[1][0]), int(first[1][1]))),
                (bool(last[0]), (int(last[1][0]), int(last[1][1]))))
    edits = np.asarray(al.edits, np.uint8)
    s = reference.summary(al.begin_a, al.begin_b, al.a_size, al.b_size,
                          al.score, edits,
                          int((edits == reference.MATCH).sum()))
    # the program's own homology, compared as it returned it
    return s[:5] + (al.homology,) + s[6:]


def sample(stages, seed: int, k: int) -> dict:
    """The pool's problems whose answers are checked: k drawn from the
    seed, and the longest.  {(stage, round): [index in the round]}."""
    where = [(p, r, i) for p, st in enumerate(stages)
             for r, rows in enumerate(st.round_rows)
             for i in range(len(rows))]
    if not where:
        return {}
    rows = np.concatenate([x for st in stages for x in st.round_rows])
    rng = rng_for(seed, 2)
    pick = set(rng.choice(len(where), min(k, len(where)),
                          replace=False).tolist())
    pick.add(int(np.argmax(rows)))
    out: dict = {}
    for n in sorted(pick):
        p, r, i = where[n]
        out.setdefault((p, r), []).append(i)
    return out


def compare(problems: list, answers: list, band: int, workers: int) -> int:
    """How many of `answers` to `problems` differ from the reference's."""
    want = reference.align_parallel(problems, band, np.int32, workers)
    return sum(program_summary(g) != w for g, w in zip(answers, want))
