"""gam n50 — FASTA assembly statistics.

Reference: src/n50.cc.  Note the reference's N50/L50
labels are swapped relative to convention (N50 = #sequences, L50 =
length); we reproduce its output format.
"""

from __future__ import annotations

from ..utils.cppfmt import cpp_double
from ..utils.misc import path_basename


def n50_stats(path: str):
    lengths: list[int] = []
    with open(path) as fh:
        content = fh.read()
    i = 0
    n = len(content)
    while i < n:
        while i < n and content[i] in (" ", "\n"):
            i += 1
        if i >= n:
            break
        if content[i] != ">":
            raise ValueError(f"{path_basename(path)}: Incorrect fasta file")
        eol = content.find("\n", i)
        if eol == -1:
            eol = n
        i = eol + 1
        length = 0
        while i < n and content[i] != ">":
            j = i
            while j < n and content[j] not in (" ", "\n", "\t"):
                j += 1
            token = content[i:j]
            for ch in token:
                if not ch.isalpha():
                    raise ValueError(
                        f"{path_basename(path)}: Incorrect fasta file")
            length += len(token)
            i = j
            while i < n and content[i] in (" ", "\n", "\t"):
                i += 1
        lengths.append(length)

    lengths.sort()
    tot = sum(lengths)
    max_len = lengths[-1] if lengths else 0
    min_len = lengths[0] if lengths else 0

    n50 = 0
    l50 = 0
    acc = 0
    for ln in reversed(lengths):
        if 2 * acc >= tot:
            break
        acc += ln
        n50 += 1
        l50 = ln
    return dict(total=tot, count=len(lengths), max=max_len, min=min_len,
                n50=n50, l50=l50)


def run_n50(path: str, log=print) -> None:
    s = n50_stats(path)
    avg = (s["total"] * 1.0) / s["count"] if s["count"] else float("nan")
    log(f"{path_basename(path)} statistics:")
    log(f"Total length = {s['total']}\tAverage = {cpp_double(avg)}"
        f"\tMax = {s['max']}\tMin = {s['min']}")
    log(f"Sequences = {s['count']}")
    log(f"N50 = {s['n50']}")
    log(f"L50 = {s['l50']}")
