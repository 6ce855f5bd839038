"""Wavefront scheduler: drive many alignment generators in lockstep.

Replaces the reference's pthread pool over graph partitions
(lib/src/pctg/ThreadedBuildPctg.cc:144-198) with device batching: every
per-vertex alignMergeBlock task is a generator (merge.align) that yields
banded-SW problems one chained window at a time; each scheduler round
collects the current problem of every live task and solves them in ONE
BswEngine.align_many call (shape-bucketed batches on the accelerator).

Chains advance independently — a task that needs 2 windows finishes
while a 40-window chain keeps going, so the device batch shrinks only
as the longest chains drain (wavefront, not barrier-per-window).  Each
generator receives exactly the Alignment sequence the sequential driver
would produce, so results are bit-identical to reference order and the
canonical (--threads 1) output ordering is preserved by construction.
"""

from __future__ import annotations

from .align import align_merge_block_gen


def drive_batched(gens: list, engine) -> tuple[int, dict[int, Exception]]:
    """Drive generators in lockstep rounds.

    Returns (rounds, errors): a generator that raises is dropped and its
    exception recorded under its index — per-task failure isolation, the
    analogue of the reference's per-graph catch-all
    (ThreadedBuildPctg.cc:319-327).
    """
    errors: dict[int, Exception] = {}
    pending: dict[int, tuple] = {}
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
        except StopIteration:
            pass
        except Exception as exc:  # noqa: BLE001 — isolate task failures
            errors[i] = exc

    rounds = 0
    while pending:
        rounds += 1
        idx = list(pending.keys())
        results = engine.align_many([pending[i] for i in idx])
        nxt: dict[int, tuple] = {}
        for i, res in zip(idx, results):
            try:
                nxt[i] = gens[i].send(res)
            except StopIteration:
                pass
            except Exception as exc:  # noqa: BLE001
                errors[i] = exc
        pending = nxt
    return rounds, errors


def align_merge_blocks_batched(jobs, engine
                               ) -> tuple[int, dict[int, Exception]]:
    """jobs: iterable of (graph, merge_block, master_ref, slave_ref).

    Aligns every merge block, batching across vertices AND graphs.
    """
    gens = [align_merge_block_gen(g, mb, mref, sref)
            for g, mb, mref, sref in jobs]
    return drive_batched(gens, engine)
