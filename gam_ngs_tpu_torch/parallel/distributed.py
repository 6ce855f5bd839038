"""Multi-process runtime: partition sharding + result regathering.

gam_ngs_tpu/parallel/distributed.py on torch.distributed.  The merge
workload's unit of distribution is the graph partition (independent by
construction): processes take disjoint partition subsets, run the
batched build locally on their own device, and every process
reassembles the results in canonical graph order, so host 0's output
files stay byte-identical to the single-process run.

The collectives are pickled host objects over a gloo process group
(torch.distributed.all_gather_object), on the CPU and on GPU runs
alike:
  * library statistics: host 0's .isize values;
  * edge props of the partition phase;
  * paired contigs: the per-partition build results.
Every process parses the same inputs deterministically, so nothing else
is broadcast.

Single-process runs short-circuit every collective, so the same code
path serves one process and many.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch.distributed as dist

# Set after any BarrierTimeout: every process must issue collectives in
# the same program order, and a timed-out collective is still in flight
# on the abandoned worker thread, so any further collective from this
# process would pair with the orphan and corrupt or hang the group.
# Once poisoned, the process must terminate.
_poisoned: str | None = None


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> tuple[int, int]:
    """Join the gloo process group at tcp://<coordinator> as rank
    `process_id` of `num_processes`; returns (rank, world size)."""
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def proc_info() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_partitions(sizes: list[int], num_hosts: int, host_id: int
                     ) -> list[int]:
    """Deterministic size-balanced assignment: graphs sorted by
    descending size go round-robin to the least-loaded host (greedy
    LPT).  Returns the canonical indices owned by `host_id`; every host
    computes the same assignment, so no coordination is needed."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    load = [0] * num_hosts
    own: list[list[int]] = [[] for _ in range(num_hosts)]
    for i in order:
        h = min(range(num_hosts), key=lambda k: (load[k], k))
        own[h].append(i)
        load[h] += max(1, sizes[i])
    return sorted(own[host_id])


class BarrierTimeout(RuntimeError):
    """A cross-host collective did not complete within the deadline —
    some peer host is hung or dead.  The reference has no distributed
    mode and thus no detector (SURVEY.md §5); here a silent pod-wide
    hang is converted into a loud, attributable failure.

    **Unrecoverable.**  The timed-out collective is still in flight on
    an abandoned worker thread; issuing any further collective from
    this process would mismatch program order across the pod.  The
    process is poisoned (every later allgather_obj raises immediately)
    and must exit.  Set GAM_BARRIER_FATAL=1 to have the process
    os._exit(1) instead of raising.
    """


def _poison(msg: str):
    global _poisoned
    _poisoned = msg
    if os.environ.get("GAM_BARRIER_FATAL", "") not in ("", "0"):
        print(f"[distributed] fatal: {msg}", file=sys.stderr, flush=True)
        os._exit(1)


def _reset_poison():
    """Clear the poisoned state (tests only — a real process must exit)."""
    global _poisoned
    _poisoned = None


def _with_deadline(fn, timeout_s: float, what: str):
    """Run `fn` in a worker thread; raise BarrierTimeout (poisoning the
    process — see BarrierTimeout) if it does not finish within
    `timeout_s` seconds (<=0 disables the deadline)."""
    if timeout_s <= 0:
        return fn()
    box: list = []
    err: list = []

    def worker():
        try:
            box.append(fn())
        except BaseException as e:  # propagate to the caller thread
            err.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        msg = (f"{what} did not complete within {timeout_s:.0f}s — "
               f"a peer host is likely hung or dead")
        _poison(msg)
        raise BarrierTimeout(msg)
    if err:
        raise err[0]
    return box[0]


def barrier_timeout_s() -> float:
    """Collective deadline in seconds (env GAM_BARRIER_TIMEOUT,
    default 600; 0 disables).  Malformed or negative values are
    rejected loudly rather than silently disabling the deadline."""
    raw = os.environ.get("GAM_BARRIER_TIMEOUT", "600")
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"invalid GAM_BARRIER_TIMEOUT={raw!r}: expected a number of "
            f"seconds (0 disables the deadline)") from None
    if v < 0:
        raise ValueError(
            f"invalid GAM_BARRIER_TIMEOUT={raw!r}: must be >= 0 "
            f"(0 disables the deadline)")
    return v


def _all_gather_object(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def allgather_obj(local_obj, timeout_s: float | None = None,
                  _gather=None) -> list:
    """All-gather an arbitrary picklable object across processes
    (returns [obj] single-process).  The object travels pickled through
    torch.distributed.all_gather_object; the whole exchange (its size
    and payload collectives) shares ONE `timeout_s` deadline, raising
    BarrierTimeout on expiry.  A BarrierTimeout is **unrecoverable**
    (see its docstring): this process is poisoned and every later call
    raises immediately — the caller must terminate the process, not
    retry.  `_gather` overrides the collective (tests): it takes this
    process's object and returns every process's, in rank order."""
    if _poisoned is not None:
        raise BarrierTimeout(
            f"process poisoned by an earlier barrier timeout "
            f"({_poisoned}); collectives are no longer safe — exit")

    if proc_info()[1] == 1 and _gather is None:
        return [local_obj]

    if _gather is None:
        _gather = _all_gather_object
    if timeout_s is None:
        timeout_s = barrier_timeout_s()

    return _with_deadline(lambda: _gather(local_obj), timeout_s,
                          "object allgather")


def distributed_build_pctgs(graphs, master_ref, slave_ref, master_bam,
                            slave_bam, engine, no_mult_filter=False,
                            debug=False, log=None):
    """Partition-sharded merge across the process group.

    Each process builds its shard with the batched scheduler; results
    are allgathered and reassembled in canonical graph order.  Returns
    the full pctg list (identical on every process; the caller on
    host 0 writes outputs).
    """
    from ..merge.builder import build_pctgs_batched

    pid, n = proc_info()
    sizes = [g.n for g in graphs]
    mine = shard_partitions(sizes, n, pid)
    local_graphs = [graphs[i] for i in mine]
    local_pctgs: list = []
    per_graph: dict[int, list] = {}

    t0 = time.time()
    cells0 = getattr(engine, "cells_aligned", 0)
    build_pctgs_batched(local_graphs, master_ref, slave_ref, master_bam,
                        slave_bam, local_pctgs, engine, no_mult_filter,
                        debug, log=log, per_graph_out=per_graph)
    if log is not None and n > 1:
        # per-host align COMPUTE seconds (before the allgather wait)
        # plus per-host aligned CELLS — the wall seconds are polluted
        # by contention when all processes share one machine, so the
        # cells (work units actually dispatched by this host) are the
        # direct division evidence
        log(f"[dist] host {pid}: align compute seconds = "
            f"{time.time() - t0:.4f} over {len(local_graphs)} owned "
            f"graphs ({sum(g.n for g in local_graphs)} vertices)")
        log(f"[dist] host {pid}: aligned cells = "
            f"{getattr(engine, 'cells_aligned', 0) - cells0}")
        if hasattr(engine, "kernel_launches"):
            # this process's kernel launches so far (0 on the CPU)
            log(f"[dist] host {pid}: kernel launches = "
                f"{json.dumps(engine.kernel_launches(), sort_keys=True)}")

    # allgather per-graph contributions; splice in canonical graph
    # order (cg_id keys), so the result equals the sequential run
    all_parts = allgather_obj(per_graph)
    combined: dict[int, list] = {}
    for part in all_parts:
        combined.update(part)
    merged: list = []
    for g in graphs:
        merged.extend(combined.get(g.cg_id, []))
    return merged
