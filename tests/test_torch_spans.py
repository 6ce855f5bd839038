"""The port's host spans on the CPU: BswEngine's `bsw.*` spans (one
`bsw.align_many` and one `bsw.prepare` a call; `bsw.pack`, `bsw.upload`,
`bsw.launch`, `bsw.fetch` and `bsw.decode`, or `bsw.host_walk` under the
host traceback, a chunk; all nested in their call's `bsw.align_many`)
and its `call_log` on every path and with the sequence arena;
Metrics.phase's `gam.<phase>` spans, the merge's `bsw.*` spans inside
`gam.align`; answers unchanged by a recording profiler, nothing kept
without one, and no span a record_function user annotation (which the
profiler mirrors onto the device's timeline)."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_problems as tp
from gam_ngs_tpu_torch.models.create import CreateOptions, run_create
from gam_ngs_tpu_torch.models.merge import MergeOptions, run_merge
from gam_ngs_tpu_torch.ops.bsw_engine import BswEngine
from gam_ngs_tpu_torch.utils.metrics import Metrics

CPU = torch.device("cpu")
BAND = 40
PATHS = {"device": {}, "row": {"kernel": "row"},
         "host": {"traceback": "host"}}
CHUNK_SPANS = ("bsw.pack", "bsw.upload", "bsw.launch", "bsw.fetch")
quiet = lambda *_: None  # noqa: E731


def _case(path, arena):
    """(engine, calls): two align_many calls over problems of several
    window buckets, chunks of at most 6."""
    if arena:
        contigs, problems = tp.arena_problems(20, seed=7, max_len=300)
    else:
        contigs, problems = None, tp.soak_problems(20, seed=7, max_len=300)
    eng = BswEngine(CPU, band=BAND, max_batch=6, **PATHS[path])
    if contigs:
        eng.register_contigs(contigs)
    return eng, [problems[:12], problems[12:]]


def _spans(prof, prefixes=("bsw.",)):
    """(name, start ns, end ns) of the trace's host events named with one
    of `prefixes`, outermost first, from the profiler's raw events (the
    plain kernels' hundreds of thousands of operators are not parsed)."""
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith(prefixes)]
    # host operators, not record_function's user annotations
    assert not any(e.is_user_annotation() for e in ev)
    assert {e.device_type() for e in ev} <= {torch.autograd.DeviceType.CPU}
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in ev),
                  key=lambda s: (s[1], -s[2]))


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.mark.parametrize("path,arena", [("device", False), ("row", False),
                                        ("host", False), ("device", True),
                                        ("row", True)])
def test_engine_spans_and_call_log(path, arena):
    eng, calls = _case(path, arena)
    ref, _ = _case(path, arena)
    want = [ref.align_many(c) for c in calls]  # unprofiled
    assert ref.call_log == []
    assert all(len({xw for _, xw, _ in eng._plan(c)[1]}) >= 2 for c in calls)
    d0, live0 = eng.dispatches, eng.util["live"]
    grew = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = []
        for c in calls:
            d, n = eng.dispatches, eng.util["live"]
            got.append(eng.align_many(c))
            grew.append((eng.util["live"] - n, eng.dispatches - d))
    chunks, live = eng.dispatches - d0, eng.util["live"] - live0
    assert eng.call_log == grew
    assert (eng.arena_chunks > 0) == arena
    for g, w in zip(got, want):
        assert all(tp.same_alignment(a, b) for a, b in zip(g, w))

    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("bsw.align_many") == len(calls)
    assert names.count("bsw.prepare") == len(calls)
    for n in CHUNK_SPANS:
        assert names.count(n) == chunks, n
    last = "bsw.host_walk" if path == "host" else "bsw.decode"
    other = "bsw.decode" if path == "host" else "bsw.host_walk"
    assert names.count(last) == chunks and other not in names
    assert len(set(names)) == 7 and chunks > len(calls)

    outer = [s for s in spans if s[0] == "bsw.align_many"]
    assert sum(n for n, _ in eng.call_log) == live
    assert sum(c for _, c in eng.call_log) == chunks
    for call, (n_live, n_chunks) in zip(outer, eng.call_log):
        inner = [s for s in spans if s is not call and _inside(s, call)]
        assert [s[0] for s in inner].count("bsw.pack") == n_chunks
        assert [s[0] for s in inner].count("bsw.prepare") == 1
        assert 0 < n_live <= max(len(c) for c in calls)
    for s in spans:
        if s[0] != "bsw.align_many":
            assert sum(_inside(s, o) for o in outer) == 1, s


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_off_path_keeps_nothing(path, monkeypatch):
    """Without a profiler: answers unchanged and call_log empty; the
    engine never enters record_function, profiled or not."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    eng, calls = _case(path, False)
    got = [eng.align_many(c) for c in calls]
    assert eng.call_log == []
    want = [tp.oracle(c, BAND) for c in calls]
    for g, w in zip(got, want):
        assert all(tp.same_alignment(a, b) for a, b in zip(g, w))
    with profile(activities=[ProfilerActivity.CPU]):
        eng.align_many(calls[1])
    assert len(eng.call_log) == 1


def test_phase_is_a_span():
    m = Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.phase("x"):
            time.sleep(0.01)
    with m.phase("x"):
        time.sleep(0.01)
    ev = _spans(prof, ("gam.",))
    assert [n for n, _, _ in ev] == ["gam.x"]
    assert ev[0][2] - ev[0][1] >= 0.01e9
    assert m.phases["x"] >= 0.02


def test_merge_phases_hold_the_engine_spans(tmp_path):
    """A merge under a profiler: the merge's phases as gam.* spans, and
    every bsw.align_many inside gam.align."""
    _genome, ml, sl, mfa, sfa = tp.junction_corpus(tmp_path)
    run_create(CreateOptions(master_bam_file=ml, slave_bam_file=sl,
                             min_block_size=10,
                             output_file_prefix=str(tmp_path / "out"),
                             engine="native"), log=quiet)
    eng = BswEngine(CPU, traceback="host")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_merge(MergeOptions(
            master_bam_file=ml, slave_bam_file=sl,
            blocks_file=str(tmp_path / "out.blocks"), master_fasta_file=mfa,
            slave_fasta_file=sfa, min_block_size=10,
            output_file_prefix=str(tmp_path / "m"), engine=eng), log=quiet)
    ev = _spans(prof, ("gam.", "bsw.align_many"))
    names = [n for n, _, _ in ev]
    for p in ("load_bams", "partition", "load_seqs", "partition_fetch",
              "align"):
        assert names.count("gam." + p) == 1, p
    align = next(s for s in ev if s[0] == "gam.align")
    calls = [s for s in ev if s[0] == "bsw.align_many"]
    assert calls and len(calls) == len(eng.call_log)
    assert all(_inside(c, align) for c in calls)
