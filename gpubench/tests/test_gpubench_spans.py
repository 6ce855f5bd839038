"""spans.py, the reader of the program's own spans: each metric to the
exact value on synthetic spans and device intervals (idle gaps partly
inside a span, nested spans, a bsw.fetch that does not count, calls on
both sides of 64 live problems), a trace and a call_log that do not
pair, a program with no call_log; and a traced run on the CPU through
traced_run."""

import types

import pytest

from gpubench import spans
from gpubench.tests.conftest import ROOT  # noqa: F401  (sys.path)

WINDOW = (0.0, 100.0)
# busy (10, 40) and (60, 80): 50 of 100; idle (0, 10), (40, 60), (80, 100)
DEVICE = [(10.0, 30.0), (25.0, 40.0), (60.0, 80.0)]
HOST = [
    ("bsw.align_many", 0.0, 50.0),     # 100 live problems
    ("bsw.prepare", 2.0, 8.0),         # idle 2-8
    ("bsw.pack", 8.0, 14.0),           # idle 8-10, then busy
    ("bsw.launch", 14.0, 16.0),
    ("bsw.fetch", 16.0, 42.0),         # idle 40-42, not the engine's work
    ("bsw.decode", 42.0, 48.0),        # idle
    ("bsw.pack", 44.0, 46.0),          # nested in the decode
    ("bsw.align_many", 55.0, 95.0),    # 10 live problems
    ("bsw.prepare", 55.0, 58.0),       # idle
    ("bsw.upload", 58.0, 62.0),        # idle 58-60, then busy
    ("bsw.launch", 62.0, 63.0),
    ("bsw.fetch", 63.0, 82.0),         # idle 80-82, not counted
    ("bsw.host_walk", 82.0, 90.0),     # idle
]
CALL_LOG = [(100, 3), (10, 1)]


def test_each_metric_exactly():
    out = spans.compute(WINDOW, DEVICE, HOST, CALL_LOG)
    # work: (2, 16) 14 + (42, 48) 6 + (55, 63) 8 + (82, 90) 8
    assert out.engine_host_pct == pytest.approx(36.0, abs=1e-12)
    # idle in work: 2-10 8 + 42-48 6 + 55-60 5 + 82-90 8
    assert out.engine_idle_pct == pytest.approx(27.0, abs=1e-12)
    # the 10-problem call holds busy 60-80: 20 of 50
    assert out.small_round_busy_pct == pytest.approx(40.0, abs=1e-12)
    assert out.busy_in_calls_pct == pytest.approx(100.0, abs=1e-12)
    assert out.calls == 2 and out.spans == len(HOST)


@pytest.mark.parametrize("live,want", [(64, 40.0), (65, 0.0)])
def test_small_call_bound(live, want):
    out = spans.compute(WINDOW, DEVICE, HOST, [(100, 3), (live, 1)])
    assert out.small_round_busy_pct == pytest.approx(want, abs=1e-12)


def test_window_clips_and_busy_outside_calls():
    """Spans and device intervals past the window are cut to it; device
    time outside every call lowers busy_in_calls_pct."""
    host = [("bsw.align_many", -10.0, 20.0), ("bsw.pack", -5.0, 5.0)]
    out = spans.compute(WINDOW, [(-3.0, 2.0), (15.0, 25.0), (98.0, 120.0)],
                        host, [(1, 1)])
    assert out.engine_host_pct == pytest.approx(5.0, abs=1e-12)
    assert out.engine_idle_pct == pytest.approx(3.0, abs=1e-12)
    # busy 0-2, 15-25, 98-100 = 14; in the call 0-2, 15-20 = 7
    assert out.small_round_busy_pct == pytest.approx(50.0, abs=1e-12)
    assert out.busy_in_calls_pct == pytest.approx(50.0, abs=1e-12)


def test_no_device_events():
    out = spans.compute(WINDOW, [], HOST, CALL_LOG)
    assert out.engine_host_pct == pytest.approx(36.0, abs=1e-12)
    assert out.engine_idle_pct is None
    assert out.small_round_busy_pct is None
    assert out.busy_in_calls_pct is None


@pytest.mark.parametrize("call_log", [CALL_LOG[:1], CALL_LOG + [(5, 1)]])
def test_unpaired_trace_raises(call_log):
    with pytest.raises(ValueError, match="call_log"):
        spans.compute(WINDOW, DEVICE, HOST, call_log)


def _prof(events):
    import torch

    dt = torch.autograd.DeviceType
    evs = [types.SimpleNamespace(
        name=n, device_type=dt.CUDA if dev else dt.CPU,
        time_range=types.SimpleNamespace(start=a, end=b))
        for n, a, b, dev in events]
    return types.SimpleNamespace(events=lambda: evs)


def test_summarize_reads_the_trace():
    """summarize takes the window, the device's events but the
    benchmark's own mirrored ranges, and the bsw spans; it reports
    program names found among the device's events."""
    from gpubench import trace

    events = ([(trace.WINDOW, *WINDOW, False), (trace.WINDOW, *WINDOW, True),
               (trace.ROUND, 0.0, 50.0, False), (trace.ROUND, 0.0, 50.0, True),
               ("aten::empty", 3.0, 4.0, False)]
              + [(n, a, b, False) for n, a, b in HOST]
              + [("kernel", a, b, True) for a, b in DEVICE])
    eng = types.SimpleNamespace(call_log=list(CALL_LOG))
    out = spans.summarize(_prof(events), eng)
    assert out.engine_idle_pct == pytest.approx(27.0, abs=1e-12)
    assert out.small_round_busy_pct == pytest.approx(40.0, abs=1e-12)
    assert out.mirrored == []
    out = spans.summarize(_prof(events + [("bsw.pack", 41.0, 43.0, True)]),
                          eng)
    assert out.mirrored == ["bsw.pack"]
    # the mirrored event counts as busy, as trace.summarize counts it
    assert out.engine_idle_pct == pytest.approx(26.0, abs=1e-12)


def test_program_without_call_log_reads_nothing():
    """A program whose engine keeps no call_log (no spans) gives None."""
    assert spans.summarize(_prof([]), types.SimpleNamespace()) is None


def test_traced_run_on_the_cpu(tiny_root, one_thread):
    """A traced run at the tiny size on the CPU: engine_host_pct reads,
    the two that need device events read nothing, and the harness's own
    result line and trace reader are as without this reader."""
    import torch

    from gpubench import trace

    summarize_trace = trace.summarize
    result, out = spans.traced_run(tiny_root, "gage-rsph.align",
                                   2**31 + 97, 0.5,
                                   device=torch.device("cpu"))
    assert trace.summarize is summarize_trace
    assert result["correct"] is True
    assert 0.0 < out.engine_host_pct <= 100.0
    assert out.calls > 0 and out.spans > out.calls
    assert out.engine_idle_pct is None
    assert out.small_round_busy_pct is None
    assert out.mirrored == []
    assert not any(name.startswith(("engine_", "small_round"))
                   for name in result["metrics"])
