"""The readers of the program's spans, on a synthetic record and trace: the
milliseconds a chunk of each child stage over its parent's calls, and the
device's idle share under the study's host keys and prior draws (two
device intervals, host spans inside and outside the gap between them, the
trace's clock offset from the host's).  A program without the spans, as
an older one, reads None."""

from types import SimpleNamespace

import pytest

from benchmark import harness, spans

MS = 1_000_000
LO = 1_000 * 1_000 * MS          # the window's start on the host clock (ns)
OFF = 500 * MS                   # device clock = host clock + OFF

TIMERS = {"dispatch_s": 0.5, "dispatch_calls": 10,
          "dispatch.keys_s": 0.02, "dispatch.priors_s": 0.1,
          "fetch_s": 0.3, "fetch_calls": 5,
          "fetch.pin_s": 0.01, "fetch.wait_s": 0.2}


def _run(log=None, dropped=0, timers=TIMERS, trace=True):
    t = dict(timers)
    if log is not None:
        t["spans"] = log
        t["spans_dropped"] = dropped
    tr = None
    if trace:
        # device busy 0-100 ms and 300-500 ms of the window
        tr = SimpleNamespace(
            t0=LO / 1e9, offset_ns=OFF,
            events=[("k1", LO + OFF, 100 * MS),
                    ("fold", LO + OFF + 300 * MS, 200 * MS)])
    return SimpleNamespace(record={"timers": t}, trace=tr,
                           busy_s=0.3 if trace else None,
                           window_s=1.0 if trace else None)


def _span(stage, a_ms, b_ms, chunk=0):
    parent = stage.rpartition(".")[0] or None
    return [stage, LO + a_ms * MS, LO + b_ms * MS, parent, chunk]


LOG = [
    _span("dispatch.keys", 50, 80),       # the card busy all through: 0
    _span("dispatch", 100, 300),          # the parent: not counted
    _span("dispatch.keys", 150, 200),     # inside the gap: 50 ms
    _span("fetch.wait", 120, 180),        # another stage: not counted
    _span("dispatch.priors", 250, 350),   # half in the gap: 50 ms
    _span("dispatch.keys", 950, 1050),    # the window's end cuts it: 50 ms
    _span("dispatch.keys", 1200, 1300),   # after the window: not counted
]


def _reader(name):
    return harness.load_reader(name)


@pytest.mark.parametrize("name, want", [
    ("stream.keys_ms", 2.0), ("stream.pin_ms", 2.0), ("mc.keys_ms", 2.0),
    ("mc.priors_ms", 10.0), ("mc.fetch_wait_ms", 40.0),
    ("stream.fetch_wait_ms", 40.0)])
def test_a_child_reads_its_seconds_over_its_parents_calls(name, want):
    assert _reader(name)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["stream.keys_ms", "stream.pin_ms",
                                  "mc.keys_ms", "mc.priors_ms",
                                  "mc.fetch_wait_ms",
                                  "stream.fetch_wait_ms"])
def test_a_program_without_the_child_reads_none(name):
    old = {k: v for k, v in TIMERS.items() if "." not in k}
    assert _reader(name)(_run(timers=old)) is None
    assert _reader(name)(_run(timers={})) is None


def test_idle_counts_only_the_gaps_under_keys_and_priors():
    read = _reader("device.idle_keys.trials")
    got = read(_run(LOG))
    assert got == pytest.approx(15.0)
    # never more than the whole window's idle share
    assert got <= _reader("device.idle.trials")(_run(LOG))


def test_idle_without_a_log_reads_none():
    read = _reader("device.idle_keys.trials")
    assert read(_run()) is None
    assert read(_run(LOG, dropped=3)) is None
    assert read(_run(LOG, trace=False)) is None


def test_an_empty_gap_set_reads_zero():
    read = _reader("device.idle_keys.trials")
    assert read(_run([_span("dispatch.keys", 310, 390)])) == 0.0


def test_the_programs_own_log_is_read():
    """A log written by the program's ``StageTimers`` under a profiler: with
    no device operation in the window, the share is the keys' and priors'
    time over the window."""
    from torch.profiler import ProfilerActivity, profile

    from psrsigsim_torch.runtime.telemetry import StageTimers, span

    t = StageTimers()
    with profile(activities=[ProfilerActivity.CPU]):
        for chunk in (0, 256):
            with t.span("dispatch", chunk=chunk):
                with span("keys"):
                    pass
                with span("priors"):
                    pass
    snap = t.snapshot()
    log = snap["spans"]
    t0 = min(e[1] for e in log) - MS
    run = SimpleNamespace(
        record={"timers": snap},
        trace=SimpleNamespace(t0=t0 / 1e9, offset_ns=-OFF, events=[]),
        busy_s=0.0, window_s=1.0)
    under = sum(e[2] - e[1] for e in log if e[0] != "dispatch")
    got = _reader("device.idle_keys.trials")(run)
    assert got == pytest.approx(100.0 * under / 1e9, rel=1e-6, abs=1e-9)
    assert _reader("mc.keys_ms")(run) == pytest.approx(
        1e3 * snap["dispatch.keys_s"] / 2)


def test_idle_ns_walks_overlapping_intervals():
    busy = [[0, 10], [20, 30], [40, 50]]
    assert spans.idle_ns([[5, 45]], busy) == 20
    assert spans.idle_ns([[-5, 0], [10, 20], [55, 60]], busy) == 20
    assert spans.idle_ns([[12, 18], [22, 28]], busy) == 6
