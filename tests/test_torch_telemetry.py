"""The port's ``StageTimers`` spans and percentiles (CPU): nested spans and
their ``<parent>.<child>`` names, the module-level span that does nothing
without a parent, one stack per thread, children out of the bottleneck
pick, parent totals that children leave alone, the span log that fills
only under a profiler and on ``time.perf_counter_ns``, its bound, and
exact percentiles held to ``numpy.percentile(..., method="inverted_cdf")``,
and the scenario engine's spans and counters inside ``iter_chunks``'
dispatch, absent from the scenario-free stream and leaving the bits alone.
The last test runs the chunked entry points on the card (``fetch.pin`` and
``fetch.wait`` exist only there)."""

import os
import threading
import time

import numpy as np
import pytest

from psrsigsim_torch.runtime import StageTimers
from psrsigsim_torch.runtime import telemetry
from psrsigsim_torch.runtime.telemetry import span


def test_children_are_named_after_their_parent():
    t = StageTimers()
    with t.span("dispatch", chunk=256):
        with span("keys"):
            with span("rounds"):
                pass
        with span("keys"):
            pass
        with span("priors"):
            pass
    snap = t.snapshot()
    assert snap["dispatch_calls"] == 1
    assert snap["dispatch.keys_calls"] == 2
    assert snap["dispatch.keys.rounds_calls"] == 1
    assert snap["dispatch.priors_calls"] == 1
    assert "keys_calls" not in snap and "rounds_calls" not in snap


def test_a_dotted_stage_is_a_child_of_its_prefix():
    t = StageTimers()
    with t.span("fetch.pin", chunk=0):
        with span("alloc"):
            pass
    snap = t.snapshot()
    assert snap["fetch.pin_calls"] == snap["fetch.pin.alloc_calls"] == 1
    assert snap["fetch_calls"] == 0


def test_module_span_without_a_parent_does_nothing():
    t = StageTimers()
    before = t.snapshot()
    with span("keys"):
        with span("rounds"):
            pass
    after = t.snapshot()
    before.pop("wall_s"), after.pop("wall_s")
    assert before == after
    # once a span closed, the thread has none open again
    with t.span("dispatch"):
        pass
    with span("keys"):
        pass
    assert "dispatch.keys_calls" not in t.snapshot()


def test_host_keys_count_their_threefry_calls():
    """Inside a span, each threefry call on host keys bumps
    ``rng.host_calls`` in the span's timers; with no span open nothing is
    counted and nothing fails."""
    import torch

    from psrsigsim_torch.utils import rng

    t = StageTimers()
    k = rng.key(0, "cpu")
    rng.stage_key(k, "user", torch.arange(4))
    telemetry.count("rng.host_calls")
    assert "rng.host_calls_count" not in t.snapshot()
    with t.span("dispatch", chunk=0):
        with span("keys"):
            rng.stage_key(k, "user", torch.arange(4))
        rng.random_bits(k, 3)
    snap = t.snapshot()
    assert snap["rng.host_calls_count"] == 3
    assert "rng.torch_calls_count" not in snap


def test_spans_are_per_thread():
    main, other = StageTimers(), StageTimers()
    opened, go = threading.Event(), threading.Event()

    def worker():
        opened.wait(5)
        # the main thread's span is open, but not on this thread
        with span("keys"):
            pass
        with other.span("fetch"):
            with span("wait"):
                pass
        go.set()

    th = threading.Thread(target=worker)
    th.start()
    with main.span("dispatch"):
        opened.set()
        go.wait(5)
        with span("keys"):
            pass
    th.join(5)
    assert not th.is_alive()
    a, b = main.snapshot(), other.snapshot()
    assert a["dispatch.keys_calls"] == 1 and "fetch.wait_calls" not in a
    assert b["fetch.wait_calls"] == 1 and "dispatch.keys_calls" not in b


def test_threads_sharing_one_timers_lose_no_span():
    """More threads than cores open spans and children on one shared
    ``StageTimers`` under a profiler, switching every microsecond: every
    span is counted, each child lands under its own thread's parent, and
    the log keeps every span (it is not full)."""
    import sys

    from torch.profiler import ProfilerActivity, profile

    t = StageTimers()
    n_threads, n_each = 2 * (os.cpu_count() or 4), 200
    errors = []

    def worker(k):
        try:
            stage = f"s{k}"
            for i in range(n_each):
                with t.span(stage, chunk=i):
                    with span("keys"):
                        pass
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    snap = t.snapshot()
    for k in range(n_threads):
        assert snap[f"s{k}_calls"] == snap[f"s{k}.keys_calls"] == n_each
    log = snap["spans"]
    assert len(log) == 2 * n_threads * n_each and snap["spans_dropped"] == 0
    for stage, t0, t1, parent, _ in log:
        assert t0 <= t1
        if parent is not None:
            assert stage == parent + ".keys"


def test_children_are_left_out_of_the_bottleneck():
    t = StageTimers(extra_stages=("reduce",))
    t.add("dispatch", 1.0)
    t.add("fetch", 2.0)
    t.add("dispatch.keys", 5.0)
    t.add("fetch.wait.more", 9.0)
    assert t.snapshot()["bottleneck"] == "fetch"


def test_children_leave_the_parent_total_alone():
    calls = []

    class Recording(StageTimers):
        def add(self, stage, seconds, nbytes=0):
            calls.append((stage, seconds, nbytes))
            super().add(stage, seconds, nbytes)

    t = Recording()
    t0 = time.perf_counter()
    with t.span("fetch", chunk=0) as s:
        for _ in range(3):
            with span("wait"):
                time.sleep(0.002)
        s.nbytes = 4096
    wall = time.perf_counter() - t0
    # spans close through add(): three children, then the parent once,
    # with its bytes
    assert [c[0] for c in calls] == ["fetch.wait"] * 3 + ["fetch"]
    parent = calls[-1][1]
    assert sum(c[1] for c in calls[:3]) <= parent <= wall
    snap = t.snapshot()
    assert snap["fetch_calls"] == 1 and snap["fetch_bytes"] == 4096
    assert snap["fetch_s"] == round(parent, 6)


def test_the_log_fills_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    t = StageTimers()
    with t.span("dispatch", chunk=0):
        with span("keys"):
            pass
    assert "spans" not in t.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        lo = time.perf_counter_ns()
        with t.span("dispatch", chunk=128):
            with span("keys"):
                pass
            with span("priors"):
                pass
        hi = time.perf_counter_ns()
    with t.span("dispatch", chunk=256):
        pass
    snap = t.snapshot()
    assert snap["spans_dropped"] == 0
    log = snap["spans"]
    assert [e[0] for e in log] == ["dispatch.keys", "dispatch.priors",
                                   "dispatch"]
    assert [e[3] for e in log] == ["dispatch", "dispatch", None]
    assert [e[4] for e in log] == [128] * 3
    for _, t0, t1, _, _ in log:
        assert lo <= t0 <= t1 <= hi
    # the children lie inside their parent
    assert log[2][1] <= log[0][1] and log[1][2] <= log[2][2]


def test_the_log_is_bounded_and_counts_what_it_dropped():
    from torch.profiler import ProfilerActivity, profile

    t = StageTimers()
    extra = 7
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(telemetry.SPAN_LOG_MAX + extra):
            with t.span("write", chunk=i):
                pass
    snap = t.snapshot()
    assert len(snap["spans"]) == telemetry.SPAN_LOG_MAX
    assert snap["spans_dropped"] == extra
    # oldest dropped first
    assert snap["spans"][0][4] == extra
    assert snap["spans"][-1][4] == telemetry.SPAN_LOG_MAX + extra - 1
    assert snap["write_calls"] == telemetry.SPAN_LOG_MAX + extra


@pytest.mark.parametrize("n", [1, 2, 7, 20, 100, 999, 4096, 5000])
def test_percentiles_are_exact_over_the_latest_samples(n):
    rng = np.random.default_rng(n)
    samples = rng.lognormal(-5.0, 1.5, size=n)
    t = StageTimers(extra_stages=("request",), latency_stages=("request",))
    for s in samples:
        t.add("request", float(s))
    kept = samples[-telemetry.SAMPLES_KEPT:]
    snap = t.snapshot()
    for tag, q in (("p50", 50), ("p95", 95), ("p99", 99)):
        want = float(np.percentile(kept, q, method="inverted_cdf"))
        assert snap[f"request_{tag}_s"] == round(want, 6)
        assert t.percentile("request", q / 100) == want
    assert snap["request_calls"] == n
    assert "request" != snap["bottleneck"]


def test_percentile_of_a_silent_stage_is_zero():
    t = StageTimers()
    assert t.percentile("write", 0.95) == 0.0
    assert "write_p95_s" not in t.snapshot()


def test_the_histogram_and_the_duplicate_byte_total_are_gone():
    t = StageTimers()
    t.add("fetch", 0.01, nbytes=100)
    snap = t.snapshot()
    assert snap["fetch_bytes"] == 100 and "bytes_fetched" not in snap
    assert not hasattr(t, "histogram")
    for name in ("latency_bin_index", "latency_bin_edges", "LATENCY_NBINS"):
        assert not hasattr(telemetry, name)


SCENARIO = ["scintillation", "rfi", "single_pulse:lognormal"]
EFFECT_SPANS = ("dispatch.scenario.scintillation", "dispatch.scenario.rfi",
                "dispatch.scenario.single_pulse")


def _ensemble(scenario):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_pipeline import _geometry

    from psrsigsim_torch.parallel import FoldEnsemble

    return FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                        device="cpu", scenario=scenario)


def _chunks(ens, timers, **kw):
    """Four observations in chunks of two, quantized, as host copies."""
    return [(start, tuple(np.array(a) for a in block))
            for start, block in ens.iter_chunks(4, chunk_size=2, seed=3,
                                                quantized=True,
                                                timers=timers, **kw)]


def test_the_scenario_draws_are_spans_inside_the_dispatch():
    """A scenario stream logs ``dispatch.scenario`` once a chunk, each
    effect's draws as its child, and counts the factor cells and the
    distinct scintle keys."""
    ens = _ensemble(SCENARIO)
    t = StageTimers()
    _chunks(ens, t, rfi_mask=True,
            scenario_params={"scint_mod": np.array([0.2, 0.5, 0.8, 1.0])})
    snap = t.snapshot()
    assert snap["dispatch_calls"] == snap["dispatch.scenario_calls"] == 2
    for name in EFFECT_SPANS:
        assert snap[f"{name}_calls"] == 2
    children = sum(snap[f"{name}_s"] for name in EFFECT_SPANS)
    assert children <= snap["dispatch.scenario_s"] <= snap["dispatch_s"]
    cells = 4 * ens.cfg.meta.nchan * ens.cfg.nsub
    assert snap["scenario.cells_count"] == cells
    assert 0 < snap["scenario.scint_keys_count"] <= cells


def test_the_scenario_free_stream_logs_no_scenario_span():
    t = StageTimers()
    _chunks(_ensemble(None), t)
    snap = t.snapshot()
    assert snap["dispatch_calls"] == 2
    assert not [k for k in snap if "scenario" in k]


def test_timers_leave_the_scenario_bits_alone():
    ens = _ensemble(SCENARIO)
    timed = _chunks(ens, StageTimers(), rfi_mask=True)
    plain = _chunks(ens, None, rfi_mask=True)
    assert [s for s, _ in timed] == [s for s, _ in plain] == [0, 2]
    for (_, a), (_, b) in zip(timed, plain):
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.cuda
def test_the_card_reports_pinned_buffers_and_waits():
    """On the card: ``iter_chunks`` reports ``fetch.pin`` and
    ``fetch.wait`` and the study ``fetch.wait``, each inside its parent."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned buffers and the device "
                    "waits exist only there")
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_pipeline import _geometry

    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.parallel import FoldEnsemble

    ens = FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                       device="cuda")
    t = StageTimers()
    for _ in ens.iter_chunks(8, chunk_size=2, seed=3, quantized=True,
                             fetch_ahead=2, timers=t):
        pass
    snap = t.snapshot()
    assert snap["fetch.pin_calls"] == snap["fetch.wait_calls"] \
        == snap["fetch_calls"] == 4
    assert snap["fetch.pin_s"] + snap["fetch.wait_s"] <= snap["fetch_s"]
    assert snap["dispatch.keys_s"] <= snap["dispatch_s"]
    study = ens.to_mc_study({"dm": {"dist": "uniform", "lo": 5.0,
                                    "hi": 20.0}}, seed=3)
    assert isinstance(study, MonteCarloStudy)
    tel = StageTimers(extra_stages=("reduce",))
    study.run(8, chunk_size=4, telemetry=tel)
    snap = tel.snapshot()
    assert snap["fetch.wait_calls"] == snap["fetch_calls"] == 2
    assert snap["fetch.wait_s"] <= snap["fetch_s"]
    assert snap["dispatch.keys_calls"] >= 2
    assert snap["dispatch.priors_calls"] >= 2
