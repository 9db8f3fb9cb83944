"""One run of one benchmark cell: find the cell by name, set it up, measure
it for a fixed number of seconds, check what it produced against the plain
reference, and print the result as one line of JSON.

Everything that belongs to one cell, configuration or per-layer metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``benchmark/workloads/<cell>.json``: the configuration's name, the
  traffic driver and its parameters, and ``host_threads``, the PyTorch
  intra-op threads the deployment gives the program on the host (absent
  or null: PyTorch's default pool);
* ``benchmark/configs/<config>.json``: the configuration's sizes;
* ``benchmark/drivers/<driver>.py``: a class ``Cell`` (see
  :class:`CellBase`) that drives one kind of entry point of the program;
* ``benchmark/metrics/<metric>.py``: a function ``read(run)`` that takes
  the per-layer metric from the run's record, or returns None where it
  finds nothing to read.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# whole top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "psrsigsim_tpu", "bench")
PROGRAM = "psrsigsim_torch"
# the longest name a breakdown entry keeps
_NAME_CHARS = 160


class RunError(Exception):
    """A run that cannot print a result: ``code`` is its exit code."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


def seconds_since_start(fallback_t0):
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, to a clock tick), else since ``fallback_t0`` on
    the ``perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])          # field 22, starttime
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - fallback_t0


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec(root=ROOT):
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(4, f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def find_cell(spec, name, root=ROOT):
    """The cell's ``BENCHMARK.json`` entry, its file, its configuration's
    entry and file: ``(entry, cell, config_entry, config)``."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise RunError(4, f"no workload named {name!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(Path(root) / "benchmark" / "workloads" / f"{name}.json") as f:
        cell = json.load(f)
    with open(Path(root) / centry["file"]) as f:
        config = json.load(f)
    return entry, cell, centry, config


def cell_metrics(spec, name):
    """The end-to-end and per-layer metric entries this cell reports: a
    metric with a ``workloads`` key lists its cells; a per-layer metric
    without one is reported wherever the metric it moves is."""
    def has(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if has(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(metric_name, root=ROOT):
    """``read`` of ``benchmark/metrics/<metric_name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a driver gets from the harness: its device, the seed and the
    host span log."""

    def __init__(self, device, seed):
        self.device = device
        self.seed = int(seed)
        self.spans = None   # a list while a traced window runs
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name):
        """Log a host span while the window is traced (no cost otherwise)."""
        if self.spans is None:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                if self.spans is not None:
                    self.spans.append((name, t0, t1))


class CellBase:
    """A driver's cell.  ``setup`` builds, stages and warms every shape the
    window uses; ``window(seconds)`` measures; ``end_to_end`` returns the
    cell's end-to-end metrics but ``setup_s``; ``record`` what the
    per-layer readers read; ``free`` drops the program's state; ``check``
    compares with the reference and returns ``[(name, value, limit)]``,
    each value correct when at most its limit."""

    attempted = 0
    failed = 0

    def __init__(self, config, params, ctx):
        self.config = config
        self.params = params
        self.ctx = ctx

    def setup(self):
        raise NotImplementedError

    def window(self, seconds):
        raise NotImplementedError

    def end_to_end(self):
        raise NotImplementedError

    def record(self):
        return {}

    def free(self):
        pass

    def check(self):
        raise NotImplementedError


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """``torch.profiler`` over the window, device activity only (the host's
    own work is logged as spans by the drivers): every kernel, copy and
    fill with its start and length in ns."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.events = []
        self.offset_ns = 0

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        # a marker fill: its device start against the host clock now
        self.host_mark_ns = time.perf_counter_ns()
        torch.ones(1, device=self.device)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            events.append((e.name(), int(start), int(dur)))
        events.sort(key=lambda t: t[1])
        if events:
            # the first event is the marker fill
            self.offset_ns = events[0][1] - self.host_mark_ns
            events = events[1:]
        self.events = events
        return False

    def summary(self, spans, top=10):
        """``(busy_s, window_s, breakdown)`` of the traced window."""
        ev = self.events
        busy = _merge([(s, s + d) for _, s, d in ev])
        busy_s = sum(b - a for a, b in busy) / 1e9
        by_name = {}
        for name, _, d in ev:
            by_name[name] = by_name.get(name, 0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        device_ops = [[n[:_NAME_CHARS], d / 1e9] for n, d in ops]
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [(n, a + self.offset_ns, b + self.offset_ns)
                for n, a, b in (spans or ())]
        idle = []
        for g0, g1 in gaps[:top]:
            best, over = "host: no span", 0
            for n, a, b in host:
                o = min(b, g1) - max(a, g0)
                if o > over:
                    best, over = "host: " + n, o
            idle.append([best, (g1 - g0) / 1e9])
        return busy_s, self.window_s, {"device_ops": device_ops,
                                       "idle_gaps": idle}

    def kernels(self, needle):
        """Durations in seconds of the events whose name holds ``needle``."""
        return [d / 1e9 for n, _, d in self.events if needle in n]


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def set_cache_dirs(root):
    """Keep every build and kernel cache in fixed directories of the
    checkout, so that only a checkout's first run builds: the program
    builds its CUDA kernels into ``build/`` itself; a PyTorch extension or
    a Triton kernel would cache under these."""
    build = Path(root) / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def set_host_threads(torch, cell):
    """The cell's ``host_threads``, where it states them."""
    if cell.get("host_threads") is not None:
        torch.set_num_threads(int(cell["host_threads"]))


def run_cell(name, seed, seconds, trace, root=ROOT, device=None,
             require_cuda=True, config_override=None, params_override=None,
             t0=None):
    """One run of cell ``name``; returns the result dict.  ``device``,
    ``require_cuda=False`` and the overrides exist for the benchmark's own
    tests on the host; a run on the card takes none of them."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(root)
    entry, cell, _, config = find_cell(spec, name, root)
    if config_override:
        config = dict(config, **config_override)
    params = dict(cell["params"], **(params_override or {}))
    e2e, layer = cell_metrics(spec, name)
    try:
        import torch
    except ImportError as err:
        raise RunError(4, f"torch is missing: {err}") from err
    if require_cuda:
        chips = int(entry["chips"])
        if not torch.cuda.is_available():
            raise RunError(2, "no CUDA device: this benchmark runs on the "
                              "card only")
        if torch.cuda.device_count() < chips:
            raise RunError(2, f"the cell needs {chips} CUDA devices, "
                              f"{torch.cuda.device_count()} visible")
        device = "cuda"
    try:
        importlib.import_module(PROGRAM)
    except ImportError as err:
        raise RunError(4, f"the program {PROGRAM} is missing: {err}") from err
    driver = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    ctx = Context(device, seed)
    set_host_threads(torch, cell)
    c = driver.Cell(config, params, ctx)
    # what the program prints goes to standard error: standard output
    # carries the result line alone
    with contextlib.redirect_stdout(sys.stderr):
        return _measure(c, ctx, torch, entry, e2e, layer, seconds, trace,
                        root, t0)


def _measure(c, ctx, torch, entry, e2e, layer, seconds, trace, root, t0):
    """Set-up, window, metrics, check: the result dict of one run."""
    cuda = torch.device(ctx.device).type == "cuda"
    t_setup = time.perf_counter()
    c.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = seconds_since_start(t0)
    print(f"setup_s {setup_s!r} (the cell's own set-up "
          f"{time.perf_counter() - t_setup!r} s)", file=sys.stderr)
    dtrace = spans = None
    if trace and cuda:
        ctx.spans = []
        with DeviceTrace(torch, ctx.device) as dtrace:
            c.window(seconds)
        spans, ctx.spans = ctx.spans, None
    else:
        c.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    found = forbidden_modules()
    if found:
        raise RunError(3, "modules that no run may load were loaded: "
                          + ", ".join(found))

    values = dict(c.end_to_end(), setup_s=setup_s)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "host"),
                   "count": int(entry["chips"]) if cuda else 0,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                         if cuda else 0)}
    breakdown = None
    if trace:
        # what a per-layer reader reads: the driver's record and the trace
        run = SimpleNamespace(record=c.record(), trace=dtrace, busy_s=None,
                              window_s=None)
        if dtrace is not None:
            run.busy_s, run.window_s, breakdown = dtrace.summary(spans)
            device_info.update(busy_s=run.busy_s, window_s=run.window_s)
        metrics = {}
        for m in layer:
            v = load_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    if cuda:
        device_info["power_limit"] = power_limit()

    c.free()
    if cuda:
        torch.cuda.empty_cache()
    checks = c.check()
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(c.attempted), "failed": int(c.failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv, t0):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=t0)
    except RunError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return err.code
    except Exception:  # noqa: BLE001 — the run ends without a result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print("benchmark: modules that no run may load were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for n, chk in result["checks"].items():
        ok = "ok" if chk["value"] <= chk["limit"] else "FAIL"
        print(f"check {n} = {chk['value']!r} limit {chk['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
