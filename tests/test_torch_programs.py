"""The port's program registry (psrsigsim_torch/runtime/programs.py) and
the serving layer's registry over it, against the JAX package's, on the
CPU.

The reference's registry is driven through the same scripted sequence of
builds, hits and evictions in a child process (this file run as a script,
with the R1/R2 shims of tests/test_torch_toa.py): build and hit counts and
the snapshot (all but the build seconds) are equal, and so are the first
four slots of ``trace_env_key`` under the same environment switches.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_toa import child_env, shims  # noqa: E402

ENVS = [{}, {"PSS_SAMPLER": "threefry"}, {"PSS_SAMPLER": "hw"},
        {"PSS_EXACT_CHI2": "1"}, {"PSS_EXACT_SHIFT": "1"},
        {"PSS_DONATE": "1"}, {"PSS_DONATE": "0"}]


def script(registry_cls):
    """A fixed sequence of registry operations; its observable results."""
    reg = registry_cls("t", max_programs=3)
    for k in [("fold", "g1"), ("fold", "g2"), ("quant", "g1"),
              ("fold", "g1"), ("quant", "g2"), ("fold", "g3"),
              ("fold", "g1"), ("quant", "g1")]:
        reg.get_or_build(k, object)
    snap = reg.snapshot()
    del snap["build_seconds"]
    return {"snapshot": snap,
            "builds": sorted([list(k), c] for k, c in
                             reg.build_counts().items()),
            "hits": sorted([list(k), c] for k, c in
                           reg.hit_counts().items())}


def env_keys(trace_env_key):
    out = []
    for env in ENVS:
        saved = {k: os.environ.pop(k, None) for k in
                 ("PSS_SAMPLER", "PSS_EXACT_CHI2", "PSS_EXACT_SHIFT",
                  "PSS_DONATE")}
        os.environ.update(env)
        try:
            out.append(list(trace_env_key()))
        finally:
            for k in env:
                os.environ.pop(k)
            os.environ.update({k: v for k, v in saved.items()
                               if v is not None})
    return out


def _child(out):
    shims()
    from psrsigsim_tpu.runtime.programs import (ProgramRegistry,
                                                trace_env_key)

    with open(os.path.join(out, "ref.json"), "w") as f:
        json.dump({"script": script(ProgramRegistry),
                   "env": env_keys(trace_env_key)}, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_programs")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=child_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ref.json") as f:
        return json.load(f)


class TestProgramRegistry:
    def test_scripted_counts_and_snapshot_match_reference(self, ref):
        from psrsigsim_torch.runtime.programs import ProgramRegistry

        assert json.loads(json.dumps(script(ProgramRegistry))) \
            == ref["script"]

    def test_trace_env_key_matches_reference(self, ref, monkeypatch):
        """Every slot equals the reference's on the CPU (where donation is
        off under ``auto``), the pod topology's included (``("solo",)``
        outside a pod; the pod's own keys: tests/test_torch_pod.py)."""
        from psrsigsim_torch.runtime.programs import trace_env_key

        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        got = env_keys(trace_env_key)
        assert json.loads(json.dumps(got)) == ref["env"]
        assert all(len(k) == 5 and k[4] == ("solo",) for k in got)

    def test_build_once_then_hit(self):
        from psrsigsim_torch.runtime import ProgramRegistry

        reg = ProgramRegistry("t")
        calls = []

        def build():
            calls.append(1)
            return object()

        a = reg.get_or_build(("fam", 1), build)
        b = reg.get_or_build(("fam", 1), build)
        assert a is b and calls == [1]
        assert reg.peek(("fam", 1)) is a and reg.peek(("fam", 2)) is None
        assert reg.build_counts() == {("fam", 1): 1}
        assert reg.hit_counts() == {("fam", 1): 1}
        reg.assert_single_build()
        reg.assert_single_build("fam")

    def test_concurrent_build_keeps_one_artifact(self):
        from psrsigsim_torch.runtime import ProgramRegistry

        reg = ProgramRegistry("t")
        gate = threading.Barrier(4)
        got = []

        def worker():
            gate.wait()
            got.append(reg.get_or_build(("k",), object))

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len({id(x) for x in got}) == 1
        assert reg.build_counts()[("k",)] >= 1

    def test_timers_receive_build_telemetry(self):
        from psrsigsim_torch.runtime import ProgramRegistry, StageTimers

        reg = ProgramRegistry("t")
        timers = StageTimers()
        reg.attach_timers(timers)
        reg.get_or_build(("a", 1), object)
        reg.get_or_build(("a", 2), object)
        reg.get_or_build(("a", 1), object)  # hit: no telemetry
        snap = timers.snapshot()
        assert snap["compile_calls"] == 2
        assert snap["program_builds_count"] == 2

    def test_lru_cap_and_duplicate_guard(self):
        from psrsigsim_torch.runtime import ProgramRegistry

        reg = ProgramRegistry("t", max_programs=2)
        a = reg.get_or_build(("f", 1), object)
        reg.get_or_build(("f", 2), object)
        reg.get_or_build(("f", 3), object)  # evicts ("f", 1)
        assert reg.snapshot()["evictions"] == 1
        assert reg.get_or_build(("f", 1), object) is not a  # rebuilt
        with pytest.raises(AssertionError, match="more than once"):
            reg.assert_single_build()
        reg.assert_single_build("g")  # another family passes

    def test_compilation_cache_is_accepted_and_off(self, tmp_path):
        from psrsigsim_torch.runtime import (ProgramRegistry,
                                             enable_compilation_cache,
                                             global_registry)

        assert enable_compilation_cache(str(tmp_path)) is False
        reg = ProgramRegistry("t", compile_cache_dir=str(tmp_path))
        assert reg.cache_enabled is False
        assert global_registry() is global_registry()
        assert global_registry().name == "global"

    def test_donation_switch(self, monkeypatch):
        from psrsigsim_torch.runtime.programs import donation_enabled

        monkeypatch.delenv("PSS_DONATE", raising=False)
        assert donation_enabled("cpu") is False
        assert donation_enabled("cuda") is True
        monkeypatch.setenv("PSS_DONATE", "1")
        assert donation_enabled("cpu") is True
        monkeypatch.setenv("PSS_DONATE", "maybe")
        with pytest.raises(ValueError):
            donation_enabled("cpu")

    def test_runtime_imports_no_torch(self):
        code = ("import sys; import psrsigsim_torch.runtime; "
                "sys.exit('torch' in sys.modules)")
        proc = subprocess.run([sys.executable, "-c", code],
                              env=dict(os.environ, PYTHONPATH=ROOT),
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]


class TestServeRegistry:
    def test_widths_and_bucket_width(self):
        from psrsigsim_torch.serve import DEFAULT_WIDTHS, ProgramRegistry

        assert DEFAULT_WIDTHS == (1, 8, 32)
        reg = ProgramRegistry((32, 1, 8, 8), device="cpu")
        assert reg.widths == (1, 8, 32)
        assert [reg.bucket_width(n) for n in (1, 2, 8, 9, 32, 40)] \
            == [1, 8, 8, 32, 32, 32]
        with pytest.raises(ValueError):
            ProgramRegistry((0, 4), device="cpu")

    def test_register_builds_every_width_once(self, monkeypatch):
        from psrsigsim_torch.serve import (ProgramRegistry, build_geometry,
                                           canonicalize, geometry_hash)
        from test_torch_serve import SPEC

        monkeypatch.setenv("PSS_SAMPLER", "hw")
        c = canonicalize(SPEC)
        gh = geometry_hash(c)
        reg = ProgramRegistry((1, 4), device="cpu")
        reg.register(gh, *build_geometry(c))
        reg.register(gh, *build_geometry(c))
        assert reg.compile_counts() == {(gh, 1): 1, (gh, 4): 1}
        reg.assert_single_compile()
        assert reg.device_calls == 0      # the warm runs are not calls
        import numpy as np

        from psrsigsim_torch.serve.programs import example_keys

        z = np.zeros(4, np.float32)
        out = reg.execute(gh, 4, example_keys(4), z + 10, z + 1, z)
        assert isinstance(out, np.ndarray) and out.shape == (4, 4, 1024)
        st = reg.stats()
        assert st["device_calls"] == 1
        assert st["bucket_calls"] == {f"{gh[:12]}/w4": 1}
        assert st["registry"]["builds_by_family"] == {"serve_bucket": 2}


if __name__ == "__main__":
    _child(sys.argv[1])
