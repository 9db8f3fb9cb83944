"""Public names of the JAX package's modules that the port carries too,
each held to the reference on the CPU: the device PCHIP
(``ops.pchip_slopes``/``pchip_fit``/``pchip_eval``,
``DataPortrait.coeffs_device``), the tensor off-pulse window
(``ops.offpulse_window_indices``/``offpulse_window_jax``),
``signal.empty_state`` and ``SignalState.add_delay``,
``simulate.fold_pipeline_batch``, ``data.list_data``, the scenario draws
re-exported from ``ops`` (``scint_gain``, ``rfi_levels``,
``pulse_energies``), ``utils.ConsoleProgress`` (and ``psrsigsim_torch.
utils``), the scrubs ``runtime.scrub_mc_dir``/``scrub_dataset_dir``, and
every name of the reference's ``parallel`` package.

Reference values come from a child process (this file run as a script,
with the R1/R2 shims of tests/test_torch_toa.py).  Tolerances: the PCHIP
slopes and values within 4 float32 ulps of their magnitude (the same
float32 formula; XLA may contract a multiply-add); the fold within rtol
1e-5 plus 1e-5 of the peak (the FFTs round apart); the scenario draws as
tests/test_torch_scenarios.py holds them (gains, RFI levels and log-normal
energies within 2 ulp, power-law energies within 1, the FRB energies and
the RFI mask exact: the port writes XLA's fused arithmetic out in torch,
P13); everything else bit for bit.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_toa import child_env, shims  # noqa: E402

PCHIP_N = (16, 2)
SCINT = dict(nsub=6, dnu_d_mhz=30.0, dt_d_s=0.7, mod_index=0.8,
             fcent_mhz=1400.0, sublen_s=0.5, f_lo_mhz=1200.0)
RFI = dict(nsub=7, imp_prob=0.4, imp_snr=5.0, nb_prob=0.3, nb_snr=3.0)
SP = {"lognormal": 0.7, "powerlaw": 2.2, "frb": 12.0}


def pchip_inputs(n):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    x[0], x[-1] = 0.0, 1.0
    y = rng.normal(size=(3, n)).astype(np.float32)
    y[1] = np.abs(y[1])            # a monotone-ish, non-negative channel
    y[2, n // 2:] = y[2, n // 2]   # a flat run: zero secant slopes
    xq = np.linspace(-0.1, 1.1, 97, dtype=np.float32)
    return x, y, xq


def portrait():
    ph = (np.arange(64) + 0.5) / 64
    return np.stack([np.exp(-0.5 * ((ph - 0.3 - 0.02 * c) / 0.04) ** 2)
                     for c in range(3)])


def window_profile():
    rng = np.random.default_rng(2)
    p = np.exp(-0.5 * ((np.arange(100) - 40) / 6.0) ** 2) \
        + 0.01 * rng.random(100)
    return p.astype(np.float32)


def fake_clock(module):
    """Replace ``module.time.time`` by a clock that advances 0.25 s a call
    (the progress line prints elapsed seconds)."""
    t = [100.0]

    def now():
        t[0] += 0.25
        return t[0]

    module.time.time = now


SERVE_SPEC = {"nchan": 4, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
              "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
              "period_s": 0.005, "smean_jy": 0.05, "seed": 0, "dm": 10.0}


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu import ops
    from psrsigsim_tpu.data import list_data
    from psrsigsim_tpu.models.pulsar.portraits import DataPortrait
    from psrsigsim_tpu.serve.spec import build_geometry, canonicalize
    from psrsigsim_tpu.signal import SignalMeta, empty_state
    from psrsigsim_tpu.simulate import fold_pipeline_batch
    from psrsigsim_tpu.utils import ConsoleProgress, progress
    from psrsigsim_tpu.utils.rng import stage_key

    res = {}
    for n in PCHIP_N:
        x, y, xq = pchip_inputs(n)
        res[f"slopes{n}"] = np.asarray(ops.pchip_slopes(x, y))
        res[f"eval{n}"] = np.asarray(ops.pchip_eval(ops.pchip_fit(x, y), xq))
    c = DataPortrait(portrait()).coeffs_device()
    for name, a in zip("xyd", c):
        res[f"coeffs_{name}"] = np.asarray(a)
    off, half = ops.offpulse_window_indices(100)
    res["win_offsets"], res["win_half"] = np.asarray(off), np.int64(half)
    res["win"] = np.asarray(ops.offpulse_window_jax(window_profile()))
    meta = SignalMeta("FilterBankSignal", 1400.0, 400.0, 0.2048, 4)
    st = empty_state(meta, 10)
    res["empty"] = np.asarray(st.data)
    d1 = np.float32([1.0, 2.0, 3.0, 4.0])
    res["delay"] = np.asarray(st.add_delay(d1).add_delay(2 * d1).delay_ms)
    cfg, profiles, noise_norm = build_geometry(canonicalize(SERVE_SPEC))
    keys = jax.vmap(jax.random.key)(jnp.arange(3))
    res["batch_keys"] = np.asarray(jax.random.key_data(keys))
    dms = jnp.float32([10.0, 12.0, 14.0])
    norms = jnp.full(3, noise_norm, jnp.float32)
    res["batch"] = np.asarray(fold_pipeline_batch(cfg)(
        keys, dms, norms, jnp.asarray(profiles, jnp.float32)))
    res["list_data"] = np.array(list_data())
    root = jax.random.key(7)
    res["scen_key"] = np.asarray(jax.random.key_data(root))
    freqs = jnp.asarray(np.linspace(1200, 1600, 32, endpoint=False),
                        jnp.float32)
    s = dict(SCINT)
    f_lo = s.pop("f_lo_mhz")
    # as the pipelines run it: vmapped over observations with their own
    # parameters, the channel frequencies constants of the program
    res["scint"] = np.asarray(jax.jit(jax.vmap(
        lambda k, dnu, dt, m: ops.scint_gain(
            k, freqs, s["nsub"], dnu, dt, m, s["fcent_mhz"], s["sublen_s"],
            f_lo_mhz=f_lo)))(jax.vmap(lambda i: stage_key(
                jax.random.fold_in(root, i), "scint"))(jnp.arange(3)),
            *(jnp.float32([v, 1.5 * v, 0.5 * v]) for v in (
                s["dnu_d_mhz"], s["dt_d_s"], s["mod_index"]))))
    lv, mask = jax.jit(lambda k, ip, isn, nbp, nbs: ops.rfi_levels(
        k, jnp.arange(32), RFI["nsub"], ip, isn, nbp, nbs))(
            stage_key(root, "rfi"), RFI["imp_prob"], RFI["imp_snr"],
            RFI["nb_prob"], RFI["nb_snr"])
    res["rfi_levels"], res["rfi_mask"] = np.asarray(lv), np.asarray(mask)
    for mode, p in SP.items():
        res[f"sp_{mode}"] = np.asarray(jax.jit(
            lambda k, q, mode=mode: ops.pulse_energies(k, 9, mode, q))(
                stage_key(root, "transient"), p))
    fake_clock(progress)
    buf = io.StringIO()
    bar = ConsoleProgress("sim", stream=buf)
    for done in (0, 2, 5, 5):
        bar(done, 5)
    res["progress"] = np.array(buf.getvalue())
    import psrsigsim_tpu.runtime as rt

    res["runtime_all"] = np.array(rt.__all__)
    import psrsigsim_tpu.parallel as par

    res["parallel_all"] = np.array(par.__all__)
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_public_names")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=child_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


def ulps(got, want):
    """The largest distance in float32 ulps (same-sign values)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32)).max())


def ulps_close(got, want, n=4):
    """Within ``n`` float32 ulps of each value's magnitude (floored at
    1e-3 of the largest)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.abs(want).max() * 1e-3)
    return bool((np.abs(got - want) <= n * 2.0**-23 * scale).all())


@pytest.mark.parametrize("n", PCHIP_N)
def test_pchip_slopes_fit_eval(ref, n):
    from psrsigsim_torch.ops import pchip_eval, pchip_fit, pchip_slopes

    x, y, xq = pchip_inputs(n)
    s = pchip_slopes(x, y, device="cpu")
    assert s.dtype == torch.float32 and s.shape == (3, n)
    assert ulps_close(s, ref[f"slopes{n}"])
    c = pchip_fit(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(c.d, s)
    v = pchip_eval(c, xq)
    assert v.shape == (3, xq.size)
    assert ulps_close(v, ref[f"eval{n}"])


def test_data_portrait_coeffs_device(ref):
    from psrsigsim_torch.models.pulsar.portraits import DataPortrait

    c = DataPortrait(portrait()).coeffs_device(device="cpu")
    for name, a in zip("xyd", c):
        assert a.dtype == torch.float32
        assert a.numpy().tobytes() == ref[f"coeffs_{name}"].tobytes()


def test_offpulse_window_tensor_twin(ref):
    from psrsigsim_torch.ops import (offpulse_window, offpulse_window_indices,
                                     offpulse_window_jax)

    off, half = offpulse_window_indices(100, device="cpu")
    assert half == int(ref["win_half"])
    np.testing.assert_array_equal(off.numpy(), ref["win_offsets"])
    got = offpulse_window_jax(torch.from_numpy(window_profile()))
    np.testing.assert_array_equal(got.numpy(), ref["win"])
    np.testing.assert_array_equal(got.numpy(),
                                  offpulse_window(window_profile()))


def test_offpulse_window_indices_defaults_to_the_card(monkeypatch):
    """Like every entry point, the offsets land on the card unless the
    caller names a device, and raise when there is no card."""
    from psrsigsim_torch.ops import offpulse_window_indices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offpulse_window_indices(100)
    off, half = offpulse_window_indices(100, device="cpu")
    assert off.device.type == "cpu" and half == 6


def test_empty_state_and_add_delay(ref):
    from psrsigsim_torch.signal import SignalMeta, empty_state

    meta = SignalMeta("FilterBankSignal", 1400.0, 400.0, 0.2048, 4)
    st = empty_state(meta, 10, device="cpu")
    assert st.data.dtype == torch.float32 and st.delay_ms is None
    np.testing.assert_array_equal(st.data.numpy(), ref["empty"])
    d1 = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = st.add_delay(d1).add_delay(2 * d1)
    np.testing.assert_array_equal(got.delay_ms.numpy(), ref["delay"])
    assert got.data is st.data


def test_fold_pipeline_batch(ref):
    from psrsigsim_torch.serve.spec import build_geometry, canonicalize
    from psrsigsim_torch.simulate import fold_pipeline_batch

    cfg, profiles, noise_norm = build_geometry(canonicalize(SERVE_SPEC))
    dms = np.float32([10.0, 12.0, 14.0])
    norms = np.full(3, noise_norm, np.float32)
    got = fold_pipeline_batch(cfg, device="cpu")(
        ref["batch_keys"], dms, norms, profiles).numpy()
    want = ref["batch"]
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * peak).all()
    per_obs = fold_pipeline_batch(cfg, shared_profiles=False, device="cpu")(
        ref["batch_keys"], dms, norms, np.stack([profiles] * 3))
    np.testing.assert_array_equal(per_obs.numpy(), got)


def test_list_data(ref):
    from psrsigsim_torch.data import data_path, list_data

    assert list_data() == list(ref["list_data"])
    with pytest.raises(FileNotFoundError, match="available"):
        data_path("nope.npy")


def test_scenario_draws_reexported(ref):
    from psrsigsim_torch import ops
    from psrsigsim_torch.utils import as_key, fold_in, stage_key

    root = as_key(ref["scen_key"], "cpu")
    freqs = np.linspace(1200, 1600, 32, endpoint=False).astype(np.float32)
    s = SCINT
    keys = stage_key(fold_in(root, torch.arange(3)), "scint")
    g = ops.scint_gain(keys, freqs, s["nsub"], *(
        torch.tensor([v, 1.5 * v, 0.5 * v], dtype=torch.float32)
        for v in (s["dnu_d_mhz"], s["dt_d_s"], s["mod_index"])),
        s["fcent_mhz"], s["sublen_s"], s["f_lo_mhz"])
    assert ulps(g, ref["scint"]) <= 2
    lv, mask = ops.rfi_levels(stage_key(root, "rfi"), torch.arange(32),
                              RFI["nsub"], RFI["imp_prob"], RFI["imp_snr"],
                              RFI["nb_prob"], RFI["nb_snr"])
    assert ulps(lv, ref["rfi_levels"]) <= 2
    np.testing.assert_array_equal(mask.numpy(), ref["rfi_mask"])
    for mode, p in SP.items():
        e = ops.pulse_energies(stage_key(root, "transient"), 9, mode, p)
        assert ulps(e, ref[f"sp_{mode}"]) <= {"lognormal": 2, "powerlaw": 1,
                                              "frb": 0}[mode], mode


def test_console_progress(ref, monkeypatch):
    import psrsigsim_torch
    from psrsigsim_torch.utils import ConsoleProgress, progress

    assert psrsigsim_torch.utils.ConsoleProgress is ConsoleProgress
    monkeypatch.setattr(progress, "time", type(sys)("fake_time"))
    fake_clock(progress)
    buf = io.StringIO()
    bar = ConsoleProgress("sim", stream=buf)
    for done in (0, 2, 5, 5):
        bar(done, 5)
    assert buf.getvalue() == str(ref["progress"])


def test_runtime_exports_the_scrubs(ref):
    """The package exports the reference's scrubs (their behaviour is held
    to the reference in tests/test_torch_mc.py and
    tests/test_torch_datasets.py)."""
    import psrsigsim_torch.runtime as rt
    from psrsigsim_torch.runtime import integrity

    for name in ("scrub_mc_dir", "scrub_dataset_dir", "scrub_export_dir"):
        assert name in rt.__all__ and name in list(ref["runtime_all"])
        assert getattr(rt, name) is getattr(integrity, name)



def test_runtime_exports_the_reference_names(ref):
    """Every public name of the reference's ``runtime`` package — the pod
    runtime's among them — imports from the port's (the pods' behaviour:
    tests/test_torch_pod.py, tests/test_torch_pod_groups.py)."""
    import psrsigsim_torch.runtime as rt
    from psrsigsim_torch.runtime import dist

    names = list(ref["runtime_all"])
    assert "init_pod" in names and "PodChannel" in names
    for name in names:
        assert name in rt.__all__, name
        assert getattr(rt, name) is not None, name
    assert rt.init_pod is dist.init_pod and rt.device_get is dist.device_get


def test_parallel_exports_the_reference_names(ref):
    """Every public name of the reference's ``parallel`` package imports
    from the port's (meshes and sequence sharding: tests/test_torch_mesh.py,
    tests/test_torch_seqshard.py, tests/test_torch_seqshard_baseband.py,
    tests/test_torch_obs_seq.py hold their behaviour)."""
    import psrsigsim_torch.parallel as par

    names = list(ref["parallel_all"])
    assert "seq_sharded_search" in names and "make_mesh" in names
    for name in names:
        assert name in par.__all__, name
        assert getattr(par, name) is not None, name
    assert par.OBS_AXIS == "obs" and par.CHAN_AXIS == "chan"
    assert par.SEQ_AXIS == "seq" and par.SEQ_RNG_BLOCK == 4096


if __name__ == "__main__":
    _child(sys.argv[1])
