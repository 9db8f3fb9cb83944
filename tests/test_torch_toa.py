"""The port's FFTFIT, histogram and prior draws against the JAX package's,
on the CPU.

* FFTFIT (``ops/toa.py``) on the same float32 profiles — noisy shifted
  Gaussians at 64, 512 and 935 bins, all harmonics and ``nharm=16``:
  shifts within 2e-6 turns (mod 1), fitted amplitudes within rtol 1e-4,
  sigmas within rtol 1e-4 plus sixteen float32 roundings of the power
  sums they are the difference of, relative to it (``sigma_n^2`` is
  ``sum|P|^2 - b^2 sum|T|^2``: where the signal dominates a capped
  harmonic range the difference is thousands of times smaller than the
  sums, and the two packages' summation orders round them differently;
  measured up to 9.5 roundings).  The
  first maximum on the upsampled grid may sit on a neighbouring point when
  two are within rounding of each other; Newton converges to the same
  optimum either way.
* ``fftfit_combine``: combined shifts within 1e-9 turns, sigmas within
  rtol 1e-6 (the same float32 formula, summed in another order).
* ``fixed_histogram`` on the same inputs (edges, out-of-range values,
  infinities, NaN, weights): equal counts.
* ``randint``, ``choice`` (with and without ``p``) and every prior drawn
  through ``sample_priors`` in a jitted vmap, as the JAX study samples
  them: bit for bit, except ``LogUniform`` whose ``exp`` is torch's
  (within 2 ulp).

Reference values come from a child process (this file run as a script)
that applies the JAX-version shims (R1: the optimization-barrier batch
rule; R2: ``shard_map``'s ``check_rep``); the shims never touch the
pytest worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FFTFIT_CASES = ((512, None, 50.0), (512, 16, 50.0), (935, None, 30.0),
                (64, None, 20.0))
PRIORS = {
    "dm": {"dist": "normal", "mean": 12.0, "sigma": 2.5},
    "tau_d_ms": {"dist": "loguniform", "lo": 1e-4, "hi": 1e-2},
    "width": {"dist": "grid", "values": [0.02, 0.05, 0.08]},
    "amp": {"dist": "choice", "values": [0.5, 1.0, 2.0]},
    "noise_scale": {"dist": "choice", "values": [0.5, 1.0, 1.5, 2.0],
                    "probs": [0.1, 0.2, 0.3, 0.4]},
    "null_frac": {"dist": "uniform", "lo": 0.0, "hi": 0.5},
}
N_KEYS = 1000


def shims():
    """The JAX-version shims the reference needs on jax 0.9 (R1, R2)."""
    import jax

    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    shard_map = jax.shard_map

    def _shard_map(*args, check_rep=None, **kw):
        if check_rep is not None:
            kw["check_vma"] = check_rep
        return shard_map(*args, **kw)

    jax.shard_map = _shard_map


def child_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
              "PSS_INTEGRITY"):
        env.pop(k, None)
    return env


def _profiles(n, snr, rows=200):
    rng = np.random.default_rng(n + int(snr))
    ph = (np.arange(n) + 0.5) / n
    tmpl = np.exp(-0.5 * ((ph - 0.5) / 0.03) ** 2)
    shifts = rng.uniform(-0.5, 0.5, rows)
    prof = np.stack([np.interp((ph - s) % 1.0, ph, tmpl, period=1.0)
                     for s in shifts]) * snr + rng.normal(size=(rows, n))
    return prof.astype(np.float32), tmpl.astype(np.float32)


def _hist_inputs():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 6.0, 3000).astype(np.float32)
    # every bin edge exactly, and the values the clamping must place
    x[:33] = np.linspace(0.0, 4.0, 33, dtype=np.float32)
    x[33:38] = [np.inf, -np.inf, np.nan, 1e30, -1e30]
    w = (rng.random(3000) < 0.8).astype(np.int32)
    return x, w


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.mc.priors import parse_prior, sample_priors
    from psrsigsim_tpu.ops.stats import fixed_histogram
    from psrsigsim_tpu.ops.toa import fftfit_batch, fftfit_combine

    res = {}
    for i, (n, nharm, snr) in enumerate(FFTFIT_CASES):
        prof, tmpl = _profiles(n, snr)
        for name, a in zip("seb", fftfit_batch(prof, tmpl, nharm=nharm)):
            res[f"fftfit{i}_{name}"] = np.asarray(a)
    rng = np.random.default_rng(3)
    sh = (rng.normal(size=(50, 16)) * 1e-3).astype(np.float32)
    sg = rng.uniform(1e-4, 1e-2, (50, 16)).astype(np.float32)
    res["comb"], res["comb_sigma"] = (np.asarray(a)
                                      for a in fftfit_combine(sh, sg))
    x, w = _hist_inputs()
    res["hist"] = np.asarray(fixed_histogram(x, 0.0, 4.0, 32))
    res["hist_w"] = np.asarray(fixed_histogram(x, -0.5, 5.5, 7, weights=w))
    keys = jax.vmap(jax.random.key)(jnp.arange(N_KEYS))
    res["keys"] = np.asarray(jax.random.key_data(keys))
    for n in (1, 3, 7, 100):
        res[f"randint{n}"] = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, n))(keys))
    p = jnp.asarray([0.1, 0.15, 0.3, 0.05, 0.4], jnp.float32)
    res["choice_p"] = np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, 5, p=p))(keys))
    priors = {k: parse_prior(v) for k, v in PRIORS.items()}
    names = tuple(PRIORS)
    drawn = jax.jit(jax.vmap(lambda k, i: jnp.stack(
        [sample_priors(priors, names, k, i)[n] for n in names])))(
            keys, jnp.arange(N_KEYS, dtype=jnp.int32))
    res["priors"] = np.asarray(drawn)
    np.savez(os.path.join(out, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_toa")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


def _keys(ref):
    from psrsigsim_torch.utils import as_key

    return as_key(ref["keys"], "cpu")


@pytest.mark.parametrize("case", range(len(FFTFIT_CASES)))
def test_fftfit_matches_reference(ref, case):
    from psrsigsim_torch.ops.toa import fftfit_batch

    n, nharm, snr = FFTFIT_CASES[case]
    prof, tmpl = _profiles(n, snr)
    s, e, b = (a.numpy() for a in fftfit_batch(
        torch.from_numpy(prof), torch.from_numpy(tmpl), nharm=nharm))
    ws, we, wb = (ref[f"fftfit{case}_{c}"] for c in "seb")
    assert s.dtype == np.float32 and s.shape == (200,)
    dshift = np.abs((s - ws + 0.5) % 1.0 - 0.5)
    assert dshift.max() <= 2e-6
    np.testing.assert_allclose(b, wb, rtol=1e-4)
    # sigma_n^2 = sum|P|^2 - b^2 sum|T|^2 over the harmonics used: its
    # relative rounding is that of the sums times their ratio to it
    half = n // 2 if nharm is None else nharm
    spec = np.fft.rfft(prof.astype(np.float64))[:, 1:half + 1]
    total = (np.abs(spec) ** 2).sum(axis=1)
    tspec = np.fft.rfft(tmpl.astype(np.float64))[1:half + 1]
    resid = total - wb.astype(np.float64) ** 2 * (np.abs(tspec) ** 2).sum()
    cond = total / np.maximum(resid, 1e-30)
    rtol = 1e-4 + 16 * 2.0**-24 * cond
    assert (np.abs(e / we - 1) <= rtol).all()


def test_fftfit_combine_matches_reference(ref):
    from psrsigsim_torch.ops.toa import fftfit_combine

    rng = np.random.default_rng(3)
    sh = (rng.normal(size=(50, 16)) * 1e-3).astype(np.float32)
    sg = rng.uniform(1e-4, 1e-2, (50, 16)).astype(np.float32)
    c, cs = (a.numpy() for a in fftfit_combine(torch.from_numpy(sh),
                                               torch.from_numpy(sg)))
    np.testing.assert_allclose(c, ref["comb"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(cs, ref["comb_sigma"], rtol=1e-6)


def test_fftfit_row_does_not_depend_on_the_batch():
    """A profile's measurement is the same alone and among others (the
    study's chunk-size invariance rests on it)."""
    from psrsigsim_torch.ops.toa import fftfit_shift

    prof, tmpl = _profiles(512, 50.0, rows=64)
    full = fftfit_shift(torch.from_numpy(prof), torch.from_numpy(tmpl))
    for lo, hi in ((0, 1), (5, 12), (0, 63)):
        part = fftfit_shift(torch.from_numpy(prof[lo:hi]),
                            torch.from_numpy(tmpl))
        for a, b in zip(part, full):
            assert torch.equal(a, b[lo:hi])


def test_tree_sum():
    from psrsigsim_torch.ops.toa import tree_sum

    x = torch.arange(1.0, 12.0).reshape(1, 11).repeat(3, 1)
    assert torch.equal(tree_sum(x), torch.full((3,), 66.0))
    assert torch.equal(tree_sum(x.T, dim=0), torch.full((3,), 66.0))
    assert torch.equal(tree_sum(torch.ones(4, 1)), torch.ones(4))


def test_fixed_histogram_matches_reference(ref):
    from psrsigsim_torch.ops.stats import fixed_histogram

    x, w = _hist_inputs()
    h = fixed_histogram(torch.from_numpy(x), 0.0, 4.0, 32)
    assert h.dtype == torch.int32
    np.testing.assert_array_equal(h.numpy(), ref["hist"])
    hw = fixed_histogram(torch.from_numpy(x), -0.5, 5.5, 7,
                         weights=torch.from_numpy(w))
    np.testing.assert_array_equal(hw.numpy(), ref["hist_w"])
    # batched: one histogram per leading row, each its own range
    both = fixed_histogram(torch.from_numpy(np.stack([x, x])),
                           torch.tensor([0.0, -0.5]), torch.tensor([4.0, 5.5]),
                           32)
    np.testing.assert_array_equal(both[0].numpy(), ref["hist"])
    with pytest.raises(ValueError):
        fixed_histogram(torch.from_numpy(x), 0.0, 1.0, 0)


@pytest.mark.parametrize("n", [1, 3, 7, 100])
def test_randint_matches_jax(ref, n):
    from psrsigsim_torch.utils import randint

    np.testing.assert_array_equal(randint(_keys(ref), n).numpy(),
                                  ref[f"randint{n}"])


def test_choice_matches_jax(ref):
    from psrsigsim_torch.ops.stats import choice

    keys = _keys(ref)
    got = choice(keys, 5, p=np.asarray([0.1, 0.15, 0.3, 0.05, 0.4],
                                       np.float32))
    np.testing.assert_array_equal(got.numpy(), ref["choice_p"])
    np.testing.assert_array_equal(choice(keys, 7).numpy(), ref["randint7"])


def test_priors_match_jax(ref):
    from psrsigsim_torch.mc.priors import parse_prior, sample_priors

    priors = {k: parse_prior(v) for k, v in PRIORS.items()}
    names = tuple(PRIORS)
    drawn = sample_priors(priors, names, _keys(ref), torch.arange(N_KEYS))
    got = torch.stack([drawn[n] for n in names], dim=1).numpy()
    want = ref["priors"]
    assert got.dtype == np.float32 and got.shape == want.shape
    for j, name in enumerate(names):
        if name == "tau_d_ms":   # LogUniform: torch's exp
            ulps = np.abs(got[:, j].view(np.int32).astype(np.int64)
                          - want[:, j].view(np.int32))
            assert ulps.max() <= 2, name
        else:
            np.testing.assert_array_equal(got[:, j], want[:, j], err_msg=name)


if __name__ == "__main__":
    _child(sys.argv[1])
