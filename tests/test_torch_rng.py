"""The port's random numbers against the JAX package.

Keys, fold-ins and random bits are jax's threefry2x32, so they must agree
bit for bit.  Normals go through XLA's erf_inv polynomial, which the port
evaluates with the operation sequence XLA's CPU backend emits; the stated
bound is 2 ulp (a handful of values in a million round differently).  The
χ² fields apply the reference's float32 transforms to those normals and
are held to 4 ulp.  The CUDA sampler's plain version is held to the TPU
kernel's own arithmetic through Pallas interpret mode, whose PRNG stub
returns zero bits: the port's cos lanes equal it, its sin lanes equal the
same arithmetic with sin.

Reference values come from a child process (this file run as a script),
which applies the JAX-version shim the reference needs to import its ops
(``ensure_optimization_barrier_batch_rule`` made a no-op); the shim never
touches the pytest worker.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from psrsigsim_torch.ops import rng_hw, stats
from psrsigsim_torch.utils import rng

torch.set_num_threads(2)

SEEDS = (0, 3, 7, 123456, 2**31 - 1, -1)
FOLD_DATA = (0, 1, 5, 12345, 2**31, 2**32 - 1)
N_NORMAL = 200_000
CHAN = np.arange(8, 20)
FIELD_CASES = [(df, t0, length) for df in (1.0, 437.6, 12000.0)
               for t0, length in ((0, 5000), (4096, 8192), (1234, 5000))]
HW_CASES = [("normal", 0.0), ("chi2_1", 0.0), ("chi2_wh", 12000.0),
            ("chi2_sel", 12000.0), ("chi2_sel", 1.0)]


def _ulp(a, b):
    """ulp distance between float32 arrays (sign-magnitude aware)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _child(out):
    """Reference values from the JAX package (run in a child process)."""
    import psrsigsim_tpu.utils.compat as compat

    compat.ensure_optimization_barrier_batch_rule = lambda: None
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops import rng_pallas
    from psrsigsim_tpu.ops import stats as rstats
    from psrsigsim_tpu.utils.rng import stage_key

    kd = jax.random.key_data
    res = {}
    res["keys"] = np.stack([np.asarray(kd(jax.random.key(s))) for s in SEEDS])
    k = jax.random.key(42)
    res["fold_in"] = np.stack([np.asarray(kd(jax.random.fold_in(k, np.uint32(d))))
                               for d in FOLD_DATA])
    res["stage"] = np.stack([np.asarray(kd(stage_key(k, st, i)))
                             for st in ("pulse", "noise", "user")
                             for i in range(4)])
    res["bits"] = np.asarray(jax.random.bits(k, (10_000,), jnp.uint32))
    res["normal"] = np.asarray(jax.random.normal(jax.random.key(7), (N_NORMAL,),
                                                 jnp.float32))
    k7 = jax.random.key(7)
    for i, (df, t0, length) in enumerate(FIELD_CASES):
        res[f"field{i}"] = np.asarray(rstats.chan_chi2_field(
            k7, jnp.asarray(CHAN), df, t0, length))
    for i, (mode, df) in enumerate(HW_CASES):
        res[f"hw{i}"] = np.asarray(rng_pallas.hw_chan_field(
            k7, 8, df, 4096, mode=mode, nchan=12, length=5000,
            interpret=True))
    # the exact-gamma branch (a small df; anything under the hatch), jitted
    # with df static as the pipelines draw it
    k0 = jax.random.key(0)
    res["exact_small_df"] = np.asarray(jax.jit(
        lambda k: rstats.chan_chi2_field(k, jnp.arange(2), 10.0, 0, 16))(k0))
    os.environ["PSS_EXACT_CHI2"] = "1"
    res["exact_hatch_1"] = np.asarray(jax.jit(
        lambda k: rstats.chan_chi2_field(k, jnp.arange(2), 1.0, 0, 16))(k0))
    del os.environ["PSS_EXACT_CHI2"]
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_rng") / "ref.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


CPU = torch.device("cpu")


def test_key_matches_jax(ref):
    got = np.stack([rng.key(s, device=CPU).numpy() for s in SEEDS])
    np.testing.assert_array_equal(got, ref["keys"].astype(np.int64))


def test_fold_in_matches_jax(ref):
    k = rng.key(42, device=CPU)
    got = np.stack([rng.fold_in(k, d).numpy() for d in FOLD_DATA])
    np.testing.assert_array_equal(got, ref["fold_in"].astype(np.int64))
    # batched: one fold-in over a tensor of data
    batched = rng.fold_in(k, torch.tensor(FOLD_DATA, dtype=torch.int64))
    np.testing.assert_array_equal(batched.numpy(), ref["fold_in"].astype(np.int64))


def test_stage_key_matches_jax(ref):
    k = rng.key(42, device=CPU)
    idx = torch.arange(4)
    got = np.concatenate([rng.stage_key(k, st, idx).numpy()
                          for st in ("pulse", "noise", "user")])
    np.testing.assert_array_equal(got, ref["stage"].astype(np.int64))


def test_random_bits_match_jax(ref):
    got = rng.random_bits(rng.key(42, device=CPU), 10_000).numpy()
    np.testing.assert_array_equal(got, ref["bits"].astype(np.int64))


def test_as_key_round_trips_uint32_key_data(ref):
    kd = ref["fold_in"].astype(np.uint32)
    np.testing.assert_array_equal(rng.as_key(kd, device=CPU).numpy(),
                                  kd.astype(np.int64))


ROOT = rng.key(42, device=CPU)
KEYS = rng.stage_key(ROOT, "user", torch.arange(5))
EDGE = (0, 2**31, 2**32 - 1)
EDGE_KEYS = torch.tensor([[a, b] for a in EDGE for b in EDGE])
HOST_CASES = {
    "scalar_root_vector_data": lambda: rng.fold_in(ROOT, torch.arange(7)),
    "batch_keys_batch_data": lambda: rng.fold_in(KEYS, torch.arange(5) * 977),
    "broadcast_keys": lambda: rng.fold_in(KEYS[:, None, :], torch.arange(3)),
    "edge_words": lambda: rng.fold_in(EDGE_KEYS, torch.tensor(EDGE * 3)),
    "edge_counters": lambda: torch.stack(rng.threefry2x32(
        EDGE_KEYS[:, 0, None], EDGE_KEYS[:, 1, None], torch.tensor(EDGE),
        torch.tensor(EDGE[::-1]))),
    "random_bits_hi_word": lambda: rng.random_bits(KEYS, 6, start=2**32 - 3),
    "split": lambda: rng.split(KEYS, 3),
    "randint": lambda: rng.randint(KEYS, 1_000_003),
    # n > 1625: two rounds of sorts
    "permutation": lambda: rng.permutation(KEYS[:2], 2000),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_words_equal_torch_words(case, monkeypatch):
    """The uint32 numpy rounds that host operands take give the int64
    tensor path's words, bit for bit, in the same dtype and shape."""
    host = HOST_CASES[case]()
    monkeypatch.setattr(rng, "_threefry_host", rng._threefry_torch)
    want = HOST_CASES[case]()
    assert host.dtype == want.dtype == torch.int64
    assert host.shape == want.shape
    assert torch.equal(host, want)


def test_fold_front_stage_keys_are_the_stage_keys():
    """``_fold_front`` derives the pulse and noise keys in one chain: they
    are ``stage_key(key, "pulse")`` and ``stage_key(key, "noise")``."""
    from psrsigsim_torch.signal.state import SignalMeta
    from psrsigsim_torch.simulate.pipeline import (FoldPipelineConfig,
                                                   _fold_front)

    meta = SignalMeta(sigtype="FilterBankSignal", fcent_mhz=1400.0,
                      bw_mhz=400.0, nchan=4, samprate_mhz=0.2048, fold=True)
    cfg = FoldPipelineConfig(meta=meta, period_s=0.005, nsub=2, nph=16,
                             nfold=100.0, draw_norm=1.0, noise_df=100.0,
                             dt_ms=0.078125, clip_max=200.0)
    for k in (KEYS, ROOT, KEYS.reshape(5, 1, 2)):
        f = _fold_front(k, 10.0, 1.0, np.ones((4, 16), np.float32), cfg,
                        None, None, None, CPU)
        assert torch.equal(f.kp, rng.stage_key(k, "pulse"))
        assert torch.equal(f.kn, rng.stage_key(k, "noise"))


def test_normal_within_2_ulp(ref):
    got = stats.normal(rng.key(7, device=CPU), N_NORMAL).numpy()
    d = _ulp(got, ref["normal"])
    assert d.max() <= 2
    assert (d > 0).mean() <= 1e-4


@pytest.mark.parametrize("case", range(len(FIELD_CASES)))
def test_chan_chi2_field_threefry_within_4_ulp(ref, case, monkeypatch):
    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    df, t0, length = FIELD_CASES[case]
    got = stats.chan_chi2_field(rng.key(7, device=CPU), torch.as_tensor(CHAN),
                                df, t0, length).numpy()
    assert got.shape == ref[f"field{case}"].shape
    assert _ulp(got, ref[f"field{case}"]).max() <= 4


def _sin_lane_zero_bits(mode, df):
    """The sin branch of Box-Muller on zero bits, in float32 with the TPU
    kernel's arithmetic (rng_pallas.py:143-161) and sin for cos."""
    f = np.float32
    u1 = f((f(0) + f(1)) * f(2.0**-24))
    z = np.sqrt(f(-2) * np.log(u1)) * np.sin(f(rng_hw._TWO_PI) * f(0))
    if mode == "normal":
        return z
    if mode == "chi2_1" or (mode == "chi2_sel" and df == 1.0):
        return z * z
    k = f(df)
    c = f(2) / (f(9) * k)
    t = (f(1) - c) + z * np.sqrt(c)
    return max(k * (t * (t * t)), f(0))


@pytest.mark.parametrize("case", range(len(HW_CASES)))
def test_plain_transform_equals_tpu_kernel_arithmetic(ref, case):
    """Zero bits through the plain version: the cos lanes (0 and 2 of each
    Philox call, columns 0 and 2 mod 4) equal the TPU kernel run in
    interpret mode (whose PRNG stub returns zeros), mode by mode; the sin
    lanes equal the same arithmetic with sin."""
    mode, df = HW_CASES[case]

    def zero_bits(h0, h1, counter):
        shape = torch.broadcast_shapes(h0.shape, h1.shape, counter.shape)
        z = torch.zeros(shape, dtype=torch.int64)
        return z, z, z, z

    seeds = torch.tensor([[0, 7]], dtype=torch.int32)
    pos = torch.tensor([[8 // rng_hw.CHAN_GROUP, 4096 // rng_hw.RNG_BLOCK]],
                       dtype=torch.int32)
    got = rng_hw.rng_field_plain(seeds, torch.tensor([df]), pos, mode, 12,
                                 5000, bits=zero_bits)[0].numpy()
    cos_lane = np.arange(5000) % 2 == 0
    np.testing.assert_array_equal(got[:, cos_lane], ref[f"hw{case}"][:, cos_lane])
    np.testing.assert_array_equal(got[:, ~cos_lane],
                                  np.full((12, 2500), _sin_lane_zero_bits(mode, df),
                                          np.float32))


def test_philox_known_answer():
    """Random123's Philox4x32-10 known-answer vector (key 0, counter 0):
    all four output words."""
    z = torch.tensor(0, dtype=torch.int64)
    words = rng_hw.philox_bits(z, z, z)
    assert tuple(int(w) for w in words) == (0x6627E8D5, 0xE169C58D,
                                            0xBC57AC4C, 0x9B00DBD8)


def test_hw_plain_split_invariance():
    """Any split of channels (at multiples of 8) and time (at multiples of
    4096) draws the same samples."""
    k = rng.key(11, device=CPU)
    kw = dict(mode="chi2_wh")
    full = rng_hw.hw_chan_field(k, 0, 12000.0, 0, nchan=24, length=3 * 4096 + 100, **kw)
    parts = [[rng_hw.hw_chan_field(k, c0, 12000.0, t0, nchan=nc, length=nt, **kw)
              for t0, nt in ((0, 4096), (4096, 2 * 4096 + 100))]
             for c0, nc in ((0, 8), (8, 16))]
    joined = torch.cat([torch.cat(row, dim=1) for row in parts], dim=0)
    assert torch.equal(full, joined)
    # an unaligned span through the sampler dispatch slices the same stream
    span = stats._hw_field_span(k, torch.arange(8, 24), 12000.0, 1000,
                                "chi2_wh", 5000)
    assert torch.equal(span, full[8:, 1000:6000])


def test_hw_plain_batch_matches_single_keys():
    keys = rng.fold_in(rng.key(5, device=CPU), torch.arange(3))
    dfs = torch.tensor([1.0, 437.6, 12000.0])
    batch = rng_hw.hw_chan_field(keys, 8, dfs, 0, mode="chi2_sel", nchan=5,
                                 length=700)
    for i in range(3):
        one = rng_hw.hw_chan_field(keys[i], 8, dfs[i], 0, mode="chi2_sel",
                                   nchan=5, length=700)
        assert torch.equal(batch[i], one)
    # distinct keys draw distinct streams
    assert not torch.equal(batch[1], batch[2])


@pytest.mark.parametrize("mode,df,mean,var", [
    ("normal", 0.0, 0.0, 1.0),
    ("chi2_1", 0.0, 1.0, 2.0),
    ("chi2_wh", 12000.0, 12000.0, 24000.0),
])
def test_hw_plain_moments(mode, df, mean, var):
    """Sample mean and variance within 5 sigma of the distribution's."""
    x = rng_hw.hw_chan_field(rng.key(3, device=CPU), 0, df, 0, mode=mode,
                             nchan=16, length=2 * 4096).double()
    n = x.numel()
    m4 = {"normal": 3.0, "chi2_1": 60.0, "chi2_wh": 3.0 * var**2}[mode]
    assert abs(x.mean().item() - mean) <= 5 * (var / n) ** 0.5
    assert abs(x.var().item() - var) <= 5 * ((m4 - var**2) / n) ** 0.5


def test_sampler_backend_selection(monkeypatch):
    monkeypatch.delenv("PSS_SAMPLER", raising=False)
    monkeypatch.delenv("PSS_EXACT_CHI2", raising=False)
    assert stats.sampler_backend("cpu") == "threefry"
    assert stats.sampler_backend("cuda") == "hw"
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    assert stats.sampler_backend("cpu") == "hw"
    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    assert stats.sampler_backend("cuda") == "threefry"
    monkeypatch.setenv("PSS_SAMPLER", "bogus")
    with pytest.raises(ValueError):
        stats.sampler_backend("cpu")


def test_hw_sampler_on_cpu_routes_through_plain_version(monkeypatch):
    monkeypatch.setenv("PSS_SAMPLER", "hw")
    k = rng.key(9, device=CPU)
    got = stats.chan_chi2_field(k, torch.arange(16), 12000.0, 0, 4096)
    want = rng_hw.hw_chan_field(k, 0, 12000.0, 0, mode="chi2_wh", nchan=16,
                                length=4096)
    assert torch.equal(got, want)


def test_exact_gamma_branch_is_not_ported(ref, monkeypatch):
    """The two calls this test once held to ``NotImplementedError`` (named
    for it): a small static df, and df = 1 under ``PSS_EXACT_CHI2=1``, now
    draw the exact gamma branch, bit for bit the JAX package's."""
    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    k = rng.key(0, device=CPU)
    got = stats.chan_chi2_field(k, torch.arange(2), 10.0, 0, 16).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref["exact_small_df"].view(np.int32))
    monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    got = stats.chan_chi2_field(k, torch.arange(2), 1.0, 0, 16).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref["exact_hatch_1"].view(np.int32))


def test_rng_field_checks_arguments():
    seeds = torch.zeros((2, 2), dtype=torch.int32)
    pos = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        rng_hw.rng_field(seeds, torch.zeros(2), pos, "gamma", 8, 16)
    with pytest.raises(ValueError):
        rng_hw.rng_field(seeds.long(), torch.zeros(2), pos, "normal", 8, 16)
    with pytest.raises(ValueError):
        rng_hw.rng_field(seeds, torch.zeros(3), pos, "normal", 8, 16)
    with pytest.raises(ValueError):
        rng_hw.rng_field(seeds, torch.zeros(2), pos, "normal", 0, 16)


def test_rng_field_counts_only_kernel_launches():
    before = rng_hw.rng_field.launches
    seeds = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1, 2), dtype=torch.int32)
    rng_hw.rng_field(seeds, torch.zeros(1), pos, "normal", 8, 16)
    assert rng_hw.rng_field.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    dev = torch.device("cuda")
    keys = rng.fold_in(rng.key(1, device=dev), torch.arange(3, device=dev))
    seeds = rng_hw.seed_words(keys)
    pos = torch.tensor([[1, 2]] * 3, dtype=torch.int32, device=dev)
    for mode, df in HW_CASES:
        dfs = torch.full((3,), df, device=dev)
        # 5000: float4 stores; 4999: a ragged last quad and scalar stores
        for length in (5000, 4999):
            want = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 12, length)
            got = rng_hw.rng_field(seeds, dfs, pos, mode, 12, length)
            torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=1e-6)


if __name__ == "__main__":
    _child(sys.argv[1])


@pytest.mark.cuda
def test_box_muller_sequences_match_libm_on_card():
    """The header's specialised Box-Muller radius, sine and cosine equal the
    CUDA math library's logf/sqrtf/sincosf on all 2^24 words."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    assert rng_hw.box_muller_selftest("cuda") == {"radius": 0, "sin": 0,
                                                  "cos": 0}


def test_box_muller_selftest_needs_a_card():
    with pytest.raises(ValueError):
        rng_hw.box_muller_selftest("cpu")
