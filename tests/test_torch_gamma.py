"""The port's exact-gamma sampler and χ² routing against the JAX package,
on the CPU.

The JAX package draws χ² of a static df below 50 (other than 1), and every
χ² under ``PSS_EXACT_CHI2=1``, as ``2·jax.random.gamma(key, df/2)``; the
port draws the same keys with XLA's arithmetic written out
(``ops/stats.py::gamma_plain``, the plain version of the exact-gamma
kernel ``csrc/gamma_field.cu``).  The gamma draws (2^18 of each α, jitted
with α static and with α traced) and the routed χ² draws (``chi2_sample``
eager and jitted, ``blocked_chan_chi2`` and ``chan_chi2_field`` at small df
and under the hatch, an unaligned ``t0``, a per-observation df) are held
bit for bit: every rejection decision and every rounding is XLA's — its
contractions, its ``log``, ``log1p`` and ``erf_inv``, its ``rsqrt`` of a
traced α (the host's ``rsqrtss`` estimate and two Newton steps), and the
boost's power of an α below 1, glibc's ``powf`` (which XLA calls) except
where XLA rewrites a static power 2 or 3 as products
(psrsigsim_torch/DIVERGENCES.md P21).  The α list adds 0.3 and 1/3 to the
production set to reach both power paths.  α's check (α ≤ 0, NaN, or
below 1 with ``cube`` raise before anything is drawn, on every route) and
a host α's constants (a number's or a CPU tensor's, computed on the host:
``gamma_consts``' bits, and on the card the same rows and draws as a card
α) are held too.  The pipelines and the
object-oriented flow are tests/test_torch_gamma_flows.py.  Reference values
come from a child process (this file run as a script) that applies the
JAX-version shims R1 and R2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_toa import child_env, shims  # noqa: E402

ALPHAS = (0.3, 1 / 3, 0.5, 1.0, 2.5, 10.0, 20.0, 24.5, 6000.0)
N_GAMMA = 1 << 18
CHAN = (4, 9)
# (name, df, t0, length, hatch, traced): the blocked and per-channel fields
FIELD_CASES = [("blocked_20_unaligned", 20.0, 1000, 9000, False, False),
               ("chan_3p3", 3.3, 0, 5000, False, False),
               ("hatch_1_aligned", 1.0, 4096, 5000, True, False),
               ("hatch_300_unaligned", 300.0, 77, 5000, True, False),
               ("hatch_per_obs", (1.0, 12.0, 80.0), 100, 4200, True, True)]
# (name, df, shape, hatch, compiled)
SAMPLE_CASES = [("eager_7p5", 7.5, (3, 500), False, False),
                ("jit_20", 20.0, (3, 500), False, True),
                ("hatch_jit_60", 60.0, (2, 700), True, True),
                ("hatch_eager_1", 1.0, (2, 3000), True, False)]


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.ops import stats as J

    res = {}
    k = jax.random.key(7)
    for a in ALPHAS:
        res[f"gamma_static_{a}"] = np.asarray(jax.jit(
            lambda k, a=a: jax.random.gamma(k, a, (N_GAMMA,), jnp.float32))(k))
        res[f"gamma_traced_{a}"] = np.asarray(jax.jit(
            lambda k, al: jax.random.gamma(k, al, (N_GAMMA,), jnp.float32))(
                k, jnp.float32(a)))

    k = jax.random.key(11)
    chan = jnp.arange(*CHAN)
    for name, df, shape, hatch, compiled in SAMPLE_CASES:
        if hatch:
            os.environ["PSS_EXACT_CHI2"] = "1"
        f = (lambda kk, df=df, shape=shape: J.chi2_sample(kk, df, shape))
        res[f"sample_{name}"] = np.asarray(jax.jit(f)(k) if compiled else f(k))
        os.environ.pop("PSS_EXACT_CHI2", None)
    for name, df, t0, length, hatch, traced in FIELD_CASES:
        if hatch:
            os.environ["PSS_EXACT_CHI2"] = "1"
        if traced:
            ks = jax.random.split(k, len(df))
            res[f"field_{name}"] = np.asarray(jax.jit(jax.vmap(
                lambda kk, d, t0=t0, n=length: J.blocked_chan_chi2(
                    kk, chan, d, t0, n)))(ks, jnp.asarray(df, jnp.float32)))
        else:
            fn = (J.blocked_chan_chi2 if name.startswith("blocked")
                  else J.chan_chi2_field)
            res[f"field_{name}"] = np.asarray(jax.jit(
                lambda kk, df=df, t0=t0, n=length, fn=fn: fn(
                    kk, chan, df, t0, n))(k))
        os.environ.pop("PSS_EXACT_CHI2", None)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_gamma") / "ref.npz"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_CHI2", "PSS_EXACT_SHIFT"):
        monkeypatch.delenv(k, raising=False)


def _ulps(got, want):
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _key(seed):
    from psrsigsim_torch.utils import key

    return key(seed, device="cpu")


# -- (a) the sampler ------------------------------------------------------------


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("mode", ["static", "traced"])
def test_gamma_plain_matches_jax(ref, alpha, mode):
    from psrsigsim_torch.ops.stats import gamma_plain

    got = gamma_plain(_key(7)[None], torch.tensor([alpha]), N_GAMMA,
                      traced=mode == "traced")[0].numpy()
    want = ref[f"gamma_{mode}_{alpha}"]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gamma_plain_spans_equal_one_pass():
    from psrsigsim_torch.ops.gamma import gamma_field
    from psrsigsim_torch.ops.stats import gamma_plain
    from psrsigsim_torch.utils import fold_in

    keys = fold_in(_key(1)[None], torch.arange(3))
    alpha = torch.tensor([0.7, 4.0, 55.0])
    whole = gamma_plain(keys, alpha, 3000)
    part = gamma_plain(keys, alpha, 1000, start=1700)
    assert torch.equal(part, whole[:, 1700:2700])
    assert torch.equal(gamma_field(keys, alpha, 3000, scale=2.0), 2.0 * whole)


def test_gamma_field_counts_only_kernel_launches_and_checks():
    from psrsigsim_torch.ops.gamma import gamma_field

    before = gamma_field.launches
    gamma_field(_key(0)[None], torch.tensor([3.0]), 16)
    assert gamma_field.launches == before
    with pytest.raises(ValueError):
        gamma_field(_key(0), torch.tensor([3.0]), 16)
    with pytest.raises(ValueError):
        gamma_field(_key(0)[None], torch.tensor([3.0, 4.0]), 16)
    with pytest.raises(ValueError):
        gamma_field(_key(0)[None], torch.tensor([0.0]), 16)


NAN = float("nan")
# every χ² route that draws the exact gamma; NaN fails the reference's
# ``df < 50`` as well, so it reaches the gamma only under the hatch
CHI2_ROUTES = ("_exact_chi2", "chi2_sample", "chi2_sample_compiled",
               "chi2_noise_compiled", "blocked_chan_chi2")
# (alpha, cube) that gamma_field refuses
BAD_ALPHAS = ((0.0, False), (-1.0, False), (NAN, False), (0.0, True),
              (NAN, True), (0.5, True))
# (how α is given, the keys' device)
ALPHA_KINDS = (("number", "cpu"), ("host", "cpu"), ("number", "cuda"),
               ("host", "cuda"), ("card", "cuda"))


def _bad_alpha_cases():
    cases = [pytest.param(route, None, df, False, id=f"{route}-df{df}")
             for route in CHI2_ROUTES for df in (0.0, -2.0, NAN)]
    for kind, dev in ALPHA_KINDS:
        for alpha, cube in BAD_ALPHAS:
            cases.append(pytest.param(
                "gamma_field", (kind, dev), alpha, cube,
                id=f"gamma_field-{kind}-{dev}-{alpha}-cube{int(cube)}",
                marks=[pytest.mark.cuda] if dev == "cuda" else []))
    return cases


def _draw_route(route, given, value, cube):
    from psrsigsim_torch.ops import stats
    from psrsigsim_torch.ops.gamma import gamma_field

    k = _key(3)
    if route == "gamma_field":
        kind, dev = given
        keys = k[None].expand(4, 2).to(dev)
        alpha = value
        if kind != "number":
            alpha = torch.full((4,), value, device=(
                "cpu" if kind == "host" else dev))
        return gamma_field(keys, alpha, 64, cube=cube)
    if route == "_exact_chi2":
        return stats._exact_chi2(k[None], value, (64,), traced=False)
    if route == "chi2_noise_compiled":
        return stats.chi2_noise_compiled(k, value, torch.zeros(64), 1.5)
    if route == "blocked_chan_chi2":
        return stats.blocked_chan_chi2(k, torch.arange(2), value, 0, 100)
    return getattr(stats, route)(k, value, (64,))


@pytest.mark.parametrize("route,given,value,cube", _bad_alpha_cases())
def test_a_bad_alpha_raises_before_anything_is_drawn(monkeypatch, route,
                                                     given, value, cube):
    """α ≤ 0, NaN, or below 1 with ``cube`` raises ``ValueError`` on every
    route, however α is given, before a launch or a plain draw: nothing
    launched and no rows counted.  Only a card α reads the card for it."""
    from psrsigsim_torch.ops.gamma import gamma_field
    from psrsigsim_torch.runtime import StageTimers

    card = given is not None and given[0] == "card"
    if (given is not None and given[1] == "cuda"
            and not torch.cuda.is_available()):
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    if value != value:
        monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    timers = StageTimers()
    before = gamma_field.launches
    with pytest.raises(ValueError, match="alpha"):
        with timers.span("dispatch"):
            _draw_route(route, given, value, cube)
    assert gamma_field.launches == before
    snap = timers.snapshot()
    for name in ("rows", "draws", "host_alpha"):
        assert f"gamma.{name}_count" not in snap
    assert ("gamma.host_checks_count" in snap) == card


def _params_want(alpha, traced, dev):
    from psrsigsim_torch.ops.stats import gamma_consts

    a = torch.full((5,), alpha, dtype=torch.float32, device=dev)
    return torch.stack((a,) + gamma_consts(a, traced)[1:], dim=1)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("mode", ["static", "traced"])
def test_host_alpha_constants_equal_the_tensor_ones(alpha, mode):
    """The kernel's rows (α, d, c, 1/α) of a number α and of a host tensor
    α, computed on the host, are ``gamma_consts``' of the tensor, bit for
    bit, in both arithmetics (DIVERGENCES P21)."""
    from psrsigsim_torch.ops.gamma import _host_alpha, _kernel_params

    traced = mode == "traced"
    want = _params_want(alpha, traced, "cpu")
    for given in (alpha, torch.full((5,), alpha)):
        got = _kernel_params(_host_alpha(given, False), 5, "cpu", traced)
        assert got.shape == (5, 4)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("route", CHI2_ROUTES)
@pytest.mark.parametrize("df", [3.3, 7.5, 20.0, 24.9])
def test_routes_pass_a_static_alpha_as_a_host_number(monkeypatch, route, df):
    """Every route hands ``gamma_field`` a static df's α as a Python
    number, float32(df)/2: the tensor α it built on the device before, bit
    for bit."""
    from psrsigsim_torch.ops import gamma

    seen = []

    def spy(keys, alpha, n, **kw):
        seen.append(alpha)
        return torch.zeros((keys.shape[0], n))

    monkeypatch.setattr(gamma, "gamma_field", spy)
    _draw_route(route, None, df, False)
    want = float(torch.full((1,), df, dtype=torch.float32) / 2.0)
    assert len(seen) == 1 and type(seen[0]) is float
    assert np.float32(seen[0]).view(np.int32) == np.float32(want).view(
        np.int32)
    assert seen[0] == float(np.float32(seen[0]))


def test_rsqrt_matches_the_table_form():
    """XLA's rsqrt (estimate + two Newton steps) is within 1 ulp of the
    correctly rounded one, and the estimate within 2^-11."""
    from psrsigsim_torch.ops.stats import _rsqrt_estimate, rsqrt_xla

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1e5, 100_000).astype(np.float32))
    exact = (1.0 / torch.sqrt(x.double()))
    est = _rsqrt_estimate(x).double()
    assert float(((est - exact) / exact).abs().max()) < 2.0 ** -11
    assert _ulps(rsqrt_xla(x).numpy(), exact.float().numpy()).max() <= 1


# -- (b) the routing ------------------------------------------------------------


@pytest.mark.parametrize("name,df,shape,hatch,compiled", SAMPLE_CASES)
def test_chi2_samples_match_reference(ref, monkeypatch, name, df, shape,
                                      hatch, compiled):
    from psrsigsim_torch.ops import stats

    if hatch:
        monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    fn = stats.chi2_sample_compiled if compiled else stats.chi2_sample
    got = fn(_key(11), df, shape).numpy()
    want = ref[f"sample_{name}"]
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name,df,t0,length,hatch,traced", FIELD_CASES)
def test_chi2_fields_match_reference(ref, monkeypatch, name, df, t0, length,
                                     hatch, traced):
    from psrsigsim_torch.ops import stats
    from psrsigsim_torch.utils import split

    monkeypatch.setenv("PSS_SAMPLER", "threefry")
    if hatch:
        monkeypatch.setenv("PSS_EXACT_CHI2", "1")
    chan = torch.arange(*CHAN)
    want = ref[f"field_{name}"]
    if traced:
        ks = split(_key(11), len(df))
        got = stats.blocked_chan_chi2(ks, chan, torch.tensor(df), t0,
                                      length).numpy()
        assert got.shape == want.shape == (len(df), chan.numel(), length)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    fn = (stats.blocked_chan_chi2 if name.startswith("blocked")
          else stats.chan_chi2_field)
    got = fn(_key(11), chan, df, t0, length).numpy()
    assert got.shape == want.shape == (chan.numel(), length)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_hw_sampler_routes_small_df_to_gamma(ref, monkeypatch):
    """With the card's sampler selected, a small static df still draws the
    exact gamma (the threefry keys), as the reference's hw path does."""
    from psrsigsim_torch.ops import stats

    monkeypatch.setenv("PSS_SAMPLER", "hw")
    chan = torch.arange(*CHAN)
    got = stats.chan_chi2_field(_key(11), chan, 3.3, 0, 5000).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  ref["field_chan_3p3"].view(np.int32))
    assert stats._hw_chi2_mode(3.3) is None


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops.gamma import gamma_field
    from psrsigsim_torch.ops.stats import gamma_plain
    from psrsigsim_torch.utils import fold_in

    dev = torch.device("cuda")
    keys = fold_in(_key(1)[None], torch.arange(6)).to(dev)
    for alpha in (0.3, 0.5, 1.0, 2.5, 10.0, 6000.0):
        a = torch.full((6,), alpha, device=dev)
        for traced in (False, True):
            want = gamma_plain(keys, a, 5000, 7, traced, 2.0)
            got = gamma_field(keys, a, 5000, start=7, scale=2.0,
                              traced=traced)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            host = gamma_plain(keys.cpu(), a.cpu(), 5000, 7, traced, 2.0)
            assert torch.equal(want.cpu().view(torch.int32),
                               host.view(torch.int32))
            if alpha >= 1.0:  # the receiver noise's form, V = v^3
                want = gamma_plain(keys, a, 5000, 7, traced, cube=True)
                got = gamma_field(keys, a, 5000, start=7, traced=traced,
                                  cube=True)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", ALPHAS)
def test_host_alpha_rows_and_draws_equal_a_card_alphas(alpha):
    """On the card, a number α's rows (filled in there from the host's
    constants) are the card's ``gamma_consts`` bit for bit, and its draws
    are a card tensor α's (read back once, ``gamma.host_checks``) and the
    card's plain version's, whose constants are computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    from psrsigsim_torch.ops.gamma import (_host_alpha, _kernel_params,
                                           gamma_field)
    from psrsigsim_torch.ops.stats import gamma_plain
    from psrsigsim_torch.runtime import StageTimers
    from psrsigsim_torch.utils import fold_in

    dev = torch.device("cuda")
    keys = fold_in(_key(2)[None], torch.arange(5)).to(dev)
    card = torch.full((5,), alpha, dtype=torch.float32, device=dev)
    for traced in (False, True):
        got = _kernel_params(_host_alpha(alpha, False), 5, dev, traced)
        want = _params_want(alpha, traced, dev)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        for cube in ((False, True) if alpha >= 1.0 else (False,)):
            got = gamma_field(keys, alpha, 3000, start=5, scale=2.0,
                              traced=traced, cube=cube)
            timers = StageTimers()
            with timers.span("dispatch"):
                from_card = gamma_field(keys, card, 3000, start=5, scale=2.0,
                                        traced=traced, cube=cube)
            assert timers.snapshot()["gamma.host_checks_count"] == 1
            plain = gamma_plain(keys, card, 3000, start=5, traced=traced,
                                scale=2.0, cube=cube)
            for want in (from_card, plain):
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))


if __name__ == "__main__":
    _child(sys.argv[1])
