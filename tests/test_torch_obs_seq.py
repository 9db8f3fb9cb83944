"""The port's SEARCH ensembles over a 2-D ``(obs, seq)`` mesh
(``parallel/seqshard.py::seq_sharded_search_ensemble``,
``make_obs_seq_mesh``) against the JAX package, and against itself, on the
CPU — the mirror of tests/test_obs_seq.py.

Geometry: the JAX package's (8 channels over 400 MHz at 1400 MHz, 0.2048
MHz sampling, P = 5 ms, 0.2 s = 40,960 samples), 8 observations with DMs
5-30; a mesh position is a CPU device, repeated.  Tolerances and why:

* across mesh shapes ((4, 2), (2, 4), (8, 1), (1, 1), (1, 4)) and against
  the 1-D seq pipeline per observation: the draws are keyed by
  (observation key, channel, global offset) and every stage is per
  observation and elementwise in time (envelope mode), so bit-identical;
* against the JAX package on the (4, 2) mesh: within rtol 1e-5 plus 1e-5
  of the peak (the portrait's Fourier shift: two FFT libraries).

Reference values come from a child process (this file run as a script)
with 8 virtual XLA CPU devices and the JAX-version shims R1 and R2.
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

from test_torch_seqshard import _cfg, child_env8, seq_mesh  # noqa: E402
from test_torch_toa import shims  # noqa: E402

NOBS = 8
SHAPES = [(4, 2), (2, 4), (8, 1), (1, 1), (1, 4)]


def _dms(n):
    return np.linspace(5.0, 30.0, n).astype(np.float32)


# -- the JAX reference (child process) ----------------------------------------


def _child(out):
    shims()
    import jax
    import jax.numpy as jnp

    from psrsigsim_tpu.parallel import (make_obs_seq_mesh,
                                        seq_sharded_search_ensemble)

    cfg, prof, nn = _cfg("psrsigsim_tpu", tobs=0.2)
    keys = jax.vmap(jax.random.key)(np.arange(NOBS))
    run = seq_sharded_search_ensemble(cfg, make_obs_seq_mesh((4, 2)))
    out_ = run(keys, jnp.asarray(_dms(NOBS)), jnp.full(NOBS, nn, jnp.float32),
               jnp.asarray(prof))
    np.savez(os.path.join(out, "ref.npz"),
             keys=np.asarray(jax.random.key_data(keys)),
             out=np.asarray(out_))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_obs_seq")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                          env=child_env8(), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return dict(z)


# -- the port -------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
        monkeypatch.delenv(k, raising=False)


def obs_seq_mesh(shape):
    from psrsigsim_torch.parallel import make_obs_seq_mesh

    return make_obs_seq_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(scope="module")
def staged():
    return _cfg("psrsigsim_torch", tobs=0.2)


def _keys(n):
    from psrsigsim_torch.utils import key

    return torch.stack([key(i, "cpu") for i in range(n)])


@pytest.fixture(scope="module")
def outs(staged):
    from psrsigsim_torch.parallel import seq_sharded_search_ensemble

    cfg, prof, nn = staged
    return {shape: seq_sharded_search_ensemble(cfg, obs_seq_mesh(shape))(
        _keys(NOBS), _dms(NOBS), np.full(NOBS, nn, np.float32), prof)
        for shape in SHAPES}


def test_shapes_and_batch(staged, outs):
    cfg = staged[0]
    assert outs[(4, 2)].shape == (NOBS, cfg.meta.nchan, cfg.nsamp)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_mesh_shape_invariance(outs, shape):
    assert torch.equal(outs[shape], outs[(4, 2)]), shape


def test_matches_1d_seq_pipeline_per_obs(staged, outs):
    """Each batch entry is the 1-D seq pipeline's stream of that
    observation's key at the same seq width."""
    from psrsigsim_torch.parallel import seq_sharded_search

    cfg, prof, nn = staged
    run1d = seq_sharded_search(cfg, seq_mesh(2))
    keys, dms = _keys(NOBS), _dms(NOBS)
    for i in range(4):
        assert torch.equal(outs[(4, 2)][i],
                           run1d(keys[i], float(dms[i]), nn, prof)), i


def test_batch_divisibility_enforced(staged):
    from psrsigsim_torch.parallel import seq_sharded_search_ensemble

    cfg, prof, nn = staged
    run = seq_sharded_search_ensemble(cfg, obs_seq_mesh((4, 2)))
    with pytest.raises(ValueError, match="divisible"):
        run(_keys(6), _dms(6), np.full(6, nn, np.float32), prof)


def test_mesh_device_guard(monkeypatch):
    """Explicit lists must tile exactly; the default list (every visible
    card) may be truncated but never stretched, and without a card it
    raises instead of falling back to the host."""
    from psrsigsim_torch.parallel import make_obs_seq_mesh

    with pytest.raises(ValueError, match="devices"):
        make_obs_seq_mesh((2, 2), devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_obs_seq_mesh((2, 2))


def test_matches_reference(ref, outs):
    from psrsigsim_torch.utils import as_key

    assert torch.equal(as_key(ref["keys"], "cpu"), _keys(NOBS))
    got = outs[(4, 2)].numpy()
    want = ref["out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


if __name__ == "__main__":
    _child(sys.argv[1])
