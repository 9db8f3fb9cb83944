"""The envelope-shift kernel (``ops/envelope_shift.py``,
``csrc/envelope_shift.cu``): the Fourier shift's double-float ramp and
spectrum product.

On the CPU the wrapper runs its plain version, the torch chain
``fourier_shift`` ran before the kernel: here the broadcast rules, the
spectrum-row rule the launch relies on and the routes are held.  On the card
(``cuda``-marked) the kernel is held to the plain version run on the card,
bit for bit: ``theta`` (the same IEEE operations in the same order) and
the shifted spectrum (the CUDA math library's cosf/sinf, as torch.cos and
torch.sin call them, and c10::complex's product as PyTorch compiles it),
at the shapes of the multi-pulsar ensemble's two buckets, the stream's
shared portrait, the Monte-Carlo study's per-trial portraits and the
full-stream shift, with the sample spacing as a float and as a tensor.
"""

import numpy as np
import pytest
import torch

from psrsigsim_torch.ops import envelope_shift as es
from psrsigsim_torch.ops import shift


def _spec(shape, n, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape + (n,), generator=g)
    return torch.fft.rfft(x, dim=-1).to(device)


def _delays(shape, seed=1, scale=300.0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * scale


def test_shared_spectrum_rows():
    # a spectrum broadcast over leading axes only is read in place, output
    # row r reading its row r % spec_rows
    assert es._shared_rows((64,), (128, 64)) == 64
    assert es._shared_rows((1, 64), (128, 64)) == 64
    assert es._shared_rows((92, 1, 64), (92, 1, 64)) == 92 * 64
    assert es._shared_rows((), (5,)) == 1
    # broadcast over an inner axis: copied out to the rows
    assert es._shared_rows((4, 1, 8), (4, 3, 8)) is None
    assert es._shared_rows((8,), (8, 1)) is None


@pytest.mark.parametrize("case", ["shared_portrait", "per_row", "dt_tensor"])
def test_cpu_route_is_the_plain_chain(case):
    """On the CPU the wrapper is the plain version and counts no launch;
    its output rows are the broadcast of the inputs'."""
    n = 64
    if case == "shared_portrait":
        spec, shifts, dt = _spec((8,), n), _delays((5, 8)), 0.25
    elif case == "per_row":
        spec, shifts, dt = _spec((5, 8), n), _delays((5, 8)), 0.25
    else:
        spec, shifts = _spec((3, 1, 8), n), _delays((3, 1, 8))
        dt = torch.tensor([0.25, 0.5, 0.125]).reshape(3, 1, 1, 1)
    before = es.envelope_shift.launches
    got = es.envelope_shift(spec, shifts, dt, n)
    assert es.envelope_shift.launches == before
    want = es.envelope_shift_plain(spec, shifts, dt, n)
    assert got.shape == torch.broadcast_shapes(spec.shape[:-1],
                                               shifts.shape) + (n // 2 + 1,)
    assert torch.equal(got, want)
    assert torch.equal(es.ramp_theta(shifts, dt, n, "cpu"),
                       es.ramp_theta_plain(shifts, dt, n, "cpu"))


def test_shared_rows_equal_expanded_rows():
    """A spectrum shared by many shifts gives each output row the bits of
    the same row computed alone."""
    n = 128
    spec, shifts = _spec((8,), n), _delays((6, 8))
    shared = es.envelope_shift(spec, shifts, 0.1, n)
    for b in range(6):
        one = es.envelope_shift(spec.clone(), shifts[b].clone(), 0.1, n)
        assert torch.equal(shared[b], one)


def test_fourier_shift_tensor_shift_is_a_circular_shift():
    # a whole-sample delay: the ramp is exact to float32 rounding
    n = 64
    x = torch.zeros(2, n)
    x[:, 3] = 1.0
    out = shift.fourier_shift(x, torch.tensor([5.0, 0.0]), dt=1.0)
    assert int(out[0].argmax()) == 8 and int(out[1].argmax()) == 3
    np.testing.assert_allclose(out[0, 8].item(), 1.0, atol=1e-5)


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


# (spectrum leading shape, shifts shape, dt: float or its tensor shape, n)
CARD_CASES = {
    # the multi-pulsar ensemble's buckets: a portrait, DM and dt per pulsar
    "msp_4096": ((92, 1, 64), (92, 1, 64), (92, 1, 1, 1), 4096),
    "msp_2048": ((36, 1, 64), (36, 1, 64), (36, 1, 1, 1), 2048),
    # the stream: one portrait, a DM per observation
    "stream": ((64,), (128, 64), 0.00177, 2048),
    # the Monte-Carlo study: a portrait and a DM per trial
    "mc": ((256, 64), (256, 64), 0.00177, 2048),
    # the full-stream shift (PSS_EXACT_SHIFT=1): 20 subints of 2048 bins
    "fft_mode": ((4, 64), (4, 64), 0.00177, 40960),
    # dt as a tensor with one spacing for the batch
    "dt_scalar_tensor": ((64,), (16, 64), (), 2048),
    # a spectrum broadcast over an inner axis, copied out to the rows
    "inner_broadcast": ((4, 1, 64), (4, 3, 64), (4, 1, 1, 1), 2048),
}


def _card_inputs(case, dev):
    lead, sshape, dt, n = CARD_CASES[case]
    spec = _spec(lead, n, device=dev)
    shifts = _delays(sshape).to(dev)
    if not isinstance(dt, float):
        g = torch.Generator().manual_seed(2)
        dt = (0.001 + 0.003 * torch.rand(dt, generator=g)).to(dev)
    return spec, shifts, dt, n


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_version_on_card(case):
    dev = _card()
    spec, shifts, dt, n = _card_inputs(case, dev)
    theta = es.ramp_theta(shifts, dt, n, dev)
    want_theta = es.ramp_theta_plain(shifts, dt, n, dev)
    assert theta.shape == want_theta.shape
    assert torch.equal(theta.view(torch.int32), want_theta.view(torch.int32))
    before = es.envelope_shift.launches
    got = es.envelope_shift(spec, shifts, dt, n)
    assert es.envelope_shift.launches == before + 1
    want = es.envelope_shift_plain(spec, shifts, dt, n)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(want).view(torch.int32))


@pytest.mark.cuda
def test_fourier_shift_launches_once_and_matches_the_chain_on_card():
    dev = _card()
    n = 2048
    g = torch.Generator().manual_seed(3)
    prof = torch.rand(64, n, generator=g).to(dev)
    delays = _delays((128, 64)).to(dev)
    before = es.envelope_shift.launches
    got = shift.fourier_shift(prof, delays, dt=0.00177)
    assert es.envelope_shift.launches == before + 1
    want = shift._irfft_rows(es.envelope_shift_plain(
        shift._rfft_rows(prof), delays, 0.00177, n), n)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scalar_dm_through_the_fused_route_on_card():
    """A scalar DM with a shared portrait: one shifted portrait, expanded
    per observation where the fused kernel reads it, the codes of the
    same DM given per observation."""
    from psrsigsim_torch.signal.state import SignalMeta
    from psrsigsim_torch.simulate.pipeline import (FoldPipelineConfig,
                                                   fold_pipeline_quantized)
    from psrsigsim_torch.utils import key, stage_key

    dev = _card()
    meta = SignalMeta(sigtype="FilterBankSignal", fcent_mhz=1400.0,
                      bw_mhz=400.0, nchan=8, samprate_mhz=0.2048, fold=True)
    cfg = FoldPipelineConfig(meta=meta, period_s=0.005, nsub=2, nph=1024,
                             nfold=100.0, draw_norm=1.0, noise_df=100.0,
                             dt_ms=0.005 * 1e3 / 1024, clip_max=200.0)
    keys = stage_key(key(0, dev), "user", torch.arange(5, device=dev))
    prof = torch.rand(8, 1024, generator=torch.Generator().manual_seed(4))
    before = es.envelope_shift.launches
    one = fold_pipeline_quantized(keys, 30.0, 1.0, prof.to(dev), cfg)
    assert es.envelope_shift.launches == before + 1
    each = fold_pipeline_quantized(keys, torch.full((5,), 30.0, device=dev),
                                   1.0, prof.to(dev), cfg)
    for a, b in zip(one, each):
        assert torch.equal(a, b)
