"""Dynamic probe: cross-check psrlint's static claims on a device
(counterpart: psrsigsim_tpu/analysis/trace_check.py).

Every public symbol in ``psrsigsim_torch.ops`` is either (a) run on
canonical small inputs already on the requested device, and each tensor
of its result checked against the shape and dtype its probe declares and
against the device, or (b) listed in :data:`EXEMPT` with the reason it is
host-side by design.  A symbol that is neither is a coverage failure —
new ops must register a probe here the day they are exported
(tests/test_torch_psrlint.py enforces this).

Where the reference traces each op under ``jax.make_jaxpr`` and checks
that a second jit call does not retrace, the port runs each probe twice:
the first call builds what it builds (a kernel's nvcc, cuFFT plans), and
on the card the second runs under ``torch.cuda.set_sync_debug_mode(
"error")``, so a host round-trip in the steady state — a Python branch
on a device tensor, ``.item()``, a pageable host-to-device copy of a
staged constant — raises here whatever the linter thought.  A symbol
that synchronizes by design is listed in :data:`SYNCS` with its reason
and runs its second call with the mode off; it is never skipped (the
scenario draws, made on the host by design, are also declared to return
host tensors: :data:`HOST_RESULTS`).  On the CPU there is no card to wait
for and both calls run plainly (the shape, dtype and device checks still
hold every probe).
"""

from __future__ import annotations

__all__ = ["EXEMPT", "SYNCS", "HOST_RESULTS", "probe_specs",
           "run_trace_check", "run_serve_trace_check",
           "run_dataset_trace_check", "run_ensemble_trace_check",
           "ProbeResult"]

from dataclasses import dataclass

#: public ops symbols that are host-side or non-callable by design
EXEMPT = {
    "PchipCoeffs": "interpolant container (NamedTuple), not an op",
    "chi2_draw_norm": "host-side config helper (scipy ppf at staging time)",
    "offpulse_window": "host-side float64 reference-parity variant; "
                       "offpulse_window_jax is the tensor twin",
    "pchip_fit_np": "host-side float64 scipy fit (portrait staging); "
                    "pchip_fit is the tensor twin",
    "pchip_eval_np": "host-side float64 scipy evaluation; pchip_eval is "
                     "the tensor twin",
    "sampler_backend": "host query: names the sampler a device draws "
                       "with, returns a string",
}

#: probes whose steady-state call synchronizes the host with the card by
#: design (the second call runs with the sync-debug mode off)
SYNCS = {
    "scint_gain": "the scenario draws are made on the host by design "
                  "(jax's threefry and XLA's arithmetic written out, "
                  "DIVERGENCES P13): the keys and channel frequencies move "
                  "to the host, the factors come back",
    "rfi_levels": "a scenario draw made on the host by design (P13): the "
                  "keys move to the host, the levels and mask come back",
    "pulse_energies": "a scenario draw made on the host by design (P13): "
                      "the keys move to the host, the energies come back",
    "rebin": "the variable-width gather indices and mask are built with "
             "numpy on the host and copied to the data's device with a "
             "blocking torch.as_tensor (the object-oriented flow's "
             "resampler, once per observe)",
    "dataset_record": "a chunk's prior draws and scenario rows are made on "
                      "the host (jax's threefry, P13) and moved to the card "
                      "with a blocking .to(device) before the SEARCH tile",
}

#: probed symbols whose results land on the host whatever the inputs'
#: device: the scenario draws, made on the host by design (P13); the
#: pipelines hand their factors to the card themselves
HOST_RESULTS = {"scint_gain", "rfi_levels", "pulse_energies"}


@dataclass
class ProbeResult:
    name: str
    status: str       # "ok" | "exempt" | "sync"
    detail: str = ""


def _specs(device):
    """name -> (fn, args, expect): ``args`` are tensors already on
    ``device`` (a host-to-device copy inside the call would be a sync of
    the probe's own making), ``expect`` the ``(shape, dtype)`` of each
    tensor of the result, in order.

    Shapes are tiny: the probe checks that each op runs on the device
    without waiting for it and returns what it declares, not numerics (the
    tier-1 suite owns numerics).  Static configuration (nchan, nsub, modes,
    ...) is closed over.  Global channel ids stay on the host, as every
    pipeline passes them (the sampler reads the first one there).
    """
    import math

    import torch

    from .. import ops
    from ..ops import fold_quantize as fq
    from ..ops.rng_hw import seed_words
    from ..utils.rng import key as make_key
    from ..utils.rng import split

    f32, i16, i32, i64 = torch.float32, torch.int16, torch.int32, torch.int64

    def dev(t):
        return t.to(device)

    key = dev(make_key(0, "cpu"))
    keys = dev(split(make_key(1, "cpu"), 3))
    phase = torch.linspace(0.0, 2.0 * math.pi, 64)
    prof = dev(torch.cos(phase) + 1.0)
    gen = torch.Generator().manual_seed(0)
    block = dev(torch.randn(3, 64, generator=gen))
    codes = dev((torch.arange(96).reshape(4, 3, 8) % 251 - 125).to(i16))
    x8 = dev(torch.arange(8.0))
    y8 = dev(torch.randn(2, 8, generator=gen))
    coeffs = ops.pchip_fit(x8, y8)
    seeds = seed_words(keys)
    dfs = dev(torch.full((3,), 4.0))
    pos = dev(torch.zeros((3, 2), dtype=i32))
    freqs = dev(torch.linspace(1200.0, 1600.0, 8))
    scalar = dev(torch.tensor(0.5))
    packed = dev(torch.randint(-9, 9, (2, 2, 8, 12), dtype=i16,
                               generator=gen))

    def fold_quantize(s, d, p, n):
        return fq.fold_quantize(s, d, ("chi2_wh", "chi2_wh"), p, n, nsub=2)

    return {
        "pchip_slopes": (ops.pchip_slopes, (x8, y8), [((2, 8), f32)]),
        "pchip_fit": (ops.pchip_fit, (x8, y8),
                      [((8,), f32), ((2, 8), f32), ((2, 8), f32)]),
        "pchip_eval": (ops.pchip_eval,
                       (coeffs, dev(torch.linspace(0.0, 7.0, 16))),
                       [((2, 16), f32)]),
        "clip_cast": (lambda b: ops.clip_cast(b, 200.0), (block,),
                      [((3, 64), torch.int8)]),
        "subint_quantize": (lambda b: ops.subint_quantize(b, 4, 16),
                            (block,),
                            [((4, 3, 16), i16), ((4, 3), f32),
                             ((4, 3), f32)]),
        "subint_dequantize": (ops.subint_dequantize,
                              (codes, dev(torch.ones(4, 3)),
                               dev(torch.zeros(4, 3))),
                              [((4, 3, 8), f32)]),
        "swap16": (ops.swap16, (codes,), [((4, 3, 8), i16)]),
        "rng_field": (lambda s, d, p: ops.rng_field(s, d, p, "chi2_wh", 8,
                                                    4096),
                      (seeds, dfs, pos), [((3, 8, 4096), f32)]),
        "rng_field_plain": (lambda s, d, p: ops.rng_field_plain(
            s, d, p, "chi2_wh", 8, 4096), (seeds, dfs, pos),
            [((3, 8, 4096), f32)]),
        "rng_flat_field": (lambda s, d, p: ops.rng_flat_field(
            s, d, p, "normal", 100, 5000), (seeds, dfs, pos),
            [((3, 5000), f32)]),
        "rng_flat_field_plain": (lambda s, d, p: ops.rng_flat_field_plain(
            s, d, p, "normal", 100, 5000), (seeds, dfs, pos),
            [((3, 5000), f32)]),
        "hw_chan_field": (lambda k: ops.hw_chan_field(
            k, 0, 4.0, 0, mode="chi2_wh", nchan=8, length=4096), (keys,),
            [((3, 8, 4096), f32)]),
        # the module: its fused kernel at the main path's shape class
        # (chi2_wh × chi2_wh, whole quads, one RNG block a row)
        "fold_quantize": (fold_quantize,
                          (torch.stack([seeds, seeds]),
                           torch.stack([dfs, dfs]),
                           dev(torch.rand(3, 8, 64, generator=gen)),
                           dev(torch.ones(3))),
                          [((3, 2, 8, 68), i16), ((3, 8), torch.bool)]),
        "packed_digest": (ops.packed_digest, (packed,), [((2,), i32)]),
        "packed_digest_plain": (ops.packed_digest_plain, (packed,),
                                [((2,), i32)]),
        "fourier_shift": (lambda d, s: ops.fourier_shift(d, s, 0.5),
                          (block, dev(torch.arange(3.0))), [((3, 64), f32)]),
        "coherent_dedisperse": (lambda d, dm: ops.coherent_dedisperse(
            d, dm, 1400.0, 200.0, 1.0), (block, scalar), [((3, 64), f32)]),
        "coherent_dedispersion_transfer": (
            lambda dm: ops.coherent_dedispersion_transfer(
                64, dm, 1400.0, 200.0, 1.0), (scalar,),
            [((33,), f32), ((33,), f32)]),
        "channelize_power": (lambda d: ops.channelize_power(d, 8),
                             (dev(torch.zeros(2, 256)),), [((8, 16), f32)]),
        "chan_chi2_field": (lambda k, c: ops.chan_chi2_field(
            k, c, 100.0, 0, 100), (keys, torch.arange(8)),
            [((3, 8, 100), f32)]),
        "chan_normal_field": (lambda k, c: ops.chan_normal_field(
            k, c, 0, 100), (keys, torch.arange(8)), [((3, 8, 100), f32)]),
        "flat_normal_field": (lambda k: ops.flat_normal_field(k, 100, 300),
                              (keys,), [((3, 300), f32)]),
        "flat_chi2_field": (lambda k: ops.flat_chi2_field(k, 100, 300, 1.0),
                            (keys,), [((3, 300), f32)]),
        "chi2_sample": (lambda k: ops.chi2_sample(k, 100.0, (32,)), (key,),
                        [((32,), f32)]),
        "normal": (lambda k: ops.normal(k, 32), (keys,), [((3, 32), f32)]),
        "normal_sample": (lambda k: ops.normal_sample(k, (32,)), (key,),
                          [((32,), f32)]),
        "uniform": (lambda k: ops.uniform(k, 32), (keys,), [((3, 32), f32)]),
        "choice": (lambda k: ops.choice(k, 5), (keys,), [((3,), i64)]),
        "fixed_histogram": (lambda x: ops.fixed_histogram(x, -1.0, 1.0, 8),
                            (block[0],), [((8,), i32)]),
        "fftfit_shift": (ops.fftfit_shift, (prof, prof),
                         [((), f32), ((), f32), ((), f32)]),
        "fftfit_batch": (ops.fftfit_batch, (torch.stack([prof, prof]), prof),
                         [((2,), f32), ((2,), f32), ((2,), f32)]),
        "fftfit_combine": (ops.fftfit_combine,
                           (dev(torch.tensor([0.1, -0.05, 0.02])),
                            dev(torch.tensor([0.01, 0.02, 0.01]))),
                           [((), f32), ((), f32)]),
        "offpulse_window_jax": (ops.offpulse_window_jax, (prof,),
                                [((9,), i64)]),
        "offpulse_window_indices": (
            lambda: ops.offpulse_window_indices(64, device=device), (),
            [((8,), i64)]),
        "fold_periods": (lambda d: ops.fold_periods(d, 16), (block,),
                         [((3, 16), f32)]),
        "scint_gain": (lambda k, fr, dnu, dt, m: ops.scint_gain(
            k, fr, 4, dnu, dt, m, 1400.0, 0.5),
            (keys, freqs, dev(torch.full((3,), 20.0)),
             dev(torch.full((3,), 0.5)), dev(torch.ones(3))),
            [((3, 8, 4), f32)]),
        "rfi_levels": (lambda k, c, ip, ia, np_, na: ops.rfi_levels(
            k, c, 4, ip, ia, np_, na),
            (keys, dev(torch.arange(8)), scalar, dev(torch.tensor(5.0)),
             scalar, dev(torch.tensor(3.0))),
            [((3, 8, 4), f32), ((3, 8, 4), torch.bool)]),
        # each mode is its own program: the probe covers every one
        "pulse_energies": (lambda k, s: tuple(
            ops.pulse_energies(k, 4, mode, s)
            for mode in ("lognormal", "powerlaw", "frb")),
            (keys, scalar), [((3, 4), f32)] * 3),
        "block_downsample": (lambda d: ops.block_downsample(d, 4), (block,),
                             [((3, 16), f32)]),
        "rebin": (lambda d: ops.rebin(d, 16), (block,), [((3, 16), f32)]),
        "fft_convolve_full": (ops.fft_convolve_full, (block, block),
                              [((3, 127), f32)]),
        "convolve_profiles": (lambda p, k: ops.convolve_profiles(p, k, 64),
                              (block, block), [((3, 64), f32)]),
    }


def probe_specs(device=None):
    """The probe table on ``device`` (the card by default, raising without
    one; imports torch on first use)."""
    from ..utils.device import resolve_device

    return _specs(resolve_device(device))


def _tensors(out):
    """The tensors of a result, depth first (tuples, lists, NamedTuples)."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for item in out for t in _tensors(item)]
    return []


def _check_one(name, fn, args, expect, device, sync_ok=False):
    """Run one probe twice (the second call on the card under sync-debug
    "error" unless ``sync_ok``) and check every result tensor's shape,
    dtype and device against ``expect`` (the host for :data:`HOST_RESULTS`);
    raises on failure."""
    import torch

    on_card = torch.device(device).type == "cuda"
    want_type = "cpu" if name in HOST_RESULTS else torch.device(device).type

    def check(out):
        got = [(tuple(t.shape), t.dtype) for t in _tensors(out)]
        want = [(tuple(s), d) for s, d in expect]
        if got != want:
            raise AssertionError(f"{name}: returned {got}, declared {want}")
        wrong = [t.device for t in _tensors(out)
                 if t.device.type != want_type]
        if wrong:
            raise AssertionError(f"{name}: results on {wrong}, not on "
                                 f"{device}")

    check(fn(*args))
    if not on_card:
        check(fn(*args))
        return
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0 if sync_ok else "error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    check(out)
    torch.cuda.synchronize()


def run_serve_trace_check(widths=(1, 8), device=None):
    """Probe the serving layer's width-bucketed batch programs
    (:func:`psrsigsim_torch.parallel.build_width_bucket_fn` over a
    canonical tiny geometry) at each probed bucket width: the result's
    shape, dtype and device, and on the card the steady-state call under
    sync-debug "error" (or :data:`SYNCS`) — run where the linter gate runs
    so a host round-trip added to the fold core or the batch wrapper fails
    before it reaches a server."""
    import numpy as np
    import torch

    from ..parallel.ensemble import build_width_bucket_fn
    from ..serve.spec import build_geometry, canonicalize
    from ..utils.device import resolve_device
    from ..utils.rng import key as make_key

    device = resolve_device(device)

    canonical = canonicalize({
        "nchan": 2, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
        "sample_rate_mhz": 0.2048, "sublen_s": 0.5, "tobs_s": 1.0,
        "period_s": 0.005, "smean_jy": 0.05, "seed": 0, "dm": 10.0,
    })
    cfg, profiles, _ = build_geometry(canonical)
    fn = build_width_bucket_fn(cfg, profiles, device=device)
    results = []
    for w in widths:
        name = f"serve_width_bucket[w={w}]"
        # the batcher's inputs: host key data and per-request columns
        keys = torch.stack([make_key(i, "cpu") for i in range(w)])
        z = np.zeros(w, np.float32)
        _check_one(name, fn, (keys, z, z, z),
                   [((w, cfg.meta.nchan, cfg.nph), torch.float32)], device,
                   sync_ok=name.split("[")[0] in SYNCS)
        results.append(ProbeResult(name, _status(name.split("[")[0])))
    return results


def run_dataset_trace_check(device=None):
    """Probe the dataset factory's record sampler: a chunk of labeled
    records (prior draws on the ``"dataset"`` stage + the SEARCH pipeline
    with scenario effects + the registry truth labels) over a canonical
    tiny spec, each field's shape and dtype as the sampler's
    ``field_layout`` declares it, on the device; on the card the
    steady-state chunk under sync-debug "error" (or :data:`SYNCS`)."""
    import numpy as np
    import torch

    from ..datasets.sampler import RecordSampler
    from ..datasets.spec import canonicalize
    from ..utils.device import resolve_device

    device = resolve_device(device)

    canonical = canonicalize({
        "nchan": 2, "fcent_mhz": 1400.0, "bw_mhz": 400.0,
        "sample_rate_mhz": 0.2048, "tobs_s": 0.02, "period_s": 0.005,
        "smean_jy": 0.05, "seed": 0, "n_records": 8, "dm": 10.0,
        "scenarios": ["scintillation", "rfi", "single_pulse"],
        "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0}},
    })
    sampler = RecordSampler(canonical, device=device)
    width = 2
    expect = [((width,) + tuple(shape), torch.from_numpy(
        np.zeros(0, np.dtype(dtype))).dtype)
        for _, dtype, shape in sampler.field_layout()]
    name = "dataset_record"
    _check_one(name, lambda: sampler.dispatch(0, width), (), expect, device,
               sync_ok=name in SYNCS)
    return [ProbeResult(name, _status(name))]


def run_ensemble_trace_check(ens, n_obs):
    """Probe the main path's steady call, ``ens.run_quantized(n_obs)``, on
    the ensemble's own device and at its own geometry (a full-width
    ensemble takes branches a canonical tiny one does not): the int16
    codes and the float32 scale and offset, and on the card the
    steady-state call under sync-debug "error" (or :data:`SYNCS`)."""
    import torch

    cfg = ens.cfg
    rows = (n_obs, cfg.nsub, cfg.meta.nchan)
    name = "ensemble_run_quantized"
    _check_one(name, lambda: ens.run_quantized(n_obs, seed=0), (),
               [(rows + (cfg.nph,), torch.int16), (rows, torch.float32),
                (rows, torch.float32)], ens.device, sync_ok=name in SYNCS)
    return [ProbeResult(name, _status(name), SYNCS.get(name, ""))]


def _status(name):
    return "sync" if name in SYNCS else "ok"


def run_trace_check(symbols=None, device=None):
    """Probe the given ops symbols (default: all of ``ops.__all__``) on
    ``device`` (the card by default, raising without one; ``"cpu"`` runs
    the probes on the host, without the sync check).

    Returns a list of :class:`ProbeResult`; raises on the first op whose
    probe fails, and on any public symbol with neither a probe nor an
    exemption (coverage is part of the contract).
    """
    from .. import ops
    from ..utils.device import resolve_device

    names = list(ops.__all__) if symbols is None else list(symbols)
    device = resolve_device(device)
    specs = probe_specs(device)
    # coverage first: no probe runs before every name is accounted for
    missing = [n for n in names if n not in EXEMPT and n not in specs]
    if missing:
        raise AssertionError(
            f"ops symbols with no probe and no exemption: {missing} "
            "— add a canonical-shape entry to analysis/trace_check.py")
    results = []
    for name in names:
        if name in EXEMPT:
            results.append(ProbeResult(name, "exempt", EXEMPT[name]))
            continue
        fn, args, expect = specs[name]
        _check_one(name, fn, args, expect, device, sync_ok=name in SYNCS)
        results.append(ProbeResult(name, _status(name), SYNCS.get(name, "")))
    return results
