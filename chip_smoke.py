#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives psrsigsim_torch's fold-mode ensemble main path on the card, from
configured signal/pulsar/telescope objects to packed int16 PSRFITS
buffers, with the random fields drawn by the hand-written CUDA sampler
kernel (psrsigsim_torch/csrc/rng_field.cu, built here with nvcc into
build/).  Phases:

1. the card, its power limit, and the torch/CUDA versions;
2. the kernel build;
3. the kernel against its plain PyTorch version, on the card, in every
   mode: edge shapes (three keys, first channel 8, 13 channels, an
   unaligned span) and the main path's own shape;
4. statistics of the kernel's fields and their split invariance;
5. the main path at full width: BASELINE config 1 (J1713+0747 template,
   64 channels, 2048 bins, 20 x 60 s subints) x 128 observations through
   FoldEnsemble.run_quantized and iter_chunks, with the kernel's launch
   count read around it;
6. parity: the threefry sampler on the card against the CPU;
7. one JSON line with each kernel's launches, error, times and bound.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of one
steady main-path chunk after phase 5 (device time by kernel, busy share).

Exits non-zero, with no result line, if there is no CUDA device, if the
port is missing, or if any phase fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# operations per sample of the sampler kernel, counted from its source:
# Philox4x32-10 is 10 rounds of 4 multiplies and 4 XORs plus 9 key bumps
# of 2 adds (98); two 24-bit uniforms (7); Box-Muller with each libm call
# counted as one operation (6); the Wilson-Hilferty cube and clamp (6).
# Each is held to PEAK_OPS_PER_S, the float32 rate that counts an FMA as two
# operations; 32-bit integer multiplies and logic issue at a quarter of that
# on Hopper (64 per SM per clock), so this bound is optimistic for Philox.
RNG_OPS_PER_SAMPLE = 98 + 7 + 6 + 6

MAIN_NOBS = 128
MAIN = dict(nchan=64, period_s=0.005, samprate_mhz=0.4096, sublen_s=60.0,
            tobs_s=1200.0, fcent=1380.0, bw=400.0, smean=0.009, dm=15.9)
PARITY = dict(nchan=16, period_s=0.005, samprate_mhz=0.0512, sublen_s=60.0,
              tobs_s=240.0, fcent=1380.0, bw=400.0, smean=0.009, dm=15.9)


def log(msg):
    print(msg, flush=True)


def geometry(g, device):
    """BASELINE config 1's objects (bench.py config1_fold64 with the J1713
    template and the TestScope/TestSys telescope), at the widths of ``g``."""
    import numpy as np

    from psrsigsim_torch.data import data_path
    from psrsigsim_torch.models.pulsar import DataProfile, Pulsar
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.utils import make_quant

    sig = FilterBankSignal(g["fcent"], g["bw"], Nsubband=g["nchan"],
                           sample_rate=g["samprate_mhz"], fold=True,
                           sublen=g["sublen_s"])
    prof = np.load(data_path("J1713+0747_profile.npy"))
    psr = Pulsar(g["period_s"], g["smean"],
                 DataProfile(prof, phases=None, Nchan=g["nchan"]),
                 name="J1713+0747", seed=0)
    sig._tobs = make_quant(g["tobs_s"], "s")
    sig._dm = make_quant(g["dm"], "pc/cm^3")
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="TestScope")
    tel.add_system("TestSys", Receiver(fcent=g["fcent"], bandwidth=g["bw"],
                                       name="TestRCVR"),
                   Backend(samprate=12.5, name="TestBack"))
    return FoldEnsemble(sig, psr, tel, "TestSys", device=device)


def ulp_close(got, want, ulps=4, atol=1e-6):
    """max |got - want| and whether it is within ``ulps`` float32 ulps of
    ``want`` (relative) plus ``atol`` (normals near 0)."""
    import torch

    err = (got - want).abs()
    tol = ulps * 2.0**-23 * want.abs() + atol
    return float(err.max()), bool((err <= tol).all())


def cuda_time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed = []
        self.kernel = {}
        self._main = None

    def main_ensemble(self):
        """The main path's ensemble (staged once, on the card)."""
        if self._main is None:
            self._main = geometry(MAIN, self.dev)
        return self._main

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - reported, and the run fails
            traceback.print_exc()
            self.failed.append(name)
            log(f"FAIL {name} ({time.perf_counter() - t0:.1f} s)")
            return False
        log(f"ok {name} ({time.perf_counter() - t0:.1f} s)")
        return True

    # -- 1 ------------------------------------------------------------------
    def card(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        self.card_line = smi[0].strip()
        log(self.card_line)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")

    # -- 2 ------------------------------------------------------------------
    def build(self):
        from psrsigsim_torch.ops import rng_hw

        t0 = time.perf_counter()
        lib = rng_hw.build()
        log(f"built rng_field in {time.perf_counter() - t0:.1f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    # -- 3 ------------------------------------------------------------------
    def kernel_vs_plain(self):
        torch = self.torch
        from psrsigsim_torch.ops import rng_hw, stats
        from psrsigsim_torch.utils import fold_in, key

        keys = fold_in(key(1, self.dev), torch.arange(3, device=self.dev))
        seeds = torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)
        pos = torch.tensor([[1, 2]] * 3, dtype=torch.int32, device=self.dev)
        worst = 0.0
        cases = [("normal", 0.0), ("chi2_1", 0.0), ("chi2_wh", 12000.0),
                 ("chi2_sel", 12000.0), ("chi2_sel", 1.0)]
        for mode, df in cases:
            dfs = torch.full((3,), df, device=self.dev)
            got = rng_hw.rng_field(seeds, dfs, pos, mode, 13, 5000)
            want = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 13, 5000)
            err, ok = ulp_close(got, want)
            # an unaligned span: overdraw one block and slice, as the
            # pipelines' dispatch does
            span = stats._hw_field_span(keys, torch.arange(8, 21),
                                        dfs, 2 * 4096 + 1234, mode, 5000)
            full = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 13, 3 * 4096)
            err2, ok2 = ulp_close(span, full[..., 1234:6234])
            log(f"  {mode:8s} df={df:<8g} max|kernel-plain| {err:.3g} "
                f"(unaligned span {err2:.3g})")
            if not (ok and ok2):
                raise AssertionError(f"{mode}: kernel disagrees with plain version")
            worst = max(worst, err, err2)

        # the main path's own shape and keys: both fields of observations
        # 0..127 of seed 0
        from psrsigsim_torch.utils import stage_key

        obs = stage_key(key(0, self.dev), "user",
                        torch.arange(MAIN_NOBS, device=self.dev))
        nsamp = self.main_ensemble().cfg.nsamp
        for stage in ("pulse", "noise"):
            k = stage_key(obs, stage)
            got = rng_hw.hw_chan_field(k, 0, 12000.0, 0, mode="chi2_wh",
                                       nchan=MAIN["nchan"], length=nsamp)
            s = torch.where(k >= 2**31, k - 2**32, k).to(torch.int32)
            want = rng_hw.rng_field_plain(
                s, torch.full((MAIN_NOBS,), 12000.0, device=self.dev),
                torch.zeros((MAIN_NOBS, 2), dtype=torch.int32, device=self.dev),
                "chi2_wh", MAIN["nchan"], nsamp)
            err, ok = ulp_close(got, want)
            log(f"  main-path shape {tuple(got.shape)} {stage}: "
                f"max|kernel-plain| {err:.3g}")
            if not ok:
                raise AssertionError("kernel disagrees with plain version at "
                                     "the main-path shape")
            worst = max(worst, err)
            del got, want
        self.kernel["max_abs_err"] = worst

    # -- 4 ------------------------------------------------------------------
    def statistics(self):
        torch = self.torch
        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.utils import key

        k = key(5, self.dev)
        C, L = 64, 40960
        n = C * L
        for mode, df, mean, var, m4 in (
                ("normal", 0.0, 0.0, 1.0, 3.0),
                ("chi2_1", 0.0, 1.0, 2.0, 60.0),
                ("chi2_wh", 12000.0, 12000.0, 24000.0, 3 * 24000.0**2)):
            x = rng_hw.hw_chan_field(k, 0, df, 0, mode=mode, nchan=C,
                                     length=L).double()
            m, v = float(x.mean()), float(x.var())
            dm_tol = 5 * (var / n) ** 0.5
            dv_tol = 5 * ((m4 - var**2) / n) ** 0.5
            log(f"  {mode:8s} mean {m:.6g} (want {mean:g} ± {dm_tol:.3g}) "
                f"var {v:.6g} (want {var:g} ± {dv_tol:.3g})")
            if abs(m - mean) > dm_tol or abs(v - var) > dv_tol:
                raise AssertionError(f"{mode} moments outside 5 sigma")
        full = rng_hw.hw_chan_field(k, 0, 12000.0, 0, mode="chi2_wh", nchan=C,
                                    length=L)
        rows = []
        for c0 in (0, 32):
            rows.append(torch.cat([
                rng_hw.hw_chan_field(k, c0, 12000.0, t0, mode="chi2_wh",
                                     nchan=32, length=nt)
                for t0, nt in ((0, 5 * 4096), (5 * 4096, L - 5 * 4096))], dim=1))
        if not torch.equal(full, torch.cat(rows, dim=0)):
            raise AssertionError("split at channels {0,32} x blocks {0,5} "
                                 "changed the samples")
        log("  split invariance: (64 x 40960) == channels {0,32} x blocks {0,5}")

    # -- 5 ------------------------------------------------------------------
    def main_path(self):
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import rng_hw

        os.environ.pop("PSS_SAMPLER", None)
        ens = self.main_ensemble()
        cfg = ens.cfg
        log(f"  config1_fold64: nchan {cfg.meta.nchan} nph {cfg.nph} "
            f"nsub {cfg.nsub} nsamp {cfg.nsamp} nfold {cfg.nfold:g} "
            f"noise_norm {ens.noise_norm:.6g}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        rng_hw.rng_field.launches = 0
        t0 = time.perf_counter()
        data, scl, offs, fin = ens.run_quantized(MAIN_NOBS, seed=0,
                                                 return_finite=True)
        torch.cuda.synchronize()
        t_rq = time.perf_counter() - t0
        t0 = time.perf_counter()
        chunks = list(ens.iter_chunks(2 * MAIN_NOBS, chunk_size=MAIN_NOBS,
                                      seed=0, quantized=True,
                                      byte_order="big", finite_mask=True))
        t_ic = time.perf_counter() - t0
        launches = rng_hw.rng_field.launches
        peak = torch.cuda.max_memory_allocated()
        self.kernel["launches"] = launches
        log(f"  rng_field launches in the main-path run: {launches}")
        if launches <= 0:
            raise AssertionError("the main path never launched the kernel")

        d = data.cpu().numpy()
        s = scl.cpu().numpy()
        o = offs.cpu().numpy()
        if not bool(fin.all()):
            raise AssertionError("non-finite samples in run_quantized")
        if d.shape != (MAIN_NOBS, cfg.nsub, cfg.meta.nchan, cfg.nph):
            raise AssertionError(f"unexpected shape {d.shape}")
        if d.min() < -32767 or d.max() > 32767:
            raise AssertionError("codes outside [-32767, 32767]")
        if [c[0] for c in chunks] != [0, MAIN_NOBS]:
            raise AssertionError("unexpected chunk starts")
        for _, (cd, cs, co, cf) in chunks:
            if not cf.all():
                raise AssertionError("non-finite samples in iter_chunks")
        cd, cs, co, _ = chunks[0][1]
        if not (np.array_equal(cd.view(">i2"), d) and np.array_equal(cs, s)
                and np.array_equal(co, o)):
            raise AssertionError("big-endian chunk differs from run_quantized")

        # dequantized channel means: draw_norm*nfold*<profile> + noise_df*norm
        prof = ens._profiles_np.astype(np.float64)
        deq = d.astype(np.float64) * s[..., None] + o[..., None]
        got = deq.mean(axis=(0, 1, 3))
        want = (cfg.draw_norm * cfg.nfold * prof.mean(axis=1)
                + cfg.noise_df * ens.noise_norm)
        rel = np.abs(got / want - 1)
        log(f"  channel means vs expectation: max rel dev {rel.max():.3g}")
        if rel.max() > 0.01:
            raise AssertionError("dequantized channel means off by > 1%")

        # steady state: the same chunk again, timed on the host clock
        del data, scl, offs, chunks, cd, cs, co
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = ens.run_quantized(MAIN_NOBS, seed=0)
        torch.cuda.synchronize()
        t_ss = (time.perf_counter() - t0) / reps
        del out
        t0 = time.perf_counter()
        for _ in ens.iter_chunks(2 * MAIN_NOBS, chunk_size=MAIN_NOBS, seed=0,
                                 quantized=True, byte_order="big",
                                 finite_mask=True):
            pass
        t_ic2 = time.perf_counter() - t0
        name = torch.cuda.get_device_name(0)
        log(f"  first run_quantized({MAIN_NOBS}) {t_rq:.3f} s; "
            f"iter_chunks({2 * MAIN_NOBS}, chunk {MAIN_NOBS}, big-endian, "
            f"host copy) {t_ic:.3f} s = {2 * MAIN_NOBS / t_ic:.1f} obs/s")
        log(f"  steady iter_chunks({2 * MAIN_NOBS}): {t_ic2:.3f} s = "
            f"{2 * MAIN_NOBS / t_ic2:.1f} obs/s")
        log(f"  steady run_quantized({MAIN_NOBS}): {t_ss * 1e3:.2f} ms = "
            f"{MAIN_NOBS / t_ss:.1f} obs/s; peak memory "
            f"{peak / 2**30:.2f} GiB ({name}, {self.card_line})")

    # -- optional -----------------------------------------------------------
    def profile(self):
        """Where the main path's time goes: one steady run_quantized(128)
        under torch.profiler, device time by kernel and the device's busy
        share of the host wall time (``--profile`` only)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        ens = self.main_ensemble()
        ens.run_quantized(MAIN_NOBS, seed=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ens.run_quantized(MAIN_NOBS, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {}
        spans = []
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = ev.time_range.elapsed_us()
            spans.append((ev.time_range.start, ev.time_range.end))
            tot, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + us, n + 1)
        busy, end = 0.0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        log(f"  wall {wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / 1e6 / wall:.1%}), {len(spans)} device events "
            f"on {self.card_line}")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
            log(f"  {us / 1e3:9.3f} ms {n:4d}x  {name[:110]}")

    # -- 6 ------------------------------------------------------------------
    def parity(self):
        torch = self.torch
        import numpy as np

        os.environ["PSS_SAMPLER"] = "threefry"
        try:
            gpu = geometry(PARITY, self.dev)
            cpu = geometry(PARITY, "cpu")
            cfg = gpu.cfg
            log(f"  parity geometry: nchan {cfg.meta.nchan} nph {cfg.nph} "
                f"nsub {cfg.nsub}")
            bg = gpu.run(8, seed=1).cpu().numpy()
            bc = cpu.run(8, seed=1).numpy()
            rel = np.abs(bg - bc) / np.abs(bc)
            log(f"  float blocks: max rel diff {rel.max():.3g} "
                f"(bit-equal {np.mean(bg == bc):.4f})")
            if rel.max() > 1e-5:
                raise AssertionError("threefry float blocks differ beyond rtol 1e-5")
            qg = [a.cpu().numpy() for a in gpu.run_quantized(8, seed=1)]
            qc = [a.numpy() for a in cpu.run_quantized(8, seed=1)]
            diff = qg[0].astype(np.int32) - qc[0].astype(np.int32)
            frac = float(np.mean(diff != 0))
            log(f"  codes: {frac:.3g} of entries differ, max |diff| "
                f"{np.abs(diff).max()} LSB")
            if np.abs(diff).max() > 1 or frac > 1e-2:
                raise AssertionError("quantized codes differ beyond 1 LSB on 1%")
            for a, b in zip(qg[1:], qc[1:]):
                np.testing.assert_allclose(a, b, rtol=1e-5)
        finally:
            os.environ.pop("PSS_SAMPLER", None)

    # -- 7 ------------------------------------------------------------------
    def measure(self):
        torch = self.torch
        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.utils import key, stage_key

        B, C, L = MAIN_NOBS, MAIN["nchan"], self.main_ensemble().cfg.nsamp
        k = stage_key(stage_key(key(0, self.dev), "user",
                                torch.arange(B, device=self.dev)), "pulse")
        seeds = torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()
        dfs = torch.full((B,), 12000.0, device=self.dev)
        pos = torch.zeros((B, 2), dtype=torch.int32, device=self.dev)
        ms = cuda_time_ms(lambda: rng_hw.rng_field(seeds, dfs, pos, "chi2_wh",
                                                   C, L), 20)
        plain_ms = cuda_time_ms(lambda: rng_hw.rng_field_plain(
            seeds, dfs, pos, "chi2_wh", C, L), 1)
        library_ms = cuda_time_ms(lambda: torch.randn(
            (B, C, L), device=self.dev), 20)
        n = B * C * L
        bytes_moved = 4 * n + B * (8 + 4 + 8)
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = RNG_OPS_PER_SAMPLE * n / PEAK_OPS_PER_S * 1e3
        self.kernel.update(
            name="rng_field", route="cuda",
            source="psrsigsim_torch/csrc/rng_field.cu",
            replaces="psrsigsim_tpu/ops/rng_pallas.py:115",
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms)
        log(f"  rng_field (B={B}, C={C}, L={L}, chi2_wh): {ms:.4f} ms; plain "
            f"{plain_ms:.2f} ms; torch.randn {library_ms:.4f} ms; bound "
            f"{max(t_bytes, t_ops):.4f} ms ({self.kernel['bound_by']}: bytes "
            f"{t_bytes:.4f}, ops {t_ops:.4f}) on {self.card_line}")

    def run(self, with_profile=False):
        self.phase("1 card", self.card)
        built = self.phase("2 build", self.build)
        if built:
            self.phase("3 kernel vs plain", self.kernel_vs_plain)
            self.phase("4 statistics", self.statistics)
            self.phase("5 main path", self.main_path)
            if with_profile:
                self.phase("5b profile", self.profile)
        self.phase("6 threefry parity", self.parity)
        if built and not self.failed:
            self.phase("7 kernel timing", self.measure)
        if self.failed:
            log(f"FAILED phases: {', '.join(self.failed)}")
            return 1
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        print(json.dumps({"kernels": [{k: self.kernel[k] for k in keys}]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": self.torch.cuda.get_device_name(0),
            "count": self.torch.cuda.device_count()}}))
        return 0


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import psrsigsim_torch  # noqa: F401
    except ImportError as err:
        print(f"FAIL: the port is not importable from {ROOT}: {err}",
              file=sys.stderr)
        return 2
    return Smoke().run(with_profile="--profile" in sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
