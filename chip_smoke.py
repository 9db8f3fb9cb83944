#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives psrsigsim_torch's fold-mode ensemble main path on the card, from
configured signal/pulsar/telescope objects to packed int16 PSRFITS
buffers and files, its SEARCH mode and dataset factory, its baseband
pipeline and its multi-pulsar ensemble (and at the end the port's linter
and its 12 tutorials), through the
port's hand-written CUDA kernels, built here with nvcc into build/: the
random-field sampler (psrsigsim_torch/csrc/rng_field.cu), which draws the
float blocks of FoldEnsemble.run in its rows layout and the SEARCH-mode
fields in its flat layout (rng_flat_field); the fused fold -> quantize
-> pack kernel (csrc/fold_quantize.cu), which draws the same samples
inside and writes the packed codes of run_quantized and iter_chunks; and
the packed-digest kernel (csrc/packed_digest.cu), the integrity lattice's
per-observation digest of a packed chunk; and the exact-gamma kernel
(csrc/gamma_field.cu), jax.random.gamma's draws bit for bit, which every
chi^2 of a df below 50 (other than 1) and every chi^2 under
PSS_EXACT_CHI2=1 takes.  Phases:

1. the card, its power limit, the torch/CUDA versions and the host CPU;
2. the build of the kernels (one nvcc each, started together), with each
   kernel entry's registers, stack frame and spills as ptxas reports them;
3. the sampler against its plain PyTorch version, on the card, in every
   mode: edge shapes (three keys, first channel 8, 13 channels, a ragged
   span, an unaligned span) and the main path's own shape;
3b. the exhaustive self-test of the sampler's Box-Muller sequences (all
   2^24 words against the CUDA math library's logf/sqrtf/sincosf); the
   fused kernel against its plain version and against the unfused path
   (sampler fields + the PyTorch body), bit for bit, on each of its routes:
   the main path at full width in both byte orders (the rows kernel) and
   edge shapes on each side of every route boundary (rows crossing an RNG
   block, rows from t0 = 3072, a mode pair off the rows kernel's, 13
   channels, nph 1000, nph 935, rows too long for shared memory, a
   per-observation df, draw_norm, NaN rows, constant rows);
3c. the packed-digest kernel against its plain version, bit for bit: the
   main path's full-width chunk in both byte orders, count < B, and edge
   shapes (nbin not a multiple of 4, a buffer not 8-byte aligned, extreme
   codes);
4. statistics of the sampler's fields and their split invariance;
5. the main paths at full width, BASELINE config 1 (J1713+0747 template,
   64 channels, 2048 bins, 20 x 60 s subints): 128 observations through
   FoldEnsemble.run_quantized and iter_chunks (the fused kernel), then 16
   through FoldEnsemble.run (the sampler), each with every kernel's launch
   count set to 0 just before and read just after; then which of cuFFT's
   real transforms rounds the same rows apart in a batch of 8 x 64 and of
   128 x 64 rows (logged) and the shift's grouped transforms, which must
   not; and observations 0-7's codes, scales and offsets at batch widths
   1, 8, 37 and 128, which must be bit-identical;
6. parity: the threefry sampler on the card against the CPU;
7. each kernel's time against its bound, and the main path's front half
   (DM delays, the double-float ramp and the grouped FFTs) by device time;
8. the PSRFITS export at the same full width (psrsigsim_torch.io.
   export_ensemble_psrfits, 128-observation chunks through the fused
   kernel, the copy stream and fetch thread of iter_chunks, spawn writers)
   into a temporary directory under build/, deleted afterwards: 256
   observations one per file (default writers, then one in-process
   writer), the files held to run_quantized bit for bit, resume after
   deleting files (byte-identical, the fused kernel launched once per
   chunk holding a missing file), 16 observations per file (rows equal to
   the per-file payloads), a serial depth-0 export equal to the pooled
   depth-2 one; first of all iter_chunks with and without the overlap
   (bit-identical, obs/s of each);
9. the supervised export (psrsigsim_torch.runtime.supervised_export) at the
   same full width, 256 observations in 128-observation chunks, into
   build/, deleted afterwards: a clean run with one writer and with the
   default pool (files equal run_quantized's, the journal holding two chunk
   commits; the fused kernel launched twice, the digest kernel never); NaN
   quarantine of two observations in different chunks, recovered by one
   salted run_quantized_at (their files equal it, every other file the
   clean run's); the integrity lattice with a full audit, a host.corrupt on
   chunk 0 and a device.sdc on chunk 128 (both healed, files equal the
   clean run's; two launches of the fused kernel on the same inputs
   bit-equal); kill and resume: a child process SIGKILLed after chunk 0's
   commit, then resume="verify" launching the fused kernel once and ending
   byte-identical;
10. the README's Quickstart and the Simulation facade on the card
   (psrsigsim_torch's object-oriented flow): (a) make_pulses -> ISM().
   disperse -> GBT().observe(noise=True) at full width (64 channels, 30 x
   935 bins), the same flow with device="cpu" on the host, keys and stage
   order equal, data within rtol 1e-5 (floor 1e-5 of the peak); (b) the
   same band in SEARCH mode, a 2 s snippet (64 x 409600): make_pulses ->
   disperse -> null(0.3) -> observe(noise=True) on both, the nulled pulses
   (jax's permutation) equal, data within the same limit; (c)
   Simulation(psrdict=...) at BASELINE config 1's full width: simulate(),
   save_simulation to PSRFITS and (on tutorial 5's 16-channel geometry) to
   pdv text under build/, to_ensemble().run_quantized(128) bit-equal to the
   hand-built ensemble's and to_ensemble().run(16) to its run(16) (the
   sampler launched twice), and export_ensemble(256) supervised with one
   writer, its journal's sha256 equal to phase 9's clean run and the fused
   kernel launched exactly twice.  Step times (CUDA events) of a first and
   a second run on the card (bit-equal), peak device memory and obs/s are
   logged;
11. the Monte-Carlo study (psrsigsim_torch.mc) on the card: (a) the JAX
   bench's MC geometry (bench.py build_mc_study: 64 channels, 512 bins,
   8 x 2 s subints, dm ~ Uniform(10, 20), noise_scale ~ LogUniform(0.5, 2),
   seed 1), run(512, chunk_size=256) with the sampler launched exactly 4
   times (two fields per chunk) and nothing else; a steady second run
   (trials/s, bit-equal), one chunk's device time (CUDA events and the
   profiler's busy time by kernel) and peak memory; chunk sizes 32, 128,
   256 and 512 under build/ with equal summaries, artifact fingerprints
   and rows; `python -m psrsigsim_torch.mc` (its main, in process) on a
   spec file of the same study, on its default device, with the same
   fingerprint; trials 0-31 against a device="cpu" study (parameters bit for
   bit; rows within the FFTFIT tolerance of a PSS_SAMPLER=hw host run); a
   child `python3 chip_smoke.py --mc-kill-child OUT SCRATCH` SIGKILLed by
   mc.kill after chunk 0's commit, then a resume byte-identical to the
   clean run; integrity=True with a host.corrupt on the second chunk,
   healed to the clean artifact; (b) Simulation(psrdict=...) at BASELINE
   config 1's full width: run_mc_study(256, chunk_size=128) (the sampler
   exactly 4 times, trials/s, peak memory), FoldEnsemble.to_mc_study's
   trials 0-31 equal to its rows, then export_psrfits(256)
   supervised with one writer (the fused kernel exactly twice), every
   file's sha256 equal to supervised_export of the facade's ensemble with
   the study's DMs and float32 noise norms;
12. the scenario engine on the card (psrsigsim_torch.scenarios), BASELINE
   config 1 at full width with the stack scintillation + rfi +
   single_pulse:lognormal and per-observation parameter arrays: (a)
   run_quantized(128) through the fused kernel with the scenario's per-row
   factors (one launch), bit-equal to the unfused scenario path on the card
   (sampler fields + the PyTorch body + quantizer) for each single-pulse
   mode and for rfi alone, and on an edge shape that takes the general
   kernel; observations 0-7's codes bit-identical at batch widths 1, 8, 37
   and 128; observations 0-7 against device="cpu" (codes within 1 LSB on
   at most 1%, the truth mask exact); the fused kernel's time with and
   without
   the factors (in turns) against their bounds, and the host's time to draw
   one chunk's factors; (b) supervised_export(256, chunk_size=128,
   writers=1): the files hold run_quantized's bytes, the journal's rfi
   records and the manifest's rfi block equal the host's truth masks, and a
   resume="verify" after deleting two files launches the fused kernel once;
   (c) Simulation.to_ensemble(scenario=...).run_quantized(128) launches the
   fused kernel exactly once and equals (a); (d) a Monte-Carlo study with
   scint_mod and sp_sigma priors on the bench MC geometry, 512 trials in
   256-trial chunks: the sampler exactly 4 times, rows bit-identical for
   chunk sizes 128 and 256, trials 0-31 against device="cpu" within the
   FFTFIT tolerance;
13. SEARCH mode at BASELINE config 4's full width (bench.py
   build_single_workload: 64 channels x 819,200 samples, 2048 a pulse, 400
   pulses of which 80 nulled, DM 15.9), 16 observations a batch: (a) the
   sampler's flat layout against its plain version, bit for bit, on a full
   config-4 field, an unaligned start and a length that is not a whole
   tile, in every mode; (b) single_pipeline(16) launching the flat layout
   exactly twice and the rows layout once (the nulled pulses' replacement
   row), channel means, obs/s, Gsamples/s, peak memory, device time by
   kernel; (c) observations 0-1 against device="cpu" (PSS_SAMPLER=hw),
   scenario-free and with scintillation + rfi + lognormal, within rtol
   1e-5 plus 1e-5 of the peak; (d) the same
   observations in a batch of 2, bit-equal; (e) the exact full-stream
   shift on 2 observations; (f) the flat layout's time against its bound;
14. the dataset factory (psrsigsim_torch.datasets) on the card at bench.py's
   _DATASET_BENCH_SPEC (512 records of 4 x 20,480, rfi + single_pulse, dm
   and rfi_imp_snr priors, 4 shards) under build/, deleted afterwards: (a)
   64-record chunks twice and 37-record chunks, shards byte-identical, the
   flat layout launched exactly twice a chunk, records/s and the stage
   timers; (b) a child `python3 chip_smoke.py --dataset-kill-child OUT
   SCRATCH` SIGKILLed by dataset.kill after chunk 128's commit, resumed
   with 37-record chunks, byte-identical; (c) integrity=1.0 healing a
   host.corrupt and a device.sdc, and a disk.bitrot found by
   scrub_dataset_dir and healed by a resume, byte-identical; (d) records
   0-3 against device="cpu" (labels byte-equal, tiles within rtol 1e-5
   plus 1e-5 of the peak) and a reader's epoch; (e) 8 records at config
   4's geometry with every effect.

15. baseband at BASELINE config 3's full width (bench.py
   build_baseband_workload: BasebandSignal(1400, 100, sample_rate=200), 2
   polarizations x 4,000,000 samples, DM 13.3, the overlap-save plan of one
   2^23-point block; the bench telescope's amplitude noise), 8 observations
   a batch: (a) the sampler's flat layout in normal mode against its plain
   version, bit for bit, at 8 x 8,000,000, and its time; (b)
   baseband_pipeline(8) launching the flat layout exactly twice and the
   rows layout never, mean power, obs/s, Msamples/s, peak memory, device
   time by kernel class (draws, FFTs, the rest); (c) observations 0-1
   against device="cpu" (PSS_SAMPLER=hw) within rtol 1e-5 plus 1e-5 of the
   peak; (d) the same observations in a batch of 2, bit-equal; (e)
   exact_fft=True (the monolithic 4,000,000-point transforms) on 2
   observations, timed beside the plan and against the host; (f) the
   object-oriented flow BasebandSignal -> make_pulses -> disperse(13.3)
   -> radiometer_noise -> to_FilterBank(512), card against host (the
   pulses bit-equal, every later step within the same bound), step times;
16. the multi-pulsar ensemble at BASELINE config 5 (bench.py
   time_tpu_multipulsar: 128 distinct periods from numpy seed 0, 64
   channels, 2 x 0.5 s subints, padded to 1024/2048/4096 bins): (a) the
   sampler's rows layout in chi2_sel mode with per-row dfs against its
   plain version, bit for bit, at the biggest bucket's shape, and its
   time; (b) MultiPulsarFoldEnsemble.run(8) with epoch_chunk=2 launching
   the sampler exactly 2 x buckets x 4 times, channel means,
   pulsar-epochs/s, peak memory; (c) run(4) + run(4, epoch_start=4) and
   epoch_chunk=4 bit-equal to run(8); (d) 4 pulsars x 2 epochs against
   device="cpu" within the fold bound; (e) one pulsar alone bit-equal to
   its rows in the full run;
17. the serving core (psrsigsim_torch.serve) on the card, with a serve spec
   at BASELINE config 1's width (64 channels, 2048 bins, 20 x 60 s subints,
   DM 15.9 with per-request offsets) and bucket widths 1, 8 and 32: (a) the
   sampler's rows layout at the w32 serve shape on the requests' keys
   against its plain version, bit for bit, and its time; (b) exactly 2
   sampler launches per bucket execution and no other kernel, while 64
   concurrent requests are served; (c) one request solo, coalesced into
   w8, in a w32 batch and in a 5-request batch padded to 8, bit-equal, and
   its channel means; (d) PSS_SAMPLER=threefry, the card against
   device="cpu" within the fold bound; (e) serial w1 and 64-concurrent
   requests/s, cache hits/s from a fresh service over the same cache dir
   (no device call), request p50/p95/p99, the stage times and bottleneck,
   the device's busy share and peak memory; (f) `python -m
   psrsigsim_torch.serve --port 0` on the card answering 3 POST /simulate
   and GET /result, /metrics and /healthz, then draining on SIGTERM; (g)
   integrity=1.0 with a device.sdc fault, healed to the clean bytes.  Every
   request must reach done;
18. the serving fleet (psrsigsim_torch.serve.ReplicaFleet behind a
   FleetRouter) on the card: `python -m psrsigsim_torch.serve` replica
   processes sharing the one card and one cache dir under build/ (deleted
   afterwards), with phase 17's spec at full width and bucket widths 1, 8
   and 32, every profile bit-equal to an in-process service on the card:
   (a) two replicas serve 64 distinct requests from 8 client threads;
   each replica's /healthz gives its bucket executions, its builds (at
   most one per geometry and width) and its kernel launches (the
   sampler's exactly 2 a bucket execution, no other kernel), and the
   router its share of requests; (b) replica.kill SIGKILLs the routed
   replica after 8 requests of 32: the router fails over with the
   remaining deadline, the supervisor restarts the replica on the card
   (time from the kill to its ready line), every request bit-equal, and a
   verify re-hash of the drained cache finds no lost or torn commit; (c)
   the same 64-request stream from 4 client threads through one replica
   and through two, each over a fresh cache: req/s, p50/p99, the ratio,
   and the card's busy share over each burst (nvidia-smi's utilization,
   sampled every 100 ms, since the work runs in other processes); (d) an
   autoscaled fleet (1 to 2 replicas): a burst scales it up, an idle
   window retires the new replica through a SIGTERM drain, every request
   done and bit-equal, nothing lost;
19. the exact-gamma chi^2 branch: (a) the exact-gamma kernel against its
   plain version (ops/stats.py::gamma_plain) on the card, bit for bit, on
   a whole 128-observation chunk's (observation, channel, block) keys at
   alpha 0.5, 10, 20 and 6000, and on shape-level draws (one key, 64 x
   40960) at a traced alpha 10 and 0.5 and a static 0.3; (b) the card's
   plain version against the host's on one observation's field, bit for
   bit; (c) mean, variance and the KS statistic of 1e7 draws against
   chi^2(df) for df 1, 20 and 40; (d) BASELINE config 1's width in 0.1 s
   subints (Nfold 20), on the unfused route: run_quantized(128) with the
   kernel launched exactly twice and nothing else, obs/s, the codes of
   chunk sizes 64 and 128 equal, a profiled chunk, then iter_chunks ->
   export of 256 observations with writers=1 (4 launches), obs/s; (e)
   config 1 itself under PSS_EXACT_CHI2=1: run_quantized(128), 2 launches,
   obs/s; (f) make_pulses -> disperse -> observe(noise) at Nfold 20 on the
   card and the host (pulses bit-equal, observed data within 2e-5 of the
   peak, 2 launches); (g) SEARCH under the hatch at BASELINE config 4's
   geometry, a batch of 4 (3 launches, channel means within 2%); (h) the
   kernel's time at the main path's shape (one chunk's field) against its
   bound at the issue limit, its plain version's time, and
   torch._standard_gamma's at the same shape;
20. meshes and sequence sharding (psrsigsim_torch.parallel: make_mesh,
   make_seq_mesh, make_obs_seq_mesh), every mesh built from repeated cuda:0
   positions, so the shards run one after another on the one card: what
   the sharding costs, not a speed-up.  (a) seq_sharded_search at BASELINE
   config 4 (64 x 819,200, 20% nulled, DM 15.9) over n = 1, 2, 4, 8 and 16
   shards (16: 51,200-sample slabs, not whole RNG blocks), in envelope and
   fft mode: the envelope mode bit-equal to single_pipeline for every n,
   the fft mode (two all_to_all transposes around the shift) bit-equal or
   within 1e-5 of the stream's l2 (logged which); the sampler's flat layout
   launched twice a shard and its rows layout once, ms per n; (b)
   seq_sharded_search_ensemble with 16 observations on (obs, seq) meshes
   (1, 1), (2, 2), (4, 1) and (1, 4), bit-equal to single_pipeline(16),
   obs/s beside phase 13's; (c) BASELINE config 3 (2 x 4,000,000, DM 13.3):
   each slab's normals equal baseband_pipeline's flat stream,
   seq_sharded_baseband and seq_sharded_dedisperse at n = 1 (the full
   circular filter) and n = 2 with a 1,048,576-sample halo (a 2^22 block),
   the truncation error of n = 2 against n = 1 logged, and n = 2 against
   the same call on the host (PSS_SAMPLER=hw) within rtol 1e-5 plus 1e-5
   of the peak; (d) BASELINE config 1: FoldEnsemble over (obs, chan) meshes
   (1, 1), (2, 1), (1, 2), (2, 2) and (1, 8), run_quantized(128)'s codes,
   DAT_SCL and DAT_OFFS and run(16)'s floats bit-equal to the mesh-free
   run, the fused kernel launched exactly once a position, and a
   256-observation export (one writer) on (2, 2) byte-identical to the
   mesh-free one; (e) the bench MC study on (4, 1), config 5's 128 pulsars
   x 2 epochs on (2, 2) and a 128-record corpus on (2, 1), each
   bit-identical to its mesh-free run, and (a) under PSS_EXACT_CHI2=1 at
   n = 1 and 2 (the exact-gamma kernel three times a shard), bit-equal;
   (f) a (1, 16) mesh, 4 channels a chan shard, raises the 8-channel-group
   rule;
21. pods (psrsigsim_torch.runtime.dist, psrsigsim_torch/tools/pod_runner.py):
   two processes on the one card, each on cuda:0, one mesh position a
   process ((obs 2, chan 1)), the channel fetch (PSS_POD_FETCH=channel), a
   timeout on every process: (a) run_quantized(128) and run(16) at BASELINE
   config 1's width on the pod, bit-equal to the one-process (2, 1) mesh
   and to the mesh-free run, the fused kernel launched once a rank and the
   sampler twice a rank, each held against its plain version at a rank's
   shapes; obs/s and the channel exchange's ms and bytes a chunk; (b) a
   256-observation supervised export in 64-observation chunks led by the
   leader and mirrored by pod_export_follower, pod.kill SIGKILLing the
   follower after its second chunk: the leader exits 73 within
   POD_KILL_BOUND_S with chunk 0 committed, a fresh pod resumes with
   resume="verify" launching the fused kernel for the missing chunks
   only, and the files equal phase 9's clean export; (c)
   ReplicaFleet(group_hosts=2) serving 64 requests bit-equal to an
   in-process service (req/s, p50, p99), the
   leader's /healthz launches 2 a bucket execution, a follower SIGKILL
   taking the leader down with exit 73 and the supervisor restarting the
   group, every request then served again from the cache (no lost commit);
   (d) the bench MC study and a 128-record corpus on the pod, bit-identical
   to their one-process runs.  No pod process builds a kernel (the build
   directory's files do not change);
22. the linter and its probe on the card (psrsigsim_torch.analysis):
   ``python -m psrsigsim_torch.analysis`` exits 0 on the port's tree
   against its own baseline; every public ops symbol runs through its
   probe on the card, the steady-state call under
   torch.cuda.set_sync_debug_mode("error") (or listed in
   trace_check.SYNCS with its reason; six exempt as host helpers), then
   the serving buckets (widths 1 and 8), the dataset record chunk and the
   main path's steady ``run_quantized(128)`` at config 1's full width; the
   probe must launch K1' in both layouts, K3' and K4; the counts probed,
   syncing by design and exempt, the launches and the seconds are logged;
23. the 12 tutorials of docs/torch/ on the card through the CPU test's
   runner (psrsigsim_torch/tools/tutorials.py): every block in order, in
   one namespace a tutorial with DEVICE = "cuda", from a scratch
   directory under build/ (deleted afterwards), with its
   numeric-RuntimeWarning gate; each tutorial's seconds and its launches
   of K1' (rows and flat), K3', K4 and K9 logged.  A failing block fails
   the phase.

The line before the last is one JSON object with each kernel's launches
(counted in the main path's run: phases 5, 13 and 19; every path's
count under ``launches_by_path``: phases 5, 9, 13, 15, 16, 17, 18, 19,
20, 21, 22 and 23, the fleet's read from its replicas' /healthz, the
pod's a rank, each tutorial's under its number), error against
its plain version, times and bound.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of one
steady main-path chunk after phase 5 (device time by kernel, busy share).

Exits non-zero, with no result line, if there is no CUDA device, if the
port is missing, or if any phase fails.  The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores, which counts an FMA as two
# operations (132 SMs x 128 lanes x 2 x 1.98 GHz)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Issue rates per instruction class, per SM per clock on compute capability
# 9.0 (CUDA C++ programming guide, arithmetic instruction throughput), at
# the same 132 SMs and 1.98 GHz: float32 add/multiply 128; 32-bit integer
# multiply, add, logic and shift, and compare/min/max 64; special functions
# and type conversions 16.
SMS, CLOCK_HZ = 132, 1.98e9
RATES = {"int32": 64 * SMS * CLOCK_HZ, "fp32": 128 * SMS * CLOCK_HZ,
         "sfu": 16 * SMS * CLOCK_HZ}
# the issue limit: each of an SM's 4 schedulers issues one warp instruction
# a clock, 128 thread-operations of any class.  ptxas moves integer adds
# onto the FMA pipe (IMAD), so a mix of integer work can beat the integer
# pipe's 64 but never this; phase 19 bounds K9's integer-heavy mix by it
ISSUE_RATE = 128 * SMS * CLOCK_HZ

# Operations per output sample, by class, that the function itself needs,
# counted as ptxas emits them from the sources (csrc/philox_field.cuh,
# rng_field.cu, fold_quantize.cu), without this implementation's index
# arithmetic, bounds checks or packing.  One Philox4x32-10 call makes four
# samples: 10 rounds of 2 low and 2 high 32x32 multiplies and 2 three-input
# XORs (one LOP3 each), plus 9 key bumps of 2 adds (78 integer), and 4 mask
# ANDs; two Box-Muller pairs of 7 float32 add/mul each, and per sample the
# Wilson-Hilferty map (2 add/mul for t, 3 multiplies, 1 max: 6); per pair
# log, sqrt, sin and cos and 2 int->float conversions (6 special).  The
# accurate libm routines expand into more float work than one special op
# each, so the bound is a lower one.
PHILOX_INT_OPS = 78 + 4
DRAW_OPS = {"int32": PHILOX_INT_OPS / 4, "fp32": (2 * 7) / 4 + 6,
            "sfu": (2 * 6) / 4}
# the fused kernel: two draws per sample, the fold (2 multiplies, 1 add),
# min, max and isfinite (3 compares), the quantizer (subtract and
# multiply; clamp 2 compares; rint and float->int conversions)
FUSED_OPS = {"int32": 2 * DRAW_OPS["int32"] + 3 + 2,
             "fp32": 2 * DRAW_OPS["fp32"] + 3 + 2,
             "sfu": 2 * DRAW_OPS["sfu"] + 2}
# the fused kernel with every scenario factor: the gain and energy
# multiplies and the RFI level's add, one float32 operation each
SCEN_OPS = dict(FUSED_OPS, fp32=FUSED_OPS["fp32"] + 3)
# the sampler's flat layout in chi2_1 mode (SEARCH mode): the draw and one
# multiply for z^2 instead of the Wilson-Hilferty map
FLAT_OPS = {"int32": PHILOX_INT_OPS / 4, "fp32": (2 * 7) / 4 + 1,
            "sfu": (2 * 6) / 4}
# the sampler's flat layout in normal mode (baseband): the draw alone
NORMAL_OPS = {"int32": PHILOX_INT_OPS / 4, "fp32": (2 * 7) / 4,
              "sfu": (2 * 6) / 4}
# the packed digest, per 32-bit word: the XOR, the term's multiply-add and
# the add into the sum (the position multipliers depend on the position
# only, shared by every observation of a chunk)
DIGEST_OPS = {"int32": 3}
# the single-rate count of the first sampler design (one Philox call per
# sample, every operation at the float32 FMA rate), kept for continuity
RNG_OPS_PER_SAMPLE_ONE_CALL = 98 + 7 + 6 + 6

MAIN_NOBS = 128
FLOAT_NOBS = 16  # FoldEnsemble.run's float blocks: 16 x 64 x 40960 x 4 bytes
EXPORT_NOBS = 256  # phase 8: two chunks, ~1.34 GB of PSRFITS one per file
EXPORT_SERIAL_NOBS = 32
EXPORT_OPF = 16
SUP_NOBS = 256  # phase 9: two chunks of the supervised export
OO_SEARCH_TOBS = 2.0  # phase 10(b): 64 x 409600 samples, 105 MB per field
KILL_CHILD = "--supervised-kill-child"
MC_KILL_CHILD = "--mc-kill-child"
MC_TRIALS, MC_CHUNK = 512, 256  # phase 11(a): two chunks
MC_FACADE_TRIALS, MC_FACADE_CHUNK = 256, 128  # phase 11(b): two chunks
SCEN_STACK = ["scintillation", "rfi", "single_pulse:lognormal"]  # phase 12
SCEN_SUP_NOBS = 256  # phase 12(b): two chunks of the supervised export
SCEN_HOST_NOBS = 8  # phase 12(a): observations held against the host
BATCH_WIDTHS = (1, 8, 37, MAIN_NOBS)  # phases 5, 12: widths of obs 0-7
DATASET_KILL_CHILD = "--dataset-kill-child"
# phase 13: BASELINE config 4 (bench.py build_single_workload: 64 channels
# at 0.4096 MHz, P = 5 ms, Gaussian profile of width 0.05, 2 s, 20% of the
# pulses nulled, DM 15.9), 16 observations a batch
CONFIG4 = dict(nchan=64, samprate_mhz=0.4096, period_s=0.005, smean=0.05,
               tobs_s=2.0, fcent=1380.0, bw=400.0, null_frac=0.2, dm=15.9)
SEARCH_NOBS = 16
SEARCH_HOST_NOBS = 2  # phase 13(c): observations 0-1 on the host too
# phase 15: BASELINE config 3 (bench.py build_baseband_workload:
# BasebandSignal(1400, 100, sample_rate=200), P = 5 ms, 20 ms, DM 13.3),
# with the bench telescope's amplitude noise, 8 observations a batch
CONFIG3 = dict(fcent=1400.0, bw=100.0, samprate_mhz=200.0, period_s=0.005,
               smean=0.05, tobs_s=0.02, dm=13.3)
BASEBAND_NOBS = 8
BASEBAND_HOST_NOBS = 2  # phase 15(c), (e): observations 0-1 on the host too
OO_BASEBAND_NSUB = 512  # phase 15(f): to_FilterBank(512)
# phase 16: BASELINE config 5 for real (bench.py time_tpu_multipulsar: 128
# pulsars, seed 0, pad grid [1024, 2048, 4096]), 8 epochs in chunks of 2
MULTI_PULSARS, MULTI_EPOCHS, MULTI_EPOCH_CHUNK = 128, 8, 2
MULTI_PAD = [1024, 2048, 4096]
MULTI_HOST = 4  # phase 16(d): pulsars held against the host, 2 epochs
# phase 17: a serve spec at BASELINE config 1's width (64 channels, 2048
# bins, 20 x 60 s subints), DM 15.9 with per-request offsets
SERVE_SPEC = {"nchan": 64, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
              "sample_rate_mhz": 0.4096, "sublen_s": 60.0, "tobs_s": 1200.0,
              "period_s": 0.005, "smean_jy": 0.009, "seed": 0, "dm": 15.9}
SERVE_WIDTHS = (1, 8, 32)
SERVE_SERIAL, SERVE_BURST = 16, 64  # phase 17(e)
# phase 18: request streams (serve_spec indices) for each leg of the fleet
FLEET_STREAMS = {"c": range(3000, 3064), "a": range(4000, 4064),
                 "b": range(5000, 5032), "d": range(6000, 6108)}
FLEET_CLIENTS_A, FLEET_CLIENTS_C, FLEET_KILL_AFTER = 8, 4, 8
FLEET_DEADLINE_S = 300.0
# phase 18's routers: no latency ejection.  A blocking submit's latency
# includes the replica's queue wait, so the router's outlier check reads a
# busy replica as a slow one (the router's own docstring says so), and
# with its peer SIGKILLed the dead peer's stale EWMA is the baseline: on
# the card the survivor of (b) was ejected and a request failed with no
# routable replica.  The error breaker stays on.
FLEET_ROUTER = {"breaker_min_latency_s": 1e9}
# phase 14: bench.py _DATASET_BENCH_SPEC (config 12: 4 channels, 20 pulses
# of 1024 samples, rfi + single_pulse, dm and rfi_imp_snr priors)
DATASET_SPEC = {
    "nchan": 4, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.2048, "tobs_s": 0.1, "period_s": 0.005,
    "smean_jy": 0.05, "seed": 3, "n_records": 512, "shards": 4,
    "dm": 10.0, "scenarios": ["rfi", "single_pulse"],
    "rfi_imp_prob": 0.25, "rfi_nb_prob": 0.25,
    "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 20.0},
               "rfi_imp_snr": {"dist": "loguniform", "lo": 1.0,
                               "hi": 50.0}},
}
DATASET_CHUNKS = (64, 37)
# phase 14(e): a few records at config 4's geometry with every effect
DATASET_CONFIG4 = {
    "nchan": 64, "fcent_mhz": 1380.0, "bw_mhz": 400.0,
    "sample_rate_mhz": 0.4096, "tobs_s": 2.0, "period_s": 0.005,
    "smean_jy": 0.05, "seed": 4, "n_records": 8, "shards": 2, "dm": 15.9,
    "scenarios": ["scintillation", "rfi", "single_pulse"],
    "priors": {"dm": {"dist": "uniform", "lo": 5.0, "hi": 30.0}},
}
MC_PRIORS = {"dm": {"dist": "uniform", "lo": 10.0, "hi": 20.0},
             "noise_scale": {"dist": "loguniform", "lo": 0.5, "hi": 2.0}}
# bench.py build_mc_study: the export-bench fold geometry (Gaussian
# portrait, 64 channels, 512 bins, 8 x 2 s subints) under MC_PRIORS
MC_BENCH = dict(fcent=1380.0, bandwidth=400.0, sample_rate=0.1024, Nchan=64,
                sublen=2.0, fold=True, period=0.005, Smean=0.009,
                profiles=[0.5, 0.05, 1.0], tobs=16.0, name="BENCH", dm=15.9,
                aperture=100.0, area=5500.0, Tsys=35.0,
                tscope_name="TestScope", system_name="TestSys",
                rcvr_fcent=1380.0, rcvr_bw=400.0, rcvr_name="TestRCVR",
                backend_samprate=12.5, backend_name="TestBack", seed=0)
# phase 19: the exact-gamma branch.  BASELINE config 1's width (64
# channels, 2048 bins, 20 subints) in 0.1 s subints: Nfold 20
GAMMA_ALPHAS = (0.5, 10.0, 20.0, 6000.0)  # (a): K9 against its plain version
GAMMA_PLAIN_ROWS = 8192  # (a): rows of the plain version per comparison
GAMMA_STAT_N = 10**7     # (c): draws per df
GAMMA_STAT_DFS = (1.0, 20.0, 40.0)
GAMMA_EXPORT_NOBS = 256  # (d): iter_chunks -> PSRFITS export, writers=1
GAMMA_SEARCH_NOBS = 4    # (g): SEARCH under the hatch at config 4's geometry
# threefry2x32's integer operations a call (csrc/threefry.cuh: 20 rounds of
# add, rotate, XOR; 5 key injections of 2 adds; the key-schedule XOR)
THREEFRY_INT_OPS = 73
# K9's float32 operations, counted from csrc/gamma_field.cu: an inner pass
# draws a normal (the uniform 3; log1p's small branch 20: 12 FMAs, the
# division as one, 7 more; erf_inv's 8 FMAs, 8 coefficient selects and 7
# more) and v = fma(x, c, 1) with its test: 48; an outer pass forms X, V
# and U (5), the squeeze bound and its test (3), two XLA logs (26 each) and
# the log test (7): 67 (the division's and the selects' expansions are not
# counted, so the bound is a lower one)
GAMMA_FP32_INNER, GAMMA_FP32_OUTER = 48, 67
# phase 20: meshes of repeated cuda:0 positions.  (a) seq_sharded_search at
# config 4 over n shards (16: 51,200-sample slabs, not whole RNG blocks);
# (b) 16 observations over (obs, seq) meshes; (c) config 3 at n = 2 with a
# halo that fits its 2,000,000-sample slab (block 2^22); (d) config 1 over
# (obs, chan) meshes; (e) the study, config 5 and a corpus
SEQ_NS = (1, 2, 4, 8, 16)
SEQ_ENS_NOBS = 16
SEQ_ENS_SHAPES = ((1, 1), (2, 2), (4, 1), (1, 4))
BASEBAND_HALO = 1_048_576
FOLD_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 8))
MESH_MC_TRIALS = 256
MESH_DATASET_SPEC = dict(DATASET_SPEC, n_records=128)
# phase 21: a 2-process pod on the one card
POD_PROCS = 2
POD_TIMEOUT_S = 240.0      # every pod process
POD_KILL_BOUND_S = 30.0    # (b): the follower's death to the leader's exit
POD_EXPORT_CHUNK = MAIN_NOBS // 2  # (b): four chunks of phase 9's export
POD_THREADS = 4            # each rank's host threads (8 cores, 2 ranks)
POD_SERVE = range(7000, 7064)  # (c): serve_spec indices of the burst
POD_SERVE_CLIENTS = 4
TEMPLATE = os.path.join(ROOT, "data", "B1855+09.L-wide.PUPPI.11y.x.sum.sm")
MAIN = dict(nchan=64, period_s=0.005, samprate_mhz=0.4096, sublen_s=60.0,
            tobs_s=1200.0, fcent=1380.0, bw=400.0, smean=0.009, dm=15.9)
GAMMA_MAIN = dict(MAIN, sublen_s=0.1, tobs_s=2.0)
PARITY = dict(nchan=16, period_s=0.005, samprate_mhz=0.0512, sublen_s=60.0,
              tobs_s=240.0, fcent=1380.0, bw=400.0, smean=0.009, dm=15.9)


def log(msg):
    print(msg, flush=True)


def serve_spec(i):
    """Phase 17's i-th request: its own seed and a DM offset."""
    return dict(SERVE_SPEC, seed=1000 + i, dm=15.9 + 0.01 * (i % 97))


def scenario_params(n, stack=SCEN_STACK, seed=12):
    """Per-observation parameters of ``stack`` for ``n`` observations, made
    from a seed with numpy (phase 12)."""
    import numpy as np

    from psrsigsim_torch.scenarios import parse_stack

    r = np.random.default_rng(seed)
    f32 = np.float32
    every = {"scint_dnu_d_mhz": r.uniform(5.0, 100.0, n).astype(f32),
             "scint_dt_d_s": r.uniform(20.0, 200.0, n).astype(f32),
             "scint_mod": r.uniform(0.3, 1.0, n).astype(f32),
             "rfi_imp_prob": r.uniform(0.0, 0.3, n).astype(f32),
             "rfi_imp_snr": r.uniform(1.0, 10.0, n).astype(f32),
             "rfi_nb_prob": 0.1,
             "rfi_nb_snr": r.uniform(1.0, 5.0, n).astype(f32),
             "sp_sigma": r.uniform(0.1, 1.0, n).astype(f32),
             "sp_alpha": r.uniform(1.5, 4.0, n).astype(f32),
             "sp_amp": r.uniform(2.0, 20.0, n).astype(f32)}
    names = parse_stack(stack).param_names()
    return {k: v for k, v in every.items() if k in names}


def geometry(g, device, scenario=None, mesh=None):
    """BASELINE config 1's objects (bench.py config1_fold64 with the J1713
    template and the TestScope/TestSys telescope), at the widths of ``g``,
    with an optional scenario stack, on ``device`` or over ``mesh``."""
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
    if mesh is not None:
        return FoldEnsemble(sig, psr, tel, "TestSys", scenario=scenario,
                            mesh=mesh)
    return FoldEnsemble(sig, psr, tel, "TestSys", device=device,
                        scenario=scenario)


def main_psrdict():
    """BASELINE config 1's ``Simulation`` psrdict (phases 10(c), 11(b))."""
    import numpy as np

    from psrsigsim_torch.data import data_path

    g = MAIN
    return dict(
        fcent=g["fcent"], bandwidth=g["bw"], sample_rate=g["samprate_mhz"],
        Nchan=g["nchan"], fold=True, sublen=g["sublen_s"], tobs=g["tobs_s"],
        period=g["period_s"], Smean=g["smean"], name="J1713+0747",
        profiles=np.load(data_path("J1713+0747_profile.npy")), dm=g["dm"],
        tscope_name="TestScope", aperture=100.0, area=5500.0, Tsys=35.0,
        system_name="TestSys", rcvr_fcent=g["fcent"], rcvr_bw=g["bw"],
        rcvr_name="TestRCVR", backend_samprate=12.5,
        backend_name="TestBack", seed=0, tempfile=TEMPLATE)


def device_profile(torch, fn):
    """Run ``fn`` once under torch.profiler: ``(wall_s, busy_us, events,
    by_name, prof)`` with the device's busy time (the union of its kernel
    and copy intervals) and device time by event name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return wall, busy, len(spans), by_name, prof


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


def bound(ops, n, nbytes):
    """The least time the card could take for ``n`` samples of ``ops``
    operations per sample by class, moving ``nbytes``: ``(bound_ms,
    bound_by, parts)``, ``parts`` holding each class's time, the bytes'
    time, and the single-rate figure (every operation at the float32 FMA
    rate) for continuity with earlier records."""
    parts = {c: ops[c] * n / RATES[c] * 1e3 for c in ops}
    t_ops = max(parts.values())
    parts["bytes"] = nbytes / PEAK_BYTES_PER_S * 1e3
    parts["single_rate"] = sum(ops.values()) * n / PEAK_OPS_PER_S * 1e3
    by = "bytes" if parts["bytes"] >= t_ops else "operations"
    return max(t_ops, parts["bytes"]), by, parts


def host_cpu():
    """The host's CPU (the CPU reference of phase 6 runs there): its
    architecture, model where /proc/cpuinfo names one, and core count."""
    import platform

    model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    model = " " + line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()}{model}, {os.cpu_count()} cores"


def ptxas_summary(build_log):
    """One line per kernel entry from nvcc's ``-Xptxas -v`` output: its
    registers, stack frame and spills."""
    import re

    out, name, frame = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append(f"{name}: {m.group(1)} registers, {frame}")
            name = None
    return out


def fmt_parts(parts):
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items())


class GpuBusy:
    """The card's busy share while a block runs, whichever process
    launches the work: nvidia-smi's utilization.gpu (the share of each
    sample period in which a kernel ran) sampled every 100 ms and
    averaged."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        self.n = len(vals)
        self.share = sum(vals) / len(vals) / 100 if vals else float("nan")
        return False


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed = []
        self.kernels = {"rng_field": {}, "rng_flat_field": {},
                        "fold_quantize": {}, "packed_digest": {},
                        "gamma_field": {}}
        self._main = None
        self.export_rates = {}  # phase 8's obs/s, beside phase 9's
        self.sup_clean = None  # phase 9's clean 1-writer sha256s and obs/s

    def main_ensemble(self):
        """The main path's ensemble (staged once, on the card)."""
        if self._main is None:
            self._main = geometry(MAIN, self.dev)
        return self._main

    def main_fused_args(self, nobs=MAIN_NOBS):
        """The fused kernel's arguments on the main path for observations
        0..nobs-1 of seed 0, from the pipeline's own front half; and the
        chunk's (keys, dms, norms)."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import stats
        from psrsigsim_torch.ops.rng_hw import seed_words
        from psrsigsim_torch.simulate import pipeline

        ens = self.main_ensemble()
        cfg = ens.cfg
        chunk = ens._prep_chunk(np.arange(nobs), 0, None, None)
        f = pipeline._fold_front(*chunk, ens._profiles, cfg, ens._freqs,
                                 ens._chan_ids, None, None)
        args = dict(
            seeds=seed_words(torch.stack([f.kp, f.kn])).to(self.dev).contiguous(),
            dfs=torch.tensor([[cfg.nfold] * nobs, [cfg.noise_df] * nobs],
                             dtype=torch.float32, device=self.dev),
            modes=(stats._hw_chi2_mode(cfg.nfold),
                   stats._hw_chi2_mode(cfg.noise_df)),
            prof=f.prof.contiguous(), noise_norm=f.noise_norm.contiguous())
        return args, dict(nsub=cfg.nsub, draw_norm=cfg.draw_norm), chunk

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
            f"count {torch.cuda.device_count()}; host {host_cpu()}")

    # -- 2 ------------------------------------------------------------------
    def build(self):
        from psrsigsim_torch.ops import _build

        t0 = time.perf_counter()
        libs = _build.build_all()
        log(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s "
            "(one nvcc each, in parallel)")
        for name, lib in libs.items():
            for line in ptxas_summary(lib.build_log):
                log(f"  {name}: {line}")

    # -- 3 ------------------------------------------------------------------
    def kernel_vs_plain(self):
        torch = self.torch
        from psrsigsim_torch.ops import rng_hw, stats
        from psrsigsim_torch.utils import fold_in, key

        keys = fold_in(key(1, self.dev), torch.arange(3, device=self.dev))
        seeds = rng_hw.seed_words(keys)
        pos = torch.tensor([[1, 2]] * 3, dtype=torch.int32, device=self.dev)
        worst = 0.0
        cases = [("normal", 0.0), ("chi2_1", 0.0), ("chi2_wh", 12000.0),
                 ("chi2_sel", 12000.0), ("chi2_sel", 1.0)]
        for mode, df in cases:
            dfs = torch.full((3,), df, device=self.dev)
            errs = []
            # 5000: float4 stores; 4999: a ragged last quad, scalar stores
            for length in (5000, 4999):
                want = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 13, length)
                got = rng_hw.rng_field(seeds, dfs, pos, mode, 13, length)
                err, ok = ulp_close(got, want)
                if not ok:
                    raise AssertionError(f"{mode} length {length}: kernel "
                                         "disagrees with plain version")
                errs.append(err)
            # an unaligned span: overdraw one block and slice, as the
            # pipelines' dispatch does
            span = stats._hw_field_span(keys, torch.arange(8, 21),
                                        dfs, 2 * 4096 + 1234, mode, 5000)
            full = rng_hw.rng_field_plain(seeds, dfs, pos, mode, 13, 3 * 4096)
            err2, ok2 = ulp_close(span, full[..., 1234:6234])
            log(f"  {mode:8s} df={df:<8g} max|kernel-plain| {max(errs):.3g} "
                f"(lengths 5000/4999; unaligned span {err2:.3g})")
            if not ok2:
                raise AssertionError(f"{mode}: unaligned span disagrees")
            worst = max(worst, err2, *errs)

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
            want = rng_hw.rng_field_plain(
                rng_hw.seed_words(k),
                torch.full((MAIN_NOBS,), 12000.0, device=self.dev),
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
        self.kernels["rng_field"]["max_abs_err"] = worst

    # -- 3b -----------------------------------------------------------------
    def fused_vs_plain(self):
        """The fused kernel, its plain version and the unfused path (sampler
        fields + the PyTorch body + quantizer + packing), bit for bit."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.simulate import fold_pipeline_quantized
        from psrsigsim_torch.utils import fold_in, key

        dev = self.dev
        worst = 0

        def unfused(a, nsub, chan0=0, t0=0, **kw):
            """The sampler kernel's fields through the plain version's body
            (fold, quantizer, packing)."""
            B, C, nph = a["prof"].shape
            b0, off = divmod(t0, rng_hw.RNG_BLOCK)
            pos = torch.tensor([[chan0 // rng_hw.CHAN_GROUP, b0]] * B,
                               dtype=torch.int32, device=dev)
            fields = [rng_hw.rng_field(a["seeds"][i].contiguous(),
                                       a["dfs"][i].contiguous(), pos,
                                       a["modes"][i], C,
                                       off + nsub * nph)[..., off:]
                      for i in (0, 1)]
            return fq.fold_quantize_plain(**a, nsub=nsub, chan0=chan0, t0=t0,
                                          fields=fields, **kw)

        def inputs(B, C, nph, modes, dfs, seed):
            r = np.random.default_rng(seed)
            keys = fold_in(key(seed + 17, "cpu"), torch.arange(2 * B))
            d = np.broadcast_to(np.asarray(dfs, np.float32).reshape(2, -1),
                                (2, B))
            return dict(
                seeds=rng_hw.seed_words(keys).reshape(2, B, 2).to(dev).contiguous(),
                dfs=torch.tensor(np.ascontiguousarray(d), device=dev),
                modes=modes,
                prof=torch.tensor(r.normal(0.3, 0.4, (B, C, nph)).astype(np.float32),
                                  device=dev),
                noise_norm=torch.tensor(r.uniform(0.5, 2.0, B).astype(np.float32),
                                        device=dev))

        def compare(label, got, others, skip=None):
            nonlocal worst
            (g, gf) = got
            keep = torch.ones(g.shape[:3], dtype=torch.bool, device=dev)
            if skip is not None:
                keep[skip] = False
            for name, (w, wf) in others.items():
                err = int((g[keep].int() - w[keep].int()).abs().max())
                worst = max(worst, err)
                if not (torch.equal(g[keep], w[keep]) and torch.equal(gf, wf)):
                    raise AssertionError(f"{label}: fused kernel differs from "
                                         f"the {name} (max |diff| {err})")
            log(f"  {label}: bit-equal to {' and '.join(others)}")

        miss = rng_hw.box_muller_selftest(dev)
        log(f"  Box-Muller sequences vs logf/sqrtf/sincosf on all 2^24 words: "
            f"mismatches {miss}")
        if any(miss.values()):
            raise AssertionError("a specialised Box-Muller sequence differs "
                                 "from the CUDA math library")

        sel = ((1.0, 12000.0, 12000.0), (12000.0, 1.0, 12000.0))
        wh = (12000.0, 12000.0)
        # (label, B, C, nph, nsub, modes, dfs, kwargs, route)
        cases = [
            ("13 ch from 8, nph 1000, chi2_sel, little", 3, 13, 1000, 5,
             ("chi2_sel", "chi2_sel"), sel, dict(chan0=8), "staged"),
            ("13 ch from 8, nph 1000, chi2_sel, big, draw_norm 0.37", 3, 13,
             1000, 5, ("chi2_sel", "chi2_sel"), sel,
             dict(chan0=8, draw_norm=0.37, byte_order="big"), "staged"),
            ("16 ch, nph 935 (quads straddle rows)", 2, 16, 935, 3,
             ("chi2_wh", "chi2_wh"), wh, {}, "staged"),
            ("8 ch, nph 8192 (two-pass route), big", 2, 8, 8192, 2,
             ("chi2_wh", "chi2_wh"), wh, dict(byte_order="big"), "two-pass"),
            ("5 ch from 16, nph 700, t0 1234, normal/chi2_1", 1, 5, 700, 3,
             ("normal", "chi2_1"), (0.0, 0.0), dict(chan0=16, t0=1234),
             "staged"),
            ("16 ch, nph 3072 (whole quads, rows cross an RNG block)", 2, 16,
             3072, 3, ("chi2_wh", "chi2_wh"), wh, {}, "staged"),
            ("13 ch from 8, nph 512 from t0 3072 (rows in blocks 0 and 1), "
             "draw_norm 0.37, big", 2, 13, 512, 6, ("chi2_wh", "chi2_wh"), wh,
             dict(chan0=8, t0=3072, draw_norm=0.37, byte_order="big"), "rows"),
            ("16 ch, nph 1024 from t0 3072, per-observation df", 3, 16, 1024,
             3, ("chi2_wh", "chi2_wh"), ((12000.0, 437.6, 900.0), (12000.0,) * 3),
             dict(t0=3072), "rows"),
            ("16 ch, nph 2048, chi2_wh/chi2_1 (off the rows kernel's pair)", 2,
             16, 2048, 2, ("chi2_wh", "chi2_1"), (12000.0, 0.0), {}, "staged"),
        ]
        for i, (label, B, C, nph, nsub, modes, dfs, kw, want) in enumerate(cases):
            how = fq.route(modes, nph, nsub, kw.get("t0", 0))
            if how != want:
                raise AssertionError(f"{label}: route {how}, expected {want}")
            a = inputs(B, C, nph, modes, dfs, seed=i)
            compare(f"{label} [{how}]", fq.fold_quantize(**a, nsub=nsub, **kw),
                    {"plain version": fq.fold_quantize_plain(**a, nsub=nsub, **kw),
                     "unfused path": unfused(a, nsub, **kw)})
        for nph in (1000, 512):
            # a NaN in one row: flagged, and no other row disturbed
            a = inputs(3, 13, nph, ("chi2_wh", "chi2_wh"), wh, seed=9)
            a["prof"][0, 3, 17] = float("nan")
            how = fq.route(a["modes"], nph, 5)
            got = fq.fold_quantize(**a, nsub=5, chan0=8)
            if bool(got[1][0, 3]) or int(got[1].sum()) != 3 * 13 - 1:
                raise AssertionError(f"nph {nph}: the NaN row's finite flag is "
                                     "wrong")
            compare(f"nph {nph}, NaN in obs 0 channel 3 (its 5 rows skipped) "
                    f"[{how}]", got,
                    {"plain version": fq.fold_quantize_plain(**a, nsub=5, chan0=8),
                     "unfused path": unfused(a, 5, chan0=8)},
                    skip=(0, slice(None), 3))
            # a constant row: zero portrait and zero noise scale
            a = inputs(2, 8, nph, ("chi2_wh", "chi2_wh"), wh, seed=10)
            a["prof"][1, 5] = 0.0
            a["noise_norm"][1] = 0.0
            got = fq.fold_quantize(**a, nsub=3)
            row = got[0][1, :, 5].cpu()
            tail = row[:, nph:].contiguous().view(torch.float32)
            if row[:, :nph].any() or not bool((tail[:, 0] == 1.0).all()) \
                    or tail[:, 1].any():
                raise AssertionError(f"nph {nph}: constant row: codes, scl or "
                                     "offs wrong")
            compare(f"nph {nph}, constant row (codes 0, scl 1, offs 0) [{how}]",
                    got, {"plain version": fq.fold_quantize_plain(**a, nsub=3),
                          "unfused path": unfused(a, 3)})

        # the main path at full width: the fused route against the
        # ensemble's unfused body on the sampler kernel's fields
        ens = self.main_ensemble()
        cfg = ens.cfg
        a, kw, (keys, dms, norms) = self.main_fused_args()
        how = fq.route(a["modes"], a["prof"].shape[2], kw["nsub"])
        if how != "rows":
            raise AssertionError(f"the main path takes the {how} route")
        for order in ("little", "big"):
            want = ens._unfused_packed(keys, dms, norms, order)
            got = fold_pipeline_quantized(keys, dms, norms, ens._profiles, cfg,
                                          freqs=ens._freqs,
                                          chan_ids=ens._chan_ids,
                                          byte_order=order)
            compare(f"main path {tuple(got[0].shape)} {order} [{how}]", got,
                    {"unfused path": want,
                     "plain version": fq.fold_quantize_plain(
                         **a, **kw, byte_order=order)})
            del want, got
        self.kernels["fold_quantize"]["max_abs_err"] = float(worst)

    # -- 3c -----------------------------------------------------------------
    def digest_vs_plain(self):
        """The packed-digest kernel against its plain version, bit for
        bit (uint32 digests held as int32)."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import digest
        from psrsigsim_torch.ops import fold_quantize as fq

        dev = self.dev
        worst = 0

        def compare(label, packed, counts):
            nonlocal worst
            for count in counts:
                got = digest.packed_digest(packed, count)
                want = digest.packed_digest_plain(packed, count)
                err = int((got.long() - want.long()).abs().max()) if count else 0
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise AssertionError(f"{label}, count {count}: kernel "
                                         "digests differ from the plain "
                                         "version")
            log(f"  {label} {tuple(packed.shape)}, count {list(counts)}: "
                "bit-equal to the plain version")

        r = np.random.default_rng(3)
        for B, nsub, C, nbin in ((3, 2, 5, 64), (2, 3, 13, 1000),
                                 (3, 2, 4, 13), (2, 5, 7, 935)):
            codes = r.integers(-32768, 32767, (B, nsub, C, nbin + 4),
                               endpoint=True).astype(np.int16)
            codes[0, 0, 0, :4] = (-32768, 32767, -1, 0)
            t = torch.from_numpy(codes).to(dev)
            compare(f"random codes, nbin {nbin}", t, (B, B - 1))
            # the same buffer one int16 off an 8-byte boundary: the kernel
            # takes its 2-byte loads
            buf = torch.empty(t.numel() + 1, dtype=torch.int16, device=dev)
            off = buf[1:].view(t.shape)
            off.copy_(t)
            compare(f"random codes, nbin {nbin}, base not 8-byte aligned",
                    off, (B,))
        # the main path's chunk, as the fused kernel packs it
        a, kw, _ = self.main_fused_args()
        for order in ("little", "big"):
            packed, _ = fq.fold_quantize(**a, **kw, byte_order=order)
            compare(f"main path {order}-endian", packed,
                    (packed.shape[0], packed.shape[0] - 5))
            del packed
        self.kernels["packed_digest"]["max_abs_err"] = float(worst)

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
    def _zero_counts(self):
        from psrsigsim_torch.ops import digest
        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.ops import gamma, rng_hw

        rng_hw.rng_field.launches = 0
        rng_hw.rng_flat_field.launches = 0
        fq.fold_quantize.launches = 0
        digest.packed_digest.launches = 0
        gamma.gamma_field.launches = 0

    def _path(self, label, counts):
        """Record one main path's launch counts under each kernel it
        launched (the kernels line's ``launches_by_path``)."""
        for name, n in counts.items():
            if n:
                self.kernels[name].setdefault("launches_by_path", {})[label] = n

    def _counts(self):
        """Launches since :meth:`_zero_counts`.  The sampler's flat layout
        (SEARCH mode) and the exact-gamma kernel join the dict only when
        they launched, so the other phases' exact comparisons fail on a
        stray launch of either too."""
        from psrsigsim_torch.ops import digest
        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.ops import gamma, rng_hw

        counts = {"rng_field": rng_hw.rng_field.launches,
                  "fold_quantize": fq.fold_quantize.launches,
                  "packed_digest": digest.packed_digest.launches}
        if rng_hw.rng_flat_field.launches:
            counts["rng_flat_field"] = rng_hw.rng_flat_field.launches
        if gamma.gamma_field.launches:
            counts["gamma_field"] = gamma.gamma_field.launches
        return counts

    def main_path(self):
        torch = self.torch
        import numpy as np

        os.environ.pop("PSS_SAMPLER", None)
        ens = self.main_ensemble()
        cfg = ens.cfg
        log(f"  config1_fold64: nchan {cfg.meta.nchan} nph {cfg.nph} "
            f"nsub {cfg.nsub} nsamp {cfg.nsamp} nfold {cfg.nfold:g} "
            f"noise_df {cfg.noise_df:g} noise_norm {ens.noise_norm:.6g}")
        prof = ens._profiles_np.astype(np.float64)
        expect = (cfg.draw_norm * cfg.nfold * prof.mean(axis=1)
                  + cfg.noise_df * ens.noise_norm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # (a) the quantized path: run_quantized + iter_chunks, fused kernel
        self._zero_counts()
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
        counts = self._counts()
        peak = torch.cuda.max_memory_allocated()
        self.kernels["fold_quantize"]["launches"] = counts["fold_quantize"]
        self._path(f"5 run_quantized({MAIN_NOBS}) + iter_chunks"
                   f"({2 * MAIN_NOBS})", counts)
        log(f"  launches in run_quantized({MAIN_NOBS}) + iter_chunks"
            f"({2 * MAIN_NOBS}, quantized): {counts}")
        if counts["fold_quantize"] <= 0:
            raise AssertionError("the quantized path never launched the fused "
                                 "kernel")
        if counts["rng_field"] != 0:
            raise AssertionError("the quantized path ran the unfused body")
        if counts["packed_digest"] != 0:
            raise AssertionError("the unarmed path ran the digest kernel")

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
        deq = d.astype(np.float64) * s[..., None] + o[..., None]
        rel = np.abs(deq.mean(axis=(0, 1, 3)) / expect - 1)
        log(f"  dequantized channel means vs expectation: max rel dev "
            f"{rel.max():.3g}")
        if rel.max() > 0.01:
            raise AssertionError("dequantized channel means off by > 1%")
        del data, scl, offs, chunks, cd, cs, co, d, s, o, deq

        # steady state: the same chunk again, timed on the host clock
        reps = 20
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
        log(f"  steady iter_chunks({2 * MAIN_NOBS}): {t_ic2:.4f} s = "
            f"{2 * MAIN_NOBS / t_ic2:.1f} obs/s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = ens.run_quantized(MAIN_NOBS, seed=0)
        torch.cuda.synchronize()
        chunk_peak = torch.cuda.max_memory_allocated() - base
        del out
        log(f"  steady run_quantized({MAIN_NOBS}): {t_ss * 1e3:.3f} ms = "
            f"{MAIN_NOBS / t_ss:.1f} obs/s; peak memory of one chunk "
            f"{chunk_peak / 2**30:.3f} GiB, of run_quantized + iter_chunks "
            f"{peak / 2**30:.3f} GiB ({name}, {self.card_line})")

        # (b) the float path: FoldEnsemble.run, sampler kernel
        torch.cuda.synchronize()
        self._zero_counts()
        blocks = ens.run(FLOAT_NOBS, seed=0)
        torch.cuda.synchronize()
        counts = self._counts()
        self.kernels["rng_field"]["launches"] = counts["rng_field"]
        self._path(f"5 run({FLOAT_NOBS})", counts)
        log(f"  launches in run({FLOAT_NOBS}): {counts}")
        if counts["rng_field"] <= 0:
            raise AssertionError("the float path never launched the sampler")
        if counts["fold_quantize"] != 0:
            raise AssertionError("the float path launched the fused kernel")
        if tuple(blocks.shape) != (FLOAT_NOBS, cfg.meta.nchan, cfg.nsamp):
            raise AssertionError(f"unexpected shape {tuple(blocks.shape)}")
        if not bool(torch.isfinite(blocks).all()):
            raise AssertionError("non-finite samples in run")
        rel = np.abs(blocks.double().mean(dim=(0, 2)).cpu().numpy() / expect - 1)
        log(f"  float channel means vs expectation: max rel dev {rel.max():.3g}")
        if rel.max() > 0.01:
            raise AssertionError("float channel means off by > 1%")
        del blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            out = ens.run(FLOAT_NOBS, seed=0)
        torch.cuda.synchronize()
        t_run = (time.perf_counter() - t0) / 5
        del out
        log(f"  steady run({FLOAT_NOBS}): {t_run * 1e3:.3f} ms = "
            f"{FLOAT_NOBS / t_run:.1f} obs/s ({self.card_line})")

        # (c) the Fourier shift's rounding against the batch width
        self.fft_rounding()
        self.batch_widths(ens, None, "scenario-free")

    def fft_rounding(self):
        """Which of cuFFT's real transforms rounds a row apart when the
        same rows come in a batch of 8 x 64 or of 128 x 64 (logged), and
        the shift's grouped transforms, which must not (a failure)."""
        torch = self.torch
        from psrsigsim_torch.ops import shift

        g = torch.Generator(device=self.dev).manual_seed(7)
        nph = self.main_ensemble().cfg.nph
        rows = torch.rand((MAIN_NOBS * MAIN["nchan"], nph), generator=g,
                          device=self.dev)
        few = 8 * MAIN["nchan"]

        def apart(a, b):
            return int((a != b).any(dim=-1).sum())

        spec = torch.fft.rfft(rows, dim=-1)
        r_raw = apart(spec[:few], torch.fft.rfft(rows[:few], dim=-1))
        i_raw = apart(torch.fft.irfft(spec, n=nph, dim=-1)[:few],
                      torch.fft.irfft(spec[:few], n=nph, dim=-1))
        gspec = shift._rfft_rows(rows)
        r_grp = apart(gspec[:few], shift._rfft_rows(rows[:few]))
        i_grp = apart(shift._irfft_rows(gspec, nph)[:few],
                      shift._irfft_rows(gspec[:few], nph))
        log(f"  rows 0-{few - 1} of {rows.shape[0]} x {nph} in a batch of "
            f"{rows.shape[0]} against one of {few}: torch.fft.rfft rounds "
            f"{r_raw} rows apart, irfft {i_raw}; the shift's transforms "
            f"({shift.fft_group_rows(nph, self.dev)} rows a call) {r_grp} "
            f"and {i_grp}")
        if r_grp or i_grp:
            raise AssertionError("the shift's grouped FFTs round a row apart "
                                 "for another batch width")

    def batch_widths(self, ens, sp, label):
        """Observations 0-7's packed codes, scales and offsets in batches of
        every width of BATCH_WIDTHS (one launch each, width 1 one call per
        observation): bit-identical, or the phase fails."""
        torch = self.torch
        import numpy as np

        kw = {} if sp is None else {"scenario_params": sp}
        n = SCEN_HOST_NOBS
        base = [t[:n] for t in ens.run_quantized_at(
            np.arange(BATCH_WIDTHS[-1]), seed=0, **kw)[:3]]
        worst = {}
        for w in BATCH_WIDTHS[:-1]:
            if w == 1:
                parts = [ens.run_quantized_at(np.array([i]), seed=0, **kw)[:3]
                         for i in range(n)]
                got = [torch.cat([p[j] for p in parts]) for j in range(3)]
            else:
                got = [t[:n] for t in ens.run_quantized_at(
                    np.arange(w), seed=0, **kw)[:3]]
            worst[w] = (int((got[0] != base[0]).sum()),
                        int((got[1] != base[1]).sum()
                            + (got[2] != base[2]).sum()))
        log(f"  {label}: observations 0-{n - 1} at batch widths "
            f"{list(BATCH_WIDTHS[:-1])} against {BATCH_WIDTHS[-1]}: codes "
            "and scl/offs that differ "
            + ", ".join(f"{w}: {c}/{so}" for w, (c, so) in worst.items())
            + " (limit 0)")
        if any(c or so for c, so in worst.values()):
            raise AssertionError(f"{label}: codes depend on the batch width")

    # -- optional -----------------------------------------------------------
    def profile(self):
        """Where the main path's time goes: one steady run_quantized(128)
        under torch.profiler, device time by kernel and the device's busy
        share of the host wall time (``--profile`` only)."""
        torch = self.torch
        ens = self.main_ensemble()
        ens.run_quantized(MAIN_NOBS, seed=0)
        torch.cuda.synchronize()
        wall, busy, nev, by_name, prof = device_profile(
            torch, lambda: ens.run_quantized(MAIN_NOBS, seed=0))
        log(f"  wall {wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / 1e6 / wall:.1%}), {nev} device events "
            f"on {self.card_line}")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
            log(f"  {us / 1e3:9.3f} ms {n:4d}x  {name[:110]}")
        log("  host: self CPU time by operator")
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for ev in host[:12]:
            log(f"  {ev.self_cpu_time_total / 1e3:9.3f} ms {ev.count:4d}x  "
                f"{ev.key[:100]}")

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
            at = np.unravel_index(np.argmax(rel), rel.shape)
            log(f"  float blocks: max rel diff {rel.max():.3g} at {at} "
                f"(card {bg[at]!r}, CPU {bc[at]!r}; bit-equal "
                f"{np.mean(bg == bc):.4f})")
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
        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.utils import key, stage_key

        # the sampler: one chi2_wh field at the main path's shape
        B, C, L = MAIN_NOBS, MAIN["nchan"], self.main_ensemble().cfg.nsamp
        k = stage_key(stage_key(key(0, self.dev), "user",
                                torch.arange(B, device=self.dev)), "pulse")
        seeds = rng_hw.seed_words(k).contiguous()
        dfs = torch.full((B,), 12000.0, device=self.dev)
        pos = torch.zeros((B, 2), dtype=torch.int32, device=self.dev)
        ms = cuda_time_ms(lambda: rng_hw.rng_field(seeds, dfs, pos, "chi2_wh",
                                                   C, L), 20)
        plain_ms = cuda_time_ms(lambda: rng_hw.rng_field_plain(
            seeds, dfs, pos, "chi2_wh", C, L), 1)
        library_ms = cuda_time_ms(lambda: torch.randn(
            (B, C, L), device=self.dev), 20)
        n = B * C * L
        b_ms, b_by, parts = bound(DRAW_OPS, n, 4 * n + B * (8 + 4 + 8))
        self.kernels["rng_field"].update(
            name="rng_field", route="cuda",
            source="psrsigsim_torch/csrc/rng_field.cu",
            replaces="psrsigsim_tpu/ops/rng_pallas.py:115",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
        one_call = RNG_OPS_PER_SAMPLE_ONE_CALL * n / PEAK_OPS_PER_S * 1e3
        log(f"  rng_field (B={B}, C={C}, L={L}, chi2_wh): {ms:.4f} ms; plain "
            f"{plain_ms:.2f} ms; torch.randn {library_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms, {b_by} ({fmt_parts(parts)}; one-call-per-sample "
            f"single-rate count {one_call:.4f}) on {self.card_line}")

        self.front_half()

        # the fused kernel: the main path's chunk
        a, kw, _ = self.main_fused_args()
        Bf, Cf, nph = a["prof"].shape
        nsub = kw["nsub"]
        ms = cuda_time_ms(lambda: fq.fold_quantize(**a, **kw), 20)
        ms_big = cuda_time_ms(lambda: fq.fold_quantize(**a, **kw,
                                                       byte_order="big"), 20)
        plain_ms = cuda_time_ms(lambda: fq.fold_quantize_plain(**a, **kw), 1)
        n = Bf * Cf * nsub * nph
        nbytes = (4 * Bf * Cf * nph                   # shifted portraits
                  + 2 * Bf * nsub * Cf * (nph + 4)    # packed codes
                  + Bf * nsub * Cf                    # finite flags
                  + Bf * (2 * 8 + 2 * 4 + 4))         # seeds, dfs, norms
        b_ms, b_by, parts = bound(FUSED_OPS, n, nbytes)
        self.kernels["fold_quantize"].update(
            name="fold_quantize", route="cuda",
            source="psrsigsim_torch/csrc/fold_quantize.cu",
            replaces="psrsigsim_tpu/simulate/pipeline.py:272 (XLA fusion "
                     "with psrsigsim_tpu/parallel/ensemble.py:284-322)",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
        log(f"  fold_quantize (B={Bf}, C={Cf}, nsub={nsub}, nph={nph}): "
            f"{ms:.4f} ms (big-endian {ms_big:.4f}); plain {plain_ms:.2f} ms; "
            f"bound {b_ms:.4f} ms, {b_by} ({fmt_parts(parts)}) on "
            f"{self.card_line}")

        # the packed digest: the main path's big-endian chunk, as the
        # integrity-armed export digests it
        from psrsigsim_torch.ops import digest

        packed, _ = fq.fold_quantize(**a, **kw, byte_order="big")
        ms = cuda_time_ms(lambda: digest.packed_digest(packed), 20)
        plain_ms = cuda_time_ms(lambda: digest.packed_digest_plain(packed), 1)
        words = Bf * nsub * Cf * (nph + 2)   # codes + the scl and offs words
        b_ms, b_by, parts = bound(DIGEST_OPS, words,
                                  packed.numel() * 2 + 4 * Bf)
        self.kernels["packed_digest"].update(
            name="packed_digest", route="cuda",
            source="psrsigsim_torch/csrc/packed_digest.cu",
            replaces="psrsigsim_tpu/runtime/integrity.py:234 "
                     "(device_packed_digest_rows, XLA fusion)",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
        log(f"  packed_digest ({tuple(packed.shape)} int16, "
            f"{packed.numel() * 2 / 1e6:.1f} MB): {ms:.4f} ms = "
            f"{packed.numel() * 2 / ms / 1e9:.3f} TB/s, {b_ms / ms:.1%} of "
            f"the bound; plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms, "
            f"{b_by} ({fmt_parts(parts)}) on {self.card_line}")
        del packed

    def front_half(self):
        """The device time of a main-path chunk's front half (DM delays,
        the double-float ramp and the Fourier shift's FFTs), and of its
        FFTs alone: one call each, as before the shift was grouped, and
        grouped as now."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import shift
        from psrsigsim_torch.simulate import pipeline

        ens = self.main_ensemble()
        cfg = ens.cfg
        chunk = ens._prep_chunk(np.arange(MAIN_NOBS), 0, None, None)

        def front():
            return pipeline._fold_front(*chunk, ens._profiles, cfg,
                                        ens._freqs, ens._chan_ids, None, None)

        front()
        torch.cuda.synchronize()
        busy, by_name = [], {}
        for _ in range(3):
            _, b, _, by_name, _ = device_profile(torch, front)
            busy.append(b / 1e3)
        prof = ens._profiles
        nph = cfg.nph
        phase = torch.ones((MAIN_NOBS,) + prof.shape[:-1] + (nph // 2 + 1,),
                           dtype=torch.complex64, device=self.dev)
        one_call = cuda_time_ms(lambda: torch.fft.irfft(
            torch.fft.rfft(prof, dim=-1) * phase, n=nph, dim=-1), 20)
        grouped = cuda_time_ms(lambda: shift._irfft_rows(
            shift._rfft_rows(prof) * phase, nph), 20)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        self.front_ms = min(busy)
        log(f"  front half of a {MAIN_NOBS}-observation chunk: device busy "
            + ", ".join(f"{b:.4f}" for b in busy) + " ms; its transforms "
            f"with the spectrum product {grouped:.4f} ms grouped "
            f"({shift.fft_group_rows(nph, self.dev)} rows a call) against "
            f"{one_call:.4f} ms in one call each; top device events: "
            + "; ".join(f"{name[:60]} {us / 1e3:.4f} ms x{n}"
                        for name, (us, n) in top) + f" ({self.card_line})")

    # -- 8 ------------------------------------------------------------------
    def export(self):
        """The PSRFITS export of the main path (see the module docstring)."""
        import hashlib
        import pickle
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.io import FitsFile, export_ensemble_psrfits
        from psrsigsim_torch.io import export as export_mod
        from psrsigsim_torch.runtime import StageTimers

        torch = self.torch
        os.environ.pop("PSS_SAMPLER", None)
        ens = self.main_ensemble()
        cfg = ens.cfg

        # iter_chunks with and without the overlap, first, on a quiet host
        # (no writer processes, no dirty pages of the exports below): one
        # run of each kept whole for the bit-identity check, then timed
        # runs that drop each chunk as it comes (a consumer that keeps
        # every chunk makes each run allocate fresh pinned memory), after
        # one untimed run of each
        settings = ((0, 0), (1, 2))

        def chunks(opts):
            return ens.iter_chunks(EXPORT_NOBS, chunk_size=MAIN_NOBS, seed=0,
                                   quantized=True, byte_order="big",
                                   prefetch=opts[0], fetch_ahead=opts[1])

        first = list(chunks(settings[0]))
        got = list(chunks(settings[1]))
        for (s0, a), (s1, b) in zip(got, first):
            if s0 != s1 or not all(np.array_equal(x, y)
                                   for x, y in zip(a, b)):
                raise AssertionError(f"iter_chunks{settings[1]} differs from "
                                     "the serial chunks")
        if len(got) != len(first):
            raise AssertionError("iter_chunks yielded another chunk count")
        del first, got
        runs = {}
        for k, opts in enumerate(settings * 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in chunks(opts):
                pass
            if k >= len(settings):
                runs.setdefault(opts, []).append(
                    EXPORT_NOBS / (time.perf_counter() - t0))
        log(f"  iter_chunks({EXPORT_NOBS}, chunk {MAIN_NOBS}, quantized, "
            "big-endian, each chunk dropped as it comes): "
            + "; ".join(f"prefetch {p}, fetch_ahead {f}: "
                        + ", ".join(f"{r:.1f}" for r in rates) + " obs/s"
                        for (p, f), rates in runs.items())
            + f"; chunks bit-identical ({self.card_line})")

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="export-", dir=build)
        try:
            df = subprocess.run(["df", "-T", work], capture_output=True,
                                text=True, timeout=60).stdout.strip()
            writers = min(8, os.cpu_count() or 1)
            log(f"  filesystem of {work}:")
            for line in df.splitlines():
                log(f"    {line}")
            log(f"  os.cpu_count() {os.cpu_count()}, default writers "
                f"{writers} (spawn processes), chunk {MAIN_NOBS}, "
                f"{self.card_line}")

            # start-up of a pool of spawn writers, on its own: every pooled
            # export below pays it inside its wall
            t0 = time.perf_counter()
            pool = export_mod._WriterPool(writers, pickle.dumps({}), {})
            pool.finish()
            log(f"  writer pool start-up ({writers} spawn processes, all of "
                f"them): {time.perf_counter() - t0:.3f} s")

            class Timers(StageTimers):
                """Stage timers that also keep when the first chunk was
                dispatched (the pipeline's start, after the pool's)."""
                first = None

                def add(self, stage, seconds, nbytes=0):
                    if stage == "dispatch" and self.first is None:
                        self.first = time.perf_counter() - seconds
                    super().add(stage, seconds, nbytes)

            def run_export(label, out, n, **kw):
                timers = Timers()
                self._zero_counts()
                since = time.time() - 0.05  # the file clock is coarser
                t0 = time.perf_counter()
                paths = export_ensemble_psrfits(
                    ens, n, out, TEMPLATE, ens.pulsar, seed=0,
                    chunk_size=MAIN_NOBS, telemetry=timers, **kw)
                wall = time.perf_counter() - t0
                counts = self._counts()
                # the bytes of the files this call wrote
                nbytes = sum(os.path.getsize(p) for p in paths
                             if os.path.getmtime(p) >= since)
                rate = "no chunk computed"
                if timers.first is not None:
                    steady = wall - (timers.first - t0)
                    rate = (f"{n / steady:.1f} obs/s, {nbytes / steady / 1e9:.3f}"
                            " GB/s from the first dispatch")
                snap = timers.snapshot()
                stages = ", ".join(f"{k} {snap[k + '_s']:.3f} s"
                                   for k in ("dispatch", "fetch", "encode",
                                             "write"))
                self.export_rates[label] = n / wall
                log(f"  {label}: {len(paths)} files, {nbytes / 1e9:.4f} GB "
                    f"written in {wall:.3f} s = {n / wall:.1f} obs/s, "
                    f"{nbytes / wall / 1e9:.3f} GB/s end to end; {rate}; "
                    f"stages {stages}, bottleneck {snap['bottleneck']}; "
                    f"launches {counts}")
                return paths, counts

            def sha(path):
                with open(path, "rb") as fh:
                    return hashlib.sha256(fh.read()).hexdigest()

            # 1. one file per observation, depth 2, default writers, then
            # one in-process writer: the same bytes
            per_file = os.path.join(work, "per_file")
            paths, counts = run_export(
                f"export {EXPORT_NOBS} obs, one per file, depth 2, "
                f"{writers} writers", per_file, EXPORT_NOBS, pipeline_depth=2)
            with open(os.path.join(per_file, "export_manifest.json")) as fh:
                pipe = json.load(fh)["pipeline"]
            log("  manifest pipeline: " + json.dumps(pipe, sort_keys=True))
            if counts != {"fold_quantize": 2, "rng_field": 0,
                          "packed_digest": 0}:
                raise AssertionError(f"export launches {counts}, expected 2 "
                                     "fused-kernel launches, no sampler and "
                                     "no digest")
            one = os.path.join(work, "per_file_w1")
            opaths, _ = run_export(
                f"export {EXPORT_NOBS} obs, one per file, depth 2, 1 writer",
                one, EXPORT_NOBS, pipeline_depth=2, writers=1)
            if any(sha(a) != sha(b) for a, b in zip(opaths, paths)):
                raise AssertionError("the in-process writer's files differ "
                                     "from the pool's")
            log("  1-writer files equal the pool's (sha256)")
            shutil.rmtree(one)

            # 2. the files hold run_quantized's triples bit for bit
            d, s, o = (t.cpu().numpy() for t in
                       ens.run_quantized(EXPORT_NOBS, seed=0))
            check = (0, 1, MAIN_NOBS // 2, MAIN_NOBS - 1, MAIN_NOBS,
                     MAIN_NOBS + 1, EXPORT_NOBS - 2, EXPORT_NOBS - 1)
            for i in check:
                sub = FitsFile.read(paths[i])["SUBINT"].data
                if not (np.array_equal(sub["DATA"][:, 0].view(">i2"), d[i])
                        and np.array_equal(sub["DAT_SCL"], s[i])
                        and np.array_equal(sub["DAT_OFFS"], o[i])):
                    raise AssertionError(f"file of observation {i} differs "
                                         "from run_quantized")
            log(f"  files of observations {list(check)} equal "
                f"run_quantized({EXPORT_NOBS})'s triples bit for bit")
            del d, s, o

            # 3. resume (one in-process writer): missing files come back
            # byte-identical, and only the chunks holding one are computed
            for victims, want in (((1, MAIN_NOBS + MAIN_NOBS // 2), 2),
                                  ((MAIN_NOBS // 4,), 1)):
                before = {i: sha(paths[i]) for i in victims}
                for i in victims:
                    os.unlink(paths[i])
                _, counts = run_export(
                    f"resume after deleting observations {list(victims)}",
                    per_file, EXPORT_NOBS, pipeline_depth=2, writers=1)
                if counts["fold_quantize"] != want:
                    raise AssertionError(f"resume launched the fused kernel "
                                         f"{counts['fold_quantize']} times, "
                                         f"expected {want}")
                if any(sha(paths[i]) != before[i] for i in victims):
                    raise AssertionError("a resumed file differs")
            log("  resumed files byte-identical (sha256)")

            # 4. packed: 16 observations per file, rows equal the per-file
            # payloads; default writers, then one
            for label, kw in ((f"{writers} writers", {}),
                              ("1 writer", dict(writers=1))):
                packed = os.path.join(work, "packed")
                gpaths, counts = run_export(
                    f"export {EXPORT_NOBS} obs, {EXPORT_OPF} per file, "
                    f"depth 2, {label}", packed, EXPORT_NOBS,
                    pipeline_depth=2, obs_per_file=EXPORT_OPF, **kw)
                nsub = cfg.nsub
                for g, gp in enumerate(gpaths):
                    rows = FitsFile.read(gp)["SUBINT"].data
                    for k in range(EXPORT_OPF):
                        one = FitsFile.read(
                            paths[g * EXPORT_OPF + k])["SUBINT"].data
                        part = rows[k * nsub:(k + 1) * nsub]
                        for col in ("DATA", "DAT_SCL", "DAT_OFFS"):
                            if part[col].tobytes() != one[col].tobytes():
                                raise AssertionError(
                                    f"packed file {g} row block {k}: {col} "
                                    "differs")
                shutil.rmtree(packed)
            log(f"  packed rows equal the per-file payloads ({len(gpaths)} "
                f"files x {EXPORT_OPF} observations, both writer counts)")

            # 5. depth 0 and one in-process writer: the same bytes
            serial = os.path.join(work, "serial")
            spaths, _ = run_export(
                f"export {EXPORT_SERIAL_NOBS} obs, depth 0, 1 writer",
                serial, EXPORT_SERIAL_NOBS, pipeline_depth=0, writers=1)
            for i, sp in enumerate(spaths):
                if sha(sp) != sha(paths[i]):
                    raise AssertionError(f"depth-0 serial file {i} differs "
                                         "from the depth-2 pooled one")
            log(f"  depth-0 serial files equal the depth-2 pooled files "
                f"({EXPORT_SERIAL_NOBS}, sha256)")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 9 ------------------------------------------------------------------
    def supervised(self):
        """The supervised export of the main path (see the module
        docstring)."""
        import hashlib
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.io import FitsFile
        from psrsigsim_torch.runtime import (FaultPlan, IntegrityChecker,
                                             supervised_export)
        from psrsigsim_torch.runtime.integrity import triple_digest_rows
        from psrsigsim_torch.runtime.supervisor import RETRY_FOLD_SALT

        torch = self.torch
        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_INTEGRITY", None)
        ens = self.main_ensemble()
        writers = min(8, os.cpu_count() or 1)

        def disk_hashes(out):
            res = {}
            for n in sorted(os.listdir(out)):
                if n.endswith(".fits"):
                    with open(os.path.join(out, n), "rb") as fh:
                        res[n] = hashlib.sha256(fh.read()).hexdigest()
            return res

        def journal(out):
            with open(os.path.join(out, "run_journal.jsonl")) as fh:
                return [json.loads(line) for line in fh]

        def run(label, out, **kw):
            self._zero_counts()
            t0 = time.perf_counter()
            res = supervised_export(ens, SUP_NOBS, out, TEMPLATE, ens.pulsar,
                                    seed=0, chunk_size=MAIN_NOBS, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
            log(f"  {label}: {len(res.paths)} files in {wall:.3f} s = "
                f"{SUP_NOBS / wall:.1f} obs/s; quarantined {res.quarantined}, "
                f"retried {res.retried}, recovered {res.recovered}; "
                f"launches {counts}")
            return res, counts, wall

        def expect(counts, **want):
            want = {"rng_field": 0, **want}
            if counts != want:
                raise AssertionError(f"launches {counts}, expected {want}")

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="supervised-", dir=build)
        try:
            # 1. clean: one in-process writer, then the default pool
            clean = os.path.join(work, "clean")
            res, counts, wall1 = run("supervised export, 1 writer", clean,
                                     writers=1)
            expect(counts, fold_quantize=2, packed_digest=0)
            commits = [r for r in journal(clean) if r["e"] == "commit"]
            if [(r["kind"], r["ident"]) for r in commits] != \
                    [("chunk", 0), ("chunk", MAIN_NOBS)]:
                raise AssertionError(f"journal commits {commits}")
            want = disk_hashes(clean)
            self.sup_clean = (want, SUP_NOBS / wall1)
            with open(os.path.join(clean, "export_manifest.json")) as fh:
                if json.load(fh)["files"] != want:
                    raise AssertionError("manifest hashes differ from the "
                                         "files on disk")
            d, s, o = (t.cpu().numpy() for t in
                       ens.run_quantized(SUP_NOBS, seed=0))
            check = (0, 1, MAIN_NOBS - 1, MAIN_NOBS, SUP_NOBS - 1)
            for i in check:
                sub = FitsFile.read(res.paths[i])["SUBINT"].data
                if not (np.array_equal(sub["DATA"][:, 0].view(">i2"), d[i])
                        and np.array_equal(sub["DAT_SCL"], s[i])
                        and np.array_equal(sub["DAT_OFFS"], o[i])):
                    raise AssertionError(f"file of observation {i} differs "
                                         "from run_quantized")
            del d, s, o
            log(f"  files of observations {list(check)} equal "
                f"run_quantized({SUP_NOBS})'s triples; journal: 2 chunk "
                "commits; manifest hashes equal the files on disk")
            pool = os.path.join(work, "pool")
            _, counts, wallp = run(f"supervised export, {writers} writers",
                                   pool)
            expect(counts, fold_quantize=2, packed_digest=0)
            if disk_hashes(pool) != want:
                raise AssertionError("the pool's files differ from the "
                                     "in-process writer's")
            shutil.rmtree(pool)
            log(f"  supervised vs unsupervised (phase 8), one per file, "
                f"{SUP_NOBS} obs: 1 writer {SUP_NOBS / wall1:.1f} vs "
                + ", ".join(f"{k}: {v:.1f}" for k, v in
                            self.export_rates.items() if "one per file" in k)
                + f" obs/s; {writers} writers {SUP_NOBS / wallp:.1f} obs/s "
                f"({self.card_line})")

            # 2. NaN quarantine and the salted retry
            bad = [MAIN_NOBS // 25, MAIN_NOBS + MAIN_NOBS * 9 // 16]
            nan = os.path.join(work, "nan")
            res, counts, _ = run(
                f"nan.obs on {bad}, 1 writer", nan, writers=1,
                faults=FaultPlan(os.path.join(work, "nan_plan"),
                                 {"nan.obs": {"indices": bad}}))
            expect(counts, fold_quantize=3, packed_digest=0)
            if not (res.retried == bad and res.recovered == bad
                    and res.quarantined == []):
                raise AssertionError(f"quarantine outcome {res!r}")
            got = disk_hashes(nan)
            if sorted(n for n in want if got[n] != want[n]) != \
                    [f"obs_{i:05d}.fits" for i in bad]:
                raise AssertionError("files other than the quarantined ones "
                                     "differ from the clean run")
            d, s, o, f = (t.cpu().numpy() for t in ens.run_quantized_at(
                bad, seed=0, byte_order="big", fold_salt=RETRY_FOLD_SALT))
            if not f.all():
                raise AssertionError("the salted re-run is not finite")
            for k, i in enumerate(bad):
                sub = FitsFile.read(res.paths[i])["SUBINT"].data
                if not (sub["DATA"][:, 0].tobytes() == d[k].tobytes()
                        and np.array_equal(sub["DAT_SCL"], s[k])
                        and np.array_equal(sub["DAT_OFFS"], o[k])):
                    raise AssertionError(f"quarantined observation {i}'s file "
                                         "differs from run_quantized_at")
            shutil.rmtree(nan)
            log(f"  quarantined files equal run_quantized_at({bad}, "
                f"fold_salt={RETRY_FOLD_SALT:#x}); the other "
                f"{SUP_NOBS - len(bad)} files equal the clean run's")

            # 3. the integrity lattice and a full audit
            ck = IntegrityChecker(audit_frac=1.0)
            integ = os.path.join(work, "integrity")
            res, counts, wall_i = run(
                "integrity, audit_frac 1.0, host.corrupt on chunk 0, "
                f"device.sdc on chunk {MAIN_NOBS}, 1 writer", integ,
                writers=1, integrity=ck,
                faults=FaultPlan(os.path.join(work, "integ_plan"),
                                 {"host.corrupt": {"after_start": 0},
                                  "device.sdc": {"after_start": MAIN_NOBS}}))
            self.kernels["packed_digest"]["launches"] = counts["packed_digest"]
            self._path("9 supervised export, integrity leg", counts)
            expect(counts, fold_quantize=6, packed_digest=6)
            st = ck.stats()
            log(f"  integrity stats: {json.dumps(st, sort_keys=True)}")
            if not (st["checksum_mismatches"] == 1
                    and st["audit_mismatches"] == 1
                    and st["healed_chunks"] == 2
                    and st["permanent_failures"] == 0
                    and res.integrity == st):
                raise AssertionError("integrity stats: expected one checksum "
                                     "heal and one audit heal")
            if disk_hashes(integ) != want:
                raise AssertionError("healed files differ from the clean run")
            events = [(r["kind"], r["start"]) for r in journal(integ)
                      if r["e"] == "integrity"]
            if events != [("checksum", 0), ("audit", MAIN_NOBS)]:
                raise AssertionError(f"journal integrity events {events}")
            shutil.rmtree(integ)
            log(f"  healed files equal the clean run's; journal events "
                f"{events}; wall {wall_i:.3f} s against the clean 1-writer "
                f"{wall1:.3f} s")
            # its costs per chunk, and the audit's premise: two launches of
            # the fused kernel on the same inputs write the same bytes
            # (DIVERGENCES.md P7)
            idx = np.arange(MAIN_NOBS)
            probe = IntegrityChecker(audit_frac=0.0)
            host_ms = []
            for start, (cd, cs, co, dig) in ens.iter_chunks(
                    SUP_NOBS, chunk_size=MAIN_NOBS, seed=0, quantized=True,
                    byte_order="big", prefetch=1, fetch_ahead=2,
                    integrity=probe):
                t0 = time.perf_counter()
                host = triple_digest_rows(cd, cs, co)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(host, dig):
                    raise AssertionError(f"chunk {start}: the digest fetched "
                                         "by the overlapped copy differs from "
                                         "the host twin")
            a = ens.run_quantized_at(idx, seed=0, byte_order="big",
                                     return_digest=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = ens.run_quantized_at(idx, seed=0, byte_order="big",
                                     audit=True, return_digest=True)
            torch.cuda.synchronize()
            audit_ms = (time.perf_counter() - t0) * 1e3
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError("two launches of the fused kernel on the "
                                     "same inputs differ")
            del a, b
            log(f"  integrity cost per {MAIN_NOBS}-obs chunk: K4 "
                f"{self.kernels['packed_digest'].get('ms', float('nan')):.4f} "
                "ms (phase 7); "
                f"host re-digest {', '.join(f'{t:.1f}' for t in host_ms)} ms; "
                f"audit re-launch (run_quantized_at + digest, host wall) "
                f"{audit_ms:.2f} ms; iter_chunks(prefetch 1, fetch_ahead 2) "
                "digests equal the host twin; two launches bit-equal "
                f"({self.card_line})")

            # 4. kill and resume
            killed = os.path.join(work, "killed")
            scratch = os.path.join(work, "kill_plan")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), KILL_CHILD,
                 killed, scratch], capture_output=True, text=True,
                timeout=600)
            if proc.returncode != -9:
                raise AssertionError(
                    f"the child exited {proc.returncode}, expected SIGKILL:\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            survivors = disk_hashes(killed)
            if sorted(survivors) != sorted(want)[:MAIN_NOBS] or \
                    [r["e"] for r in journal(killed)] != ["commit"]:
                raise AssertionError("the killed run left other files or "
                                     "records than chunk 0's")
            log(f"  child SIGKILLed after chunk 0's commit "
                f"({time.perf_counter() - t0:.1f} s): {len(survivors)} files, "
                "1 journal commit")
            _, counts, _ = run('resume="verify", 1 writer', killed,
                               writers=1, resume="verify")
            expect(counts, fold_quantize=1, packed_digest=0)
            if disk_hashes(killed) != want:
                raise AssertionError("the resumed export differs from the "
                                     "clean run")
            log("  resumed export byte-identical to the clean run (sha256)")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 10 -----------------------------------------------------------------
    def _run_steps(self, steps, device, after=None):
        """Run ``steps`` [(name, fn)] in order on ``device``; each step's ms
        (CUDA events on the card, the host clock on the CPU) and what each
        returned.  ``after(name)`` runs after each step, untimed."""
        torch = self.torch
        times, results = {}, {}
        for name, fn in steps:
            if device == "cpu":
                t0 = time.perf_counter()
                results[name] = fn()
                times[name] = (time.perf_counter() - t0) * 1e3
            else:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                results[name] = fn()
                stop.record()
                torch.cuda.synchronize()
                times[name] = start.elapsed_time(stop)
            if after is not None:
                after(name)
        return times, results

    def _oo_run(self, search, device):
        """The README's Quickstart (fold) or its SEARCH-mode sibling with
        nulling on ``device``: ``(data on the host after each step, step ms,
        keys drawn, nulled pulses)``.  The keys are every (stage, key) the
        key sequences handed out, in order."""
        import numpy as np

        from psrsigsim_torch.ism import ISM
        from psrsigsim_torch.pulsar import GaussProfile, Pulsar
        from psrsigsim_torch.signal import FilterBankSignal
        from psrsigsim_torch.telescope import GBT
        from psrsigsim_torch.utils import rng

        drawn = []
        plain_next = rng.KeySequence.next

        def recording_next(seq, stage="user", index=0):
            k = plain_next(seq, stage, index)
            drawn.append((stage, index, tuple(int(w) for w in k)))
            return k

        rng.KeySequence.next = recording_next
        try:
            rng.set_seed(0)
            sig = FilterBankSignal(1400.0, 400.0, Nsubband=64,
                                   sample_rate=0.2048, fold=not search,
                                   sublen=None if search else 2.0,
                                   device=device)
            psr = Pulsar(0.00457, 0.03, GaussProfile(peak=0.5, width=0.02),
                         name="J1713+0747", seed=0)
            steps = [("make_pulses", lambda: psr.make_pulses(
                         sig, tobs=OO_SEARCH_TOBS if search else 60.0)),
                     ("disperse", lambda: ISM().disperse(sig, dm=15.99))]
            if search:
                steps.append(("null", lambda: psr.null(sig, 0.3)))
            steps.append(("observe", lambda: GBT().observe(
                sig, psr, system="Lband_GUPPI", noise=True)))
            data = {}

            def keep(name):
                data[name] = sig.data.cpu().numpy()

            times, results = self._run_steps(steps, device, after=keep)
        finally:
            rng.KeySequence.next = plain_next
        return data, times, drawn, results.get("null")

    def _oo_leg(self, label, search):
        """One leg of phase 10: the flow on the card, then on the host, and
        the two held against each other."""
        torch = self.torch
        import numpy as np

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        card, times, keys, nulled = self._oo_run(search, self.dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        # the same flow again: the first run of a process pays cuFFT's
        # plans for these lengths (the first on a machine also compiles
        # cuFFT's kernels for them) and the first pinned buffers
        again, warm, _, _ = self._oo_run(search, self.dev)
        if not all(np.array_equal(card[k], again[k]) for k in card):
            raise AssertionError(f"{label}: two runs on the card differ")
        del again
        t0 = time.perf_counter()
        host, cpu_times, cpu_keys, cpu_nulled = self._oo_run(search, "cpu")
        cpu_wall = time.perf_counter() - t0
        got, want = card["observe"], host["observe"]
        log(f"  {label}: data {got.shape} float32; card steps "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
            + f" (sum {sum(times.values()):.2f} ms; wall with the copies "
            f"to the host after each step {wall:.3f} s; peak device memory "
            f"{peak / 2**30:.3f} GiB); again on the card "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in warm.items())
            + f" (sum {sum(warm.values()):.2f} ms, bit-equal to the first); "
            "host (device='cpu') steps "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in cpu_times.items())
            + f" (wall {cpu_wall:.3f} s) on {self.card_line}")
        if keys != cpu_keys or not keys:
            raise AssertionError(f"{label}: the card drew other keys or "
                                 f"stages than the host: {keys} vs {cpu_keys}")
        log(f"  {label}: keys and stage order equal: "
            + ", ".join(f"{st}" for st, _, _ in keys))
        if search:
            if nulled is None or not np.array_equal(nulled, cpu_nulled):
                raise AssertionError(f"{label}: nulled pulses differ: "
                                     f"{nulled} vs {cpu_nulled}")
            log(f"  {label}: nulled pulses equal ({len(nulled)}, first "
                f"{nulled[:6].tolist()})")
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: shape {got.shape} vs "
                                 f"{want.shape}, or non-finite samples")
        if search:
            # null replaces the samples where the delayed check field
            # (a Fourier shift) exceeds 1; where that field lies within
            # the FFT libraries' rounding of 1 the card and the host may
            # decide differently.  Such a flip is allowed, counted and
            # bounded; every other sample is held to the limit.
            pre_c, pre_h = card["disperse"], host["disperse"]
            tol = 1e-5 * np.abs(pre_h) + 1e-5 * float(np.abs(pre_h).max())
            if not np.all(np.abs(pre_c - pre_h) <= tol):
                raise AssertionError(f"{label}: dispersed data differ beyond "
                                     "rtol 1e-5 (floor 1e-5 of the peak)")
            flips = (card["null"] != pre_c) != (host["null"] != pre_h)
            nflip = int(flips.sum())
            log(f"  {label}: null masks: card {int((card['null'] != pre_c).sum())}"
                f", host {int((host['null'] != pre_h).sum())} samples "
                f"replaced; {nflip} differ ({nflip / flips.size:.3g} of the "
                f"samples; the dispersed data before them within the limit)")
            if nflip > 1e-6 * flips.size:
                raise AssertionError(f"{label}: {nflip} null-mask flips, more "
                                     "than 1e-6 of the samples")
            got, want = np.where(flips, 0, got), np.where(flips, 0, want)
        peak_abs = float(np.abs(want).max())
        err = np.abs(got - want)
        rel = np.divide(err, np.abs(want), out=np.zeros_like(err),
                        where=want != 0)
        at = np.unravel_index(np.argmax(rel), rel.shape)
        worst = np.unravel_index(np.argmax(err - 1e-5 * np.abs(want)),
                                 err.shape)
        log(f"  {label}: max rel diff {rel.max():.3g} at {at} (card "
            f"{got[at]!r}, CPU {want[at]!r}); max abs diff "
            f"{err.max():.3g} = {err.max() / peak_abs:.3g} of the peak "
            f"{peak_abs:.6g}, worst against rtol 1e-5 at {worst} (card "
            f"{got[worst]!r}, CPU {want[worst]!r}); bit-equal "
            f"{np.mean(got == want):.4f}")
        if not np.all(err <= 1e-5 * np.abs(want) + 1e-5 * peak_abs):
            raise AssertionError(f"{label}: card and host differ beyond "
                                 "rtol 1e-5 (floor 1e-5 of the peak)")
        return times, warm, peak

    def oo_flow(self):
        """The object-oriented flow and the Simulation facade (see the
        module docstring)."""
        import hashlib
        import shutil
        import tempfile

        from psrsigsim_torch.io import FitsFile
        from psrsigsim_torch.simulate import Simulation
        from psrsigsim_torch.utils import set_seed

        torch = self.torch
        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_INTEGRITY", None)
        self.oo_times = {}
        self.oo_times["a"] = self._oo_leg("(a) Quickstart, fold", False)
        self.oo_times["b"] = self._oo_leg("(b) SEARCH + null", True)

        # (c) the facade at BASELINE config 1's full width
        if self.sup_clean is None:
            raise AssertionError("phase 9's clean run is missing: nothing to "
                                 "hold export_ensemble against")
        want_hashes, sup_rate = self.sup_clean
        g = MAIN
        pars = main_psrdict()
        # docs/tutorial_5_simulate.md's 16-channel geometry for the pdv text
        tut5 = dict(fcent=1400.0, bandwidth=400.0, sample_rate=0.2048,
                    Nchan=16, fold=True, sublen=0.5, tobs=2.0, period=0.005,
                    Smean=0.05, profiles=[0.5, 0.05, 1.0], name="J0000+0000",
                    dm=15.99, tscope_name="demo", aperture=100.0, area=5500.0,
                    Tsys=35.0, system_name="demo_sys", rcvr_fcent=1400.0,
                    rcvr_bw=400.0, rcvr_name="Lband", backend_samprate=12.5,
                    backend_name="demo_backend", seed=11)
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="simulation-", dir=build)
        cwd = os.getcwd()
        try:
            os.chdir(work)  # save_simulation writes its par file here
            set_seed(0)
            sim = Simulation(psrdict=pars, device=self.dev)
            t0 = time.perf_counter()
            sim.simulate()
            torch.cuda.synchronize()
            t_sim = time.perf_counter() - t0
            data = sim.signal.data
            cfg_shape = (g["nchan"], int(g["tobs_s"] / g["sublen_s"])
                         * int(round(g["period_s"] * g["samprate_mhz"] * 1e6)))
            if data.device.type != torch.device(self.dev).type \
                    or tuple(data.shape) != cfg_shape \
                    or not bool(torch.isfinite(data).all()):
                raise AssertionError(f"simulate(): {tuple(data.shape)} on "
                                     f"{data.device}, expected {cfg_shape} "
                                     "finite on the card")
            t0 = time.perf_counter()
            sim.save_simulation(outfile="sim.fits", out_format="psrfits")
            t_fits = time.perf_counter() - t0
            sub = FitsFile.read("sim.fits")["SUBINT"].data
            if sub["DATA"].shape != (cfg_shape[1] // 2048, 1, g["nchan"],
                                     2048):
                raise AssertionError(f"PSRFITS DATA {sub['DATA'].shape}")
            sim5 = Simulation(psrdict=tut5, device=self.dev)
            sim5.simulate()
            t0 = time.perf_counter()
            sim5.save_simulation(outfile="demo.pdv", out_format="pdv")
            t_pdv = time.perf_counter() - t0
            lines = 0
            for n in sorted(os.listdir(".")):
                if n.startswith("demo.pdv_"):
                    with open(n) as fh:
                        lines += sum(1 for _ in fh)
            nfiles = sum(n.startswith("demo.pdv_") for n in os.listdir("."))
            want_lines = nfiles + 4 * 16 * (1 + 1024)
            if lines != want_lines:
                raise AssertionError(f"pdv text has {lines} lines, expected "
                                     f"{want_lines}")
            log(f"  (c) Simulation(psrdict=BASELINE config 1).simulate(): "
                f"{tuple(data.shape)} on the card in {t_sim:.3f} s; "
                f"save_simulation PSRFITS {t_fits:.3f} s "
                f"({os.path.getsize('sim.fits') / 1e6:.1f} MB); tutorial 5 "
                f"pdv {t_pdv:.3f} s ({nfiles} files, {lines} lines)")
            del data, sim5

            # the facade's ensemble against the hand-built one
            ens, hand = sim.to_ensemble(), self.main_ensemble()
            if ens.ephemeris_source is not None or ens.cfg != hand.cfg:
                raise AssertionError("to_ensemble(): another config or "
                                     "ephemeris than the hand-built ensemble")
            self._zero_counts()
            got = ens.run_quantized(MAIN_NOBS, seed=0)
            torch.cuda.synchronize()
            counts = self._counts()
            want = hand.run_quantized(MAIN_NOBS, seed=0)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("to_ensemble().run_quantized differs from "
                                     "the hand-built ensemble's")
            del got, want
            if counts != {"rng_field": 0, "fold_quantize": 1,
                          "packed_digest": 0}:
                raise AssertionError(f"to_ensemble().run_quantized launches "
                                     f"{counts}")
            self._zero_counts()
            got = ens.run(FLOAT_NOBS, seed=0)
            torch.cuda.synchronize()
            counts_run = self._counts()
            if not torch.equal(got, hand.run(FLOAT_NOBS, seed=0)):
                raise AssertionError("to_ensemble().run differs from the "
                                     "hand-built ensemble's")
            del got
            if counts_run != {"rng_field": 2, "fold_quantize": 0,
                              "packed_digest": 0}:
                raise AssertionError(f"to_ensemble().run launches {counts_run}")
            log(f"  (c) to_ensemble().run_quantized({MAIN_NOBS}, seed=0) "
                f"bit-equal to the hand-built ensemble's (launches {counts}); "
                f"to_ensemble().run({FLOAT_NOBS}) bit-equal (launches "
                f"{counts_run})")

            # the facade's supervised export against phase 9's clean run
            out = os.path.join(work, "export")
            self._zero_counts()
            t0 = time.perf_counter()
            res = sim.export_ensemble(SUP_NOBS, out, TEMPLATE, seed=0,
                                      chunk_size=MAIN_NOBS, writers=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
            self.oo_export_launches = counts
            if counts != {"rng_field": 0, "fold_quantize": 2,
                          "packed_digest": 0}:
                raise AssertionError(f"export_ensemble launches {counts}, "
                                     "expected the fused kernel twice")
            journal = {}
            with open(os.path.join(out, "run_journal.jsonl")) as fh:
                for line in fh:
                    rec = json.loads(line)
                    if rec["e"] == "commit":
                        journal.update(rec["files"])
            disk = {}
            for n in sorted(os.listdir(out)):
                if n.endswith(".fits"):
                    with open(os.path.join(out, n), "rb") as fh:
                        disk[n] = hashlib.sha256(fh.read()).hexdigest()
            if journal != want_hashes or disk != want_hashes \
                    or len(res.paths) != SUP_NOBS:
                raise AssertionError("export_ensemble's files or journal "
                                     "differ from phase 9's clean run")
            log(f"  (c) Simulation.export_ensemble({SUP_NOBS}, supervised, 1 "
                f"writer): {wall:.3f} s = {SUP_NOBS / wall:.1f} obs/s against "
                f"phase 9's clean run {sup_rate:.1f} obs/s; journal and files' "
                f"sha256 equal phase 9's; launches {counts} "
                f"({self.card_line})")
        finally:
            os.chdir(cwd)
            shutil.rmtree(work, ignore_errors=True)

    # -- 11 -----------------------------------------------------------------
    def device_breakdown(self, label, fn):
        """One call of ``fn`` under the profiler: the device's busy time and
        share of the host wall, and its top kernels (a measurement aid: a
        profiler that cannot trace the card is logged, not fatal)."""
        try:
            wall, busy, nev, by_name, prof = device_profile(self.torch, fn)
        except Exception as err:  # noqa: BLE001 - a measurement aid
            log(f"  {label} profiler: not measured ({err!r})")
            return
        log(f"  {label} profiled chunk: wall {wall * 1e3:.2f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({busy / 1e6 / wall:.1%}), {nev} device "
            f"events ({self.card_line})")
        for name, (us, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
            log(f"  {us / 1e3:9.3f} ms {n:4d}x  {name[:100]}")
        log(f"  {label} host: self CPU time by operator")
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for ev in host[:10]:
            log(f"  {ev.self_cpu_time_total / 1e3:9.3f} ms {ev.count:4d}x  "
                f"{ev.key[:100]}")

    def mc_study(self):
        """The Monte-Carlo study on the card (see the module docstring)."""
        import contextlib
        import hashlib
        import io
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.mc import MonteCarloStudy
        from psrsigsim_torch.mc.__main__ import main as mc_main
        from psrsigsim_torch.runtime import FaultPlan, supervised_export
        from psrsigsim_torch.simulate import Simulation

        torch = self.torch
        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_INTEGRITY", None)
        no_kernels = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0}

        def sha(path):
            with open(path, "rb") as fh:
                return hashlib.sha256(fh.read()).hexdigest()

        def run(study, label, n, chunk, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self._zero_counts()
            t0 = time.perf_counter()
            res = study.run(n, chunk_size=chunk, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
            peak = torch.cuda.max_memory_allocated()
            log(f"  {label}: {n} trials in {wall:.3f} s = {n / wall:.1f} "
                f"trials/s; peak device memory {peak / 2**30:.3f} GiB; "
                f"launches {counts}")
            return res, counts, wall, peak

        def check_rows(res, n, params):
            m = res.metrics
            if m.shape != (n, len(params) + 4) or not np.isfinite(m).all():
                raise AssertionError(f"metric rows {m.shape}, finite "
                                     f"{np.isfinite(m).all()}")
            if not ((m[:, 0] >= 10.0) & (m[:, 0] < 20.0)).all() or not (
                    (m[:, 1] >= 0.5) & (m[:, 1] <= 2.0)).all():
                raise AssertionError("sampled parameters outside the priors")
            err, sig = res.column("toa_err"), res.column("toa_sigma")
            if not (sig > 0).all() or abs(err.mean()) > 4 * sig.mean() \
                    / np.sqrt(n) + 4 * err.std() / np.sqrt(n):
                raise AssertionError("TOA residuals are not centred on 0")
            if (res.hist.sum(axis=1) != n).any():
                raise AssertionError("histogram counts do not sum to n")

        def artifact(out):
            return {n: sha(os.path.join(out, n))
                    for n in ("study_result.json", "trials.npy",
                              "trials.f32", "mc_journal.jsonl")}

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="mc-", dir=build)
        try:
            # (a) the JAX bench's MC geometry
            study = MonteCarloStudy.from_simulation(
                Simulation(psrdict=MC_BENCH, device=self.dev), MC_PRIORS,
                seed=1)
            cfg = study.cfg
            log(f"  (a) bench MC geometry: nchan {cfg.meta.nchan} nph "
                f"{cfg.nph} nsub {cfg.nsub} nfold {cfg.nfold:g} noise_df "
                f"{cfg.noise_df:g}; priors {MC_PRIORS}; seed 1")
            res, counts, t_first, _ = run(study, "(a) first run", MC_TRIALS,
                                          MC_CHUNK)
            launches_a = counts
            if counts != dict(no_kernels, rng_field=2 * MC_TRIALS // MC_CHUNK):
                raise AssertionError(f"run({MC_TRIALS}, chunk_size="
                                     f"{MC_CHUNK}) launches {counts}")
            check_rows(res, MC_TRIALS, study.param_names)
            res2, _, t_ss, peak = run(study, "(a) steady run", MC_TRIALS,
                                      MC_CHUNK)
            if not np.array_equal(res.metrics, res2.metrics):
                raise AssertionError("two runs of the study differ")
            # device time of one chunk: CUDA events around the chunk
            # program, and the profiler's busy time and top kernels
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            spans = []
            for _ in range(3):
                ev0.record()
                out = study._chunk_program(0, MC_TRIALS, MC_CHUNK, MC_CHUNK)
                ev1.record()
                torch.cuda.synchronize()
                spans.append(ev0.elapsed_time(ev1))
            del out
            log(f"  (a) one {MC_CHUNK}-trial chunk program, CUDA events "
                f"(launch to last kernel, host gaps included): "
                + ", ".join(f"{t:.3f}" for t in spans) + " ms")
            self.device_breakdown("(a)", lambda: study._chunk_program(
                0, MC_TRIALS, MC_CHUNK, MC_CHUNK))
            log(f"  (a) steady: {MC_TRIALS / t_ss:.1f} trials/s "
                f"({1e3 * t_ss * MC_CHUNK / MC_TRIALS:.2f} ms per chunk, host "
                f"wall); first run {t_first:.3f} s; peak {peak / 2**30:.3f} "
                f"GiB ({self.card_line})")

            # chunk-size invariance, with the journal and the artifact
            outs = {}
            for cs in (32, 128, MC_CHUNK, 512):
                out = os.path.join(work, f"c{cs}")
                r = study.run(MC_TRIALS, chunk_size=cs, out_dir=out)
                outs[cs] = (json.dumps(r.summary(), sort_keys=True),
                            r.fingerprint, r.metrics)
            ref = outs[MC_CHUNK]
            for cs, (summ, fp, m) in outs.items():
                if summ != ref[0] or fp != ref[1] or not np.array_equal(
                        m, res.metrics):
                    raise AssertionError(f"chunk size {cs}: another summary, "
                                         "fingerprint or metric rows")
            log(f"  (a) chunk sizes {sorted(outs)}: summary and artifact "
                f"fingerprint {ref[1][:16]} equal, rows equal the in-memory "
                "run's")
            clean = artifact(os.path.join(work, f"c{MC_CHUNK}"))

            # the CLI on its default device: the same study from a spec file
            spec = os.path.join(work, "study.toml")
            with open(spec, "w") as fh:
                fh.write("[simulation]\n")
                for k, v in MC_BENCH.items():
                    fh.write(f"{k} = {json.dumps(v)}\n")
                fh.write(f"[study]\nn_trials = {MC_TRIALS}\nseed = 1\n"
                         f"chunk_size = {MC_CHUNK}\n")
                for knob, prior in MC_PRIORS.items():
                    fh.write(f"[priors.{knob}]\n" + "".join(
                        f"{k} = {json.dumps(v)}\n" for k, v in prior.items()))
            cli_out = io.StringIO()
            self._zero_counts()
            with contextlib.redirect_stdout(cli_out):
                rc = mc_main([spec, "--quiet", "--out",
                              os.path.join(work, "cli")])
            counts = self._counts()
            line = json.loads(cli_out.getvalue().strip().splitlines()[-1])
            if rc != 0 or line["artifact_sha256"] != ref[1] or counts != dict(
                    no_kernels, rng_field=2 * MC_TRIALS // MC_CHUNK):
                raise AssertionError(f"the CLI: rc {rc}, fingerprint "
                                     f"{line['artifact_sha256'][:16]}, "
                                     f"launches {counts}")
            log(f"  (a) python -m psrsigsim_torch.mc on a spec of the same "
                f"study, default device: artifact fingerprint equal, launches "
                f"{counts}")

            # the host: trials 0-31 with device="cpu"
            host = MonteCarloStudy.from_simulation(
                Simulation(psrdict=MC_BENCH, device="cpu"), MC_PRIORS, seed=1)
            pc = host.sampled_params(32)
            if not (np.array_equal(pc, study.sampled_params(32))
                    and np.array_equal(pc, res.metrics[:32, :2])):
                raise AssertionError("sampled parameters differ between the "
                                     "card and the host")
            os.environ["PSS_SAMPLER"] = "hw"
            try:
                t0 = time.perf_counter()
                rh = host.run(32, chunk_size=32)
                t_host = time.perf_counter() - t0
            finally:
                os.environ.pop("PSS_SAMPLER", None)
            got, want = res.metrics[:32], rh.metrics
            names = list(study.metric_names)
            shift = [names.index(n) for n in ("toa_err", "toa_rms")]
            rel = [names.index(n) for n in ("toa_sigma", "fit_amp")]
            d_shift = np.abs(got[:, shift] - want[:, shift]).max()
            d_rel = np.abs(got[:, rel] / want[:, rel] - 1).max()
            log(f"  (a) trials 0-31 against device='cpu' (PSS_SAMPLER=hw, the "
                f"kernel's plain version; {t_host:.2f} s on the host): "
                f"parameters bit-equal; toa_err/toa_rms max abs diff "
                f"{d_shift:.3g} turns (limit 2e-6), toa_sigma/fit_amp max rel "
                f"diff {d_rel:.3g} (limit 1e-4)")
            if d_shift > 2e-6 or d_rel > 1e-4:
                raise AssertionError("card and host metric rows differ beyond "
                                     "the FFTFIT tolerance")

            # kill after the first commit, then resume
            killed = os.path.join(work, "killed")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), MC_KILL_CHILD,
                 killed, os.path.join(work, "kill_plan")],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != -9:
                raise AssertionError(
                    f"the child exited {proc.returncode}, expected SIGKILL:\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            with open(os.path.join(killed, "mc_journal.jsonl")) as fh:
                starts = [json.loads(line)["start"] for line in fh]
            if starts != [0] or os.path.exists(
                    os.path.join(killed, "study_result.json")):
                raise AssertionError(f"the killed run left journal records "
                                     f"{starts} or an artifact")
            t_kill = time.perf_counter() - t0
            _, counts, _, _ = run(study, "(a) resume after SIGKILL",
                                  MC_TRIALS, MC_CHUNK, out_dir=killed)
            if counts != dict(no_kernels, rng_field=2):
                raise AssertionError(f"the resume launched {counts}")
            if artifact(killed) != clean:
                raise AssertionError("the resumed study differs from the "
                                     "clean run")
            log(f"  (a) child SIGKILLed by mc.kill after chunk 0's commit "
                f"({t_kill:.1f} s); the resume ran one chunk; trials.f32, "
                "the journal and the artifact byte-identical to the clean run")

            # integrity: host.corrupt on the second chunk, healed
            integ = os.path.join(work, "integ")
            plan = FaultPlan(os.path.join(work, "integ_plan"),
                             {"host.corrupt": {"after_start": MC_CHUNK}})
            _, counts, _, _ = run(study, "(a) integrity=True, host.corrupt",
                                  MC_TRIALS, MC_CHUNK, out_dir=integ,
                                  integrity=True, faults=plan)
            with open(os.path.join(integ, "study_manifest.json")) as fh:
                st = json.load(fh)["integrity"]
            with open(os.path.join(integ, "mc_journal.jsonl")) as fh:
                events = [(r["kind"], r["start"]) for r in map(json.loads, fh)
                          if r["e"] == "integrity"]
            got_art = artifact(integ)
            if not (st["checksum_mismatches"] == 1 and st["healed_chunks"] == 1
                    and st["permanent_failures"] == 0
                    and events == [("checksum", MC_CHUNK)]
                    and {k: got_art[k] for k in ("study_result.json",
                                                 "trials.npy", "trials.f32")}
                    == {k: clean[k] for k in ("study_result.json",
                                              "trials.npy", "trials.f32")}):
                raise AssertionError(f"integrity: stats {st}, events {events}"
                                     ", or the artifact differs")
            log(f"  (a) integrity: {json.dumps(st, sort_keys=True)}; journal "
                f"events {events}; artifact equal to the clean run's")

            # (b) the facade at BASELINE config 1's full width
            sim = Simulation(psrdict=main_psrdict(), device=self.dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self._zero_counts()
            t0 = time.perf_counter()
            res_b = sim.run_mc_study(MC_PRIORS, MC_FACADE_TRIALS, seed=1,
                                     out_dir=os.path.join(work, "facade"),
                                     chunk_size=MC_FACADE_CHUNK)
            torch.cuda.synchronize()
            t_b = time.perf_counter() - t0
            counts = self._counts()
            peak_b = torch.cuda.max_memory_allocated()
            launches_b = counts
            if counts != dict(no_kernels, rng_field=2 * MC_FACADE_TRIALS
                              // MC_FACADE_CHUNK):
                raise AssertionError(f"run_mc_study launches {counts}")
            check_rows(res_b, MC_FACADE_TRIALS, ("dm", "noise_scale"))
            log(f"  (b) Simulation(BASELINE config 1).run_mc_study("
                f"{MC_FACADE_TRIALS}, chunk_size={MC_FACADE_CHUNK}): "
                f"{t_b:.3f} s = {MC_FACADE_TRIALS / t_b:.1f} trials/s (first "
                f"run: cuFFT plans, the artifact's writes); peak device memory "
                f"{peak_b / 2**30:.3f} GiB; launches {counts} "
                f"({self.card_line})")
            study_b = MonteCarloStudy.from_simulation(sim, MC_PRIORS, seed=1)
            params = study_b.sampled_params(MC_FACADE_TRIALS)
            if not np.array_equal(params, res_b.metrics[:, :2]):
                raise AssertionError("sampled_params differ from the study's "
                                     "parameter columns")
            rb2, _, t_b2, peak_b2 = run(study_b, "(b) steady run, in memory",
                                        MC_FACADE_TRIALS, MC_FACADE_CHUNK)
            if not np.array_equal(rb2.metrics, res_b.metrics):
                raise AssertionError("the steady run differs from "
                                     "run_mc_study's")
            bridge = sim.to_ensemble().to_mc_study(MC_PRIORS, seed=1)
            rb3 = bridge.run(32, chunk_size=32)
            if bridge.device.type != "cuda" or not np.array_equal(
                    rb3.metrics, res_b.metrics[:32]):
                raise AssertionError("FoldEnsemble.to_mc_study's trials "
                                     "differ from run_mc_study's")
            log("  (b) Simulation.to_ensemble().to_mc_study(): on the card, "
                "trials 0-31 (one 32-trial chunk) equal run_mc_study's rows")
            self.device_breakdown(
                "(b)", lambda: study_b._chunk_program(
                    0, MC_FACADE_TRIALS, MC_FACADE_CHUNK, MC_FACADE_CHUNK))
            exp_dir = os.path.join(work, "export")
            self._zero_counts()
            t0 = time.perf_counter()
            exp = study_b.export_psrfits(MC_FACADE_TRIALS, exp_dir, TEMPLATE,
                                         writers=1, chunk_size=MC_FACADE_CHUNK)
            torch.cuda.synchronize()
            t_exp = time.perf_counter() - t0
            counts = self._counts()
            if counts != dict(no_kernels, fold_quantize=2):
                raise AssertionError(f"export_psrfits launches {counts}")
            ens = sim.to_ensemble()
            direct = supervised_export(
                ens, MC_FACADE_TRIALS, os.path.join(work, "direct"), TEMPLATE,
                ens.pulsar, seed=1, dms=params[:, 0].astype(np.float64),
                noise_norms=(np.float32(study_b.noise_norm)
                             * params[:, 1]).astype(np.float64),
                writers=1, chunk_size=MC_FACADE_CHUNK)
            if len(exp.paths) != MC_FACADE_TRIALS or [
                    sha(p) for p in exp.paths] != [sha(p) for p in
                                                   direct.paths]:
                raise AssertionError("export_psrfits' files differ from the "
                                     "direct supervised export's")
            with open(os.path.join(exp_dir, "export_manifest.json")) as fh:
                if "mc_study" not in json.load(fh):
                    raise AssertionError("no mc_study stamp in the manifest")
            log(f"  (b) export_psrfits({MC_FACADE_TRIALS}, supervised, 1 "
                f"writer): {t_exp:.3f} s = {MC_FACADE_TRIALS / t_exp:.1f} "
                f"obs/s, launches {counts}; every file's sha256 equal to "
                "supervised_export of the facade's ensemble with the study's "
                "DMs and float32 noise norms; manifest stamped mc_study")
            log(f"  phase 11 summary: (a) {MC_TRIALS / t_ss:.1f} trials/s, "
                f"peak {peak / 2**30:.3f} GiB, launches {launches_a}; (b) "
                f"{MC_FACADE_TRIALS / t_b2:.1f} trials/s, peak "
                f"{peak_b2 / 2**30:.3f} GiB, launches {launches_b}; "
                f"export_psrfits launches {counts} ({self.card_line})")
        finally:
            os.environ.pop("PSS_SAMPLER", None)
            shutil.rmtree(work, ignore_errors=True)

    # -- 12 -----------------------------------------------------------------
    def scenarios(self):
        """The scenario engine on the card (see the module docstring)."""
        import dataclasses
        import hashlib
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.io import FitsFile
        from psrsigsim_torch.mc import MonteCarloStudy
        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.parallel import FoldEnsemble
        from psrsigsim_torch.runtime import supervised_export
        from psrsigsim_torch.simulate import (Simulation,
                                              fold_pipeline_quantized,
                                              pipeline)

        torch = self.torch
        dev = self.dev
        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_INTEGRITY", None)
        free = self.main_ensemble()
        cfg = free.cfg

        def scen_ens(stack, cfg=cfg, prof=None, device=dev):
            return FoldEnsemble.from_config(
                cfg, free._profiles_np if prof is None else prof,
                free.noise_norm, dm=free.dm, device=device, scenario=stack)

        def expect(counts, label, **want):
            want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                    **want}
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"{want}")

        worst = 0

        def fused_vs_unfused(e, n, label):
            """The fused route and the unfused scenario body (sampler
            kernel fields + the PyTorch body) on the same rows."""
            nonlocal worst
            idx = np.arange(n)
            keys, dms, norms = e._prep_chunk(idx, 0, None, None)
            sp = scenario_params(n, e.scenario)
            rows = e._rows(keys, norms, e._prep_scenario(idx, sp))
            how = fq.route(("chi2_wh", "chi2_wh"), e.cfg.nph, e.cfg.nsub)
            got = fold_pipeline_quantized(
                keys, dms, norms, e._profiles, e.cfg, freqs=e._freqs,
                chan_ids=e._chan_ids, rows=rows)
            want = e._unfused_packed(keys, dms, norms, "little", rows)
            err = int((got[0].int() - want[0].int()).abs().max())
            worst = max(worst, err)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label}: the fused kernel differs from "
                                     f"the unfused scenario path (max |diff| "
                                     f"{err})")
            log(f"  {label} {tuple(got[0].shape)} [{how}]: bit-equal to the "
                "unfused scenario path (max |diff| 0)")
            return how, got

        # (a) the scenario kernel on the main path
        ens = scen_ens(SCEN_STACK)
        sp = scenario_params(MAIN_NOBS)
        torch.cuda.synchronize()
        self._zero_counts()
        t0 = time.perf_counter()
        d, s, o, fin, rfi = ens.run_quantized(
            MAIN_NOBS, seed=0, return_finite=True, return_rfi=True,
            scenario_params=sp)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = self._counts()
        expect(counts, f"run_quantized({MAIN_NOBS}) with {SCEN_STACK}",
               fold_quantize=1)
        self.kernels["fold_quantize"]["scenario_launches"] = \
            counts["fold_quantize"]
        if not bool(fin.all()) or not bool(rfi.any()) or int(d.min()) < -32767:
            raise AssertionError("scenario run_quantized: non-finite rows, no "
                                 "RFI or codes out of range")
        log(f"  (a) run_quantized({MAIN_NOBS}) with {SCEN_STACK}, "
            f"per-observation parameters: {t_first:.3f} s, launches {counts}; "
            f"RFI in {int(rfi.any(dim=(1, 2)).sum())} observations, "
            f"{int(rfi.sum())} cells")
        _, packed = fused_vs_unfused(ens, MAIN_NOBS, "(a) main path, "
                                     "scintillation + rfi + lognormal")
        if not all(torch.equal(a, b) for a, b in zip(
                ens._split_packed_device(packed[0]), (d, s, o))):
            raise AssertionError("run_quantized differs from the fused route")
        del packed
        for stack in (["scintillation", "rfi", "single_pulse:powerlaw"],
                      ["scintillation", "rfi", "single_pulse:frb"], ["rfi"]):
            fused_vs_unfused(scen_ens(stack), MAIN_NOBS,
                             f"(a) main path, {'+'.join(stack)}")
        # an edge shape: 1000 bins a row, the general kernel's route
        r = np.random.default_rng(3)
        edge_cfg = dataclasses.replace(cfg, nph=1000)
        edge = scen_ens(SCEN_STACK, cfg=edge_cfg, prof=r.uniform(
            0.05, 1.0, (cfg.meta.nchan, 1000)).astype(np.float32))
        how, _ = fused_vs_unfused(edge, 16, "(a) edge shape nph 1000")
        if how != "staged":
            raise AssertionError(f"the edge shape took the {how} route")
        self.kernels["fold_quantize"]["scenario_max_abs_err"] = float(worst)

        # the codes of observations 0-7 do not depend on the batch width,
        # with the scenario's factors as without (phase 5)
        self.batch_widths(ens, sp, "scenario")

        # observations 0-7 on the host (the kernel's plain version), against
        # the card
        host = scen_ens(SCEN_STACK, device="cpu")
        hp = {k: (v[:SCEN_HOST_NOBS] if np.ndim(v) else v)
              for k, v in sp.items()}
        n8 = SCEN_HOST_NOBS
        d, s, o, fin, rfi = (t[:n8] for t in (d, s, o, fin, rfi))
        os.environ["PSS_SAMPLER"] = "hw"
        try:
            t0 = time.perf_counter()
            hd, hs, ho, hf, hr = (t.numpy() for t in host.run_quantized(
                SCEN_HOST_NOBS, seed=0, return_finite=True, return_rfi=True,
                scenario_params=hp))
            t_host = time.perf_counter() - t0
        finally:
            os.environ.pop("PSS_SAMPLER", None)
        diff = d[:n8].cpu().numpy().astype(np.int32) - hd.astype(np.int32)
        frac = float(np.mean(diff != 0))
        log(f"  (a) observations 0-{n8 - 1}, card against host: codes "
            f"{frac:.3g} differ, max |diff| {np.abs(diff).max()} LSB; scl "
            f"max rel diff {np.abs(s[:n8].cpu().numpy() / hs - 1).max():.3g}")
        if not (np.array_equal(rfi[:n8].cpu().numpy(), hr)
                and np.array_equal(fin[:n8].cpu().numpy(), hf)):
            raise AssertionError("the truth mask or the finite guard differs "
                                 "between the card and the host")
        if np.abs(diff).max() > 1 or frac > 1e-2:
            raise AssertionError("scenario codes differ from the host beyond "
                                 "1 LSB on 1%")
        np.testing.assert_allclose(s[:n8].cpu().numpy(), hs, rtol=1e-5)
        np.testing.assert_allclose(o[:n8].cpu().numpy(), ho, rtol=1e-5)
        log(f"  (a) observations 0-{n8 - 1} against device='cpu' "
            f"(PSS_SAMPLER=hw, {t_host:.2f} s on the host): truth mask and "
            f"finite guard equal; codes {frac:.3g} differ, max |diff| "
            f"{np.abs(diff).max()} LSB (limit 1 on 1%)")
        del host, hd

        # the kernel's time with and without the factors, in turns
        a, kw, (keys, dms, norms) = self.main_fused_args()
        rows = ens._rows(keys, norms, ens._prep_scenario(
            np.arange(MAIN_NOBS), sp))
        fac = dict(gain=rows.gain.contiguous(), energy=rows.energy.contiguous(),
                   level=rows.level.contiguous())
        times = {"free": [], "scenario": []}
        for turn in ("free", "scenario", "scenario", "free"):
            extra = fac if turn == "scenario" else {}
            times[turn].append(cuda_time_ms(
                lambda: fq.fold_quantize(**a, **kw, **extra), 20))
        plain_ms = cuda_time_ms(lambda: fq.fold_quantize_plain(**a, **kw,
                                                               **fac), 1)
        B, C, nph = a["prof"].shape
        nsub = kw["nsub"]
        n = B * C * nsub * nph
        nbytes = (4 * B * C * nph + 2 * B * nsub * C * (nph + 4)
                  + B * nsub * C + B * (2 * 8 + 2 * 4 + 4))
        b_free, _, _ = bound(FUSED_OPS, n, nbytes)
        b_ms, b_by, parts = bound(SCEN_OPS, n, nbytes
                                  + 4 * (2 * B * C * nsub + B * nsub))
        ms = min(times["scenario"])
        self.kernels["fold_quantize"].update(
            scenario_ms=ms, scenario_plain_ms=plain_ms, scenario_bound_ms=b_ms,
            scenario_bound_by=b_by)
        log(f"  (a) fold_quantize with gain, energy and level: "
            + ", ".join(f"{t:.4f}" for t in times["scenario"])
            + f" ms ({b_ms / ms:.1%} of its bound {b_ms:.4f} ms, {b_by}: "
            f"{fmt_parts(parts)}); without: "
            + ", ".join(f"{t:.4f}" for t in times["free"])
            + f" ms (bound {b_free:.4f}); plain {plain_ms:.2f} ms "
            f"({self.card_line})")
        del rows, fac

        # the host's draws of one chunk's factors, and steady chunks
        idx = np.arange(MAIN_NOBS)
        host_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ens._rows(keys, norms, ens._prep_scenario(idx, sp))
            host_ms.append(1e3 * (time.perf_counter() - t0))
        walls = {}
        for label, e, kwargs in (("free", free, {}),
                                 ("scenario", ens, {"scenario_params": sp})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                out = e.run_quantized(MAIN_NOBS, seed=0, **kwargs)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) / 5
            del out
        log(f"  (a) host ms to draw one {MAIN_NOBS}-observation chunk's "
            f"factors (scenario_rows): " + ", ".join(
                f"{t:.1f}" for t in host_ms)
            + f"; steady run_quantized({MAIN_NOBS}): scenario "
            f"{walls['scenario'] * 1e3:.2f} ms = "
            f"{MAIN_NOBS / walls['scenario']:.1f} obs/s, scenario-free "
            f"{walls['free'] * 1e3:.2f} ms = {MAIN_NOBS / walls['free']:.1f} "
            f"obs/s ({host_cpu()})")
        self.kernels["fold_quantize"]["scenario_host_rows_ms"] = min(host_ms)
        del d, s, o, fin, rfi

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="scenario-", dir=build)
        try:
            # (b) the supervised export with RFI provenance
            exp = geometry(MAIN, dev, scenario=SCEN_STACK)
            sp2 = scenario_params(SCEN_SUP_NOBS)
            out = os.path.join(work, "sup")
            self._zero_counts()
            t0 = time.perf_counter()
            res = supervised_export(exp, SCEN_SUP_NOBS, out, TEMPLATE,
                                    exp.pulsar, seed=0, chunk_size=MAIN_NOBS,
                                    writers=1, scenario_params=sp2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            expect(self._counts(), "(b) supervised export", fold_quantize=2)

            def hashes():
                outp = {}
                for name in sorted(os.listdir(out)):
                    if name.endswith(".fits"):
                        with open(os.path.join(out, name), "rb") as fh:
                            outp[name] = hashlib.sha256(fh.read()).hexdigest()
                return outp

            clean = hashes()
            check = (0, 1, MAIN_NOBS - 1, MAIN_NOBS, SCEN_SUP_NOBS - 1)
            for start in range(0, SCEN_SUP_NOBS, MAIN_NOBS):
                # the export's chunk, at the export's batch width
                rd, rs, ro, _ = (t.cpu().numpy() for t in exp.run_quantized_at(
                    np.arange(start, start + MAIN_NOBS), seed=0,
                    scenario_params=sp2))
                for i in (i for i in check if start <= i < start + MAIN_NOBS):
                    sub = FitsFile.read(res.paths[i])["SUBINT"].data
                    j = i - start
                    if not (np.array_equal(sub["DATA"][:, 0].view(">i2"), rd[j])
                            and np.array_equal(sub["DAT_SCL"], rs[j])
                            and np.array_equal(sub["DAT_OFFS"], ro[j])):
                        raise AssertionError(f"the file of observation {i} "
                                             "differs from run_quantized")
                del rd, rs, ro
            # the RFI provenance against the host's truth masks
            host = scen_ens(SCEN_STACK, device="cpu")
            want = {}
            for start in range(0, SCEN_SUP_NOBS, MAIN_NOBS):
                ids = np.arange(start, start + MAIN_NOBS)
                hk, _, hn = host._prep_chunk(ids, 0, None, None)
                m = host._rows(hk, hn, host._prep_scenario(ids, sp2)).mask
                cells = m.sum(dim=(1, 2)).numpy()
                want.update({int(i): int(c) for i, c in zip(ids, cells) if c})
            with open(os.path.join(out, "run_journal.jsonl")) as fh:
                recs = [json.loads(line) for line in fh]
            got = {}
            for rec in recs:
                if rec["e"] == "rfi":
                    got.update(zip(rec["obs"], rec["cells"]))
            with open(os.path.join(out, "export_manifest.json")) as fh:
                man = json.load(fh)
            block = {"obs_with_rfi": len(want),
                     "contaminated_cells": sum(want.values())}
            if got != want or {k: man["rfi"][k] for k in block} != block:
                raise AssertionError(f"RFI provenance differs from the host's "
                                     f"truth: manifest {man.get('rfi')}, "
                                     f"host {block}")
            log(f"  (b) supervised_export({SCEN_SUP_NOBS}, chunk_size="
                f"{MAIN_NOBS}, writers=1): {wall:.3f} s = "
                f"{SCEN_SUP_NOBS / wall:.1f} obs/s, fused kernel twice; files "
                f"of observations {list(check)} hold run_quantized_at's "
                "triples of their chunk; "
                f"journal rfi records and manifest rfi block {block} equal the "
                "host's truth masks")
            for i in (MAIN_NOBS + 2, SCEN_SUP_NOBS - 3):
                os.remove(res.paths[i])
            self._zero_counts()
            supervised_export(exp, SCEN_SUP_NOBS, out, TEMPLATE, exp.pulsar,
                              seed=0, chunk_size=MAIN_NOBS, writers=1,
                              scenario_params=sp2, resume="verify")
            expect(self._counts(), "(b) verify resume", fold_quantize=1)
            with open(os.path.join(out, "export_manifest.json")) as fh:
                if hashes() != clean or json.load(fh)["rfi"] != man["rfi"]:
                    raise AssertionError("the verify resume changed the files "
                                         "or the rfi block")
            log("  (b) two files of chunk 1 deleted, resume='verify': the fused "
                "kernel launched once, files and rfi block equal the clean run")
            del exp

            # (c) the facade
            fe = Simulation(psrdict=main_psrdict(), device=dev).to_ensemble(
                scenario=SCEN_STACK)
            self._zero_counts()
            fd = fe.run_quantized(MAIN_NOBS, seed=0, scenario_params=sp)
            torch.cuda.synchronize()
            expect(self._counts(), "(c) Simulation.to_ensemble(scenario=)"
                   ".run_quantized", fold_quantize=1)
            ed = ens.run_quantized(MAIN_NOBS, seed=0, scenario_params=sp)
            if not all(torch.equal(x, y) for x, y in zip(fd, ed)):
                raise AssertionError("the facade's scenario ensemble differs")
            log(f"  (c) Simulation.to_ensemble(scenario={SCEN_STACK})"
                f".run_quantized({MAIN_NOBS}): the fused kernel once, "
                "bit-equal to (a)")
            del fe, fd, ed
        finally:
            shutil.rmtree(work, ignore_errors=True)

        # (d) a study with scenario priors on the bench MC geometry
        priors = dict(MC_PRIORS,
                      scint_mod={"dist": "uniform", "lo": 0.2, "hi": 1.0},
                      sp_sigma={"dist": "uniform", "lo": 0.1, "hi": 1.0})
        study = MonteCarloStudy.from_simulation(
            Simulation(psrdict=MC_BENCH, device=dev), priors, seed=1)
        self._zero_counts()
        t0 = time.perf_counter()
        res = study.run(MC_TRIALS, chunk_size=MC_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect(self._counts(), "(d) study", rng_field=2 * MC_TRIALS // MC_CHUNK)
        t0 = time.perf_counter()
        res2 = study.run(MC_TRIALS, chunk_size=MC_CHUNK // 2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        if not np.array_equal(res.metrics, res2.metrics) or not np.isfinite(
                res.metrics).all():
            raise AssertionError("study rows differ between chunk sizes "
                                 f"{MC_CHUNK} and {MC_CHUNK // 2}")
        host = MonteCarloStudy.from_simulation(
            Simulation(psrdict=MC_BENCH, device="cpu"), priors, seed=1)
        os.environ["PSS_SAMPLER"] = "hw"
        try:
            rh = host.run(32, chunk_size=32)
        finally:
            os.environ.pop("PSS_SAMPLER", None)
        names = list(study.metric_names)
        npar = len(study.param_names)
        got, want = res.metrics[:32], rh.metrics
        shift = [names.index(k) for k in ("toa_err", "toa_rms")]
        rel = [names.index(k) for k in ("toa_sigma", "fit_amp")]
        d_shift = np.abs(got[:, shift] - want[:, shift]).max()
        d_rel = np.abs(got[:, rel] / want[:, rel] - 1).max()
        if not np.array_equal(got[:, :npar], want[:, :npar]) or \
                d_shift > 2e-6 or d_rel > 1e-4:
            raise AssertionError("study rows differ from the host beyond the "
                                 "FFTFIT tolerance")
        log(f"  (d) study {study._scenario.labels()} from priors "
            f"{sorted(priors)}: run({MC_TRIALS}, chunk_size={MC_CHUNK}) "
            f"{wall:.3f} s = {MC_TRIALS / wall:.1f} trials/s (first run), "
            f"chunk_size={MC_CHUNK // 2} {MC_TRIALS / wall2:.1f} trials/s; "
            f"the sampler {2 * MC_TRIALS // MC_CHUNK} times; rows "
            f"bit-identical for chunk "
            f"sizes {MC_CHUNK} and {MC_CHUNK // 2}; trials 0-31 against "
            f"device='cpu': parameters bit-equal, toa_err/toa_rms max abs "
            f"diff {d_shift:.3g} turns, toa_sigma/fit_amp max rel diff "
            f"{d_rel:.3g}")

    # -- 13 -----------------------------------------------------------------
    def search(self):
        """SEARCH mode at BASELINE config 4's full width (see the module
        docstring)."""
        torch = self.torch
        import dataclasses

        import numpy as np

        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.simulate import single_pipeline
        from psrsigsim_torch.utils import key, stage_key

        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_EXACT_SHIFT", None)
        dev = self.dev
        cfg, prof, nn = config4()
        C, L = cfg.meta.nchan, cfg.nsamp
        n = C * L
        log(f"  config4_search_null: nchan {C} nph {cfg.nph} nsub {cfg.nsub} "
            f"nsamp {L} n_null {cfg.n_null} noise_norm {nn:.6g} "
            f"off_pulse_mean {cfg.off_pulse_mean:.3g}")

        # (a) the flat layout against its plain version, bit for bit
        tile = rng_hw.FLAT_TILE
        keys = stage_key(stage_key(key(0, dev), "user",
                                   torch.arange(2, device=dev)), "pulse")
        seeds = rng_hw.seed_words(keys).contiguous()
        worst = 0.0
        cases = [("chi2_1", 0.0, 0, 0, n, "a full config-4 field")]
        for mode, df in (("normal", 0.0), ("chi2_1", 0.0), ("chi2_wh", 99.0),
                         ("chi2_sel", (1.0, 99.0))):
            cases += [(mode, df, 5, 12345, 1_000_000, "unaligned f0"),
                      (mode, df, 0, 0, 3 * tile + 4097, "not a whole tile")]
        for mode, df, b0, skip, length, what in cases:
            dfs = torch.tensor(df if isinstance(df, tuple) else (df, df),
                               dtype=torch.float32, device=dev)
            pos = torch.tensor([[0, b0], [0, b0 + 7]], dtype=torch.int32,
                               device=dev)
            got = rng_hw.rng_flat_field(seeds, dfs, pos, mode, skip, length)
            want = rng_hw.rng_flat_field_plain(seeds, dfs, pos, mode, skip,
                                               length)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            log(f"  flat {mode:8s} df={df} f0={b0 * tile + skip} length "
                f"{length} ({what}): max|kernel-plain| {err:.3g}")
            if not torch.equal(got, want):
                raise AssertionError(f"the flat layout differs from its plain "
                                     f"version ({mode}, {what})")
            del got, want
        self.kernels["rng_flat_field"]["max_abs_err"] = worst

        # (b) the main path: single_pipeline over a batch at full width
        hk = stage_key(key(0, "cpu"), "user", torch.arange(SEARCH_NOBS))
        dms = torch.full((SEARCH_NOBS,), CONFIG4["dm"])
        nns = torch.full((SEARCH_NOBS,), nn, dtype=torch.float32)
        pdev = torch.as_tensor(prof, device=dev)
        freqs = torch.as_tensor(np.asarray(cfg.meta.dat_freq_mhz(),
                                           np.float32), device=dev)

        def run(k=hk, c=cfg, **kw):
            return single_pipeline(k, dms[:k.shape[0]], nns[:k.shape[0]],
                                   pdev, c, freqs=freqs,
                                   chan_ids=torch.arange(C), **kw)

        run(hk[:1])
        torch.cuda.synchronize()
        self._zero_counts()
        t0 = time.perf_counter()
        block = run()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = self._counts()
        want = {"rng_field": 1, "fold_quantize": 0, "packed_digest": 0,
                "rng_flat_field": 2}
        if counts != want:
            raise AssertionError(f"single_pipeline({SEARCH_NOBS}): launches "
                                 f"{counts}, expected {want}")
        self.kernels["rng_flat_field"]["launches"] = counts["rng_flat_field"]
        self._path(f"13 single_pipeline({SEARCH_NOBS})", counts)
        if tuple(block.shape) != (SEARCH_NOBS, C, L) or not bool(
                torch.isfinite(block).all()):
            raise AssertionError("single_pipeline: wrong shape or non-finite")
        # channel means: draw_norm * <profile> over the live pulses + the
        # noise level; the nulled fraction holds off-pulse noise instead
        live = 1.0 - cfg.n_null / cfg.nsub
        expect = (cfg.draw_norm * prof.astype(np.float64).mean(axis=1) * live
                  * (cfg.nsub * cfg.nph / L) + cfg.noise_df * nn)
        rel = np.abs(block.double().mean(dim=(0, 2)).cpu().numpy() / expect
                     - 1)
        log(f"  single_pipeline({SEARCH_NOBS}) at {C} x {L}: first "
            f"{t_first:.3f} s, launches {counts}; channel means vs "
            f"expectation: max rel dev {rel.max():.3g}")
        if rel.max() > 0.02:
            raise AssertionError("SEARCH channel means off by > 2%")
        del block
        reps = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = run()
        torch.cuda.synchronize()
        t_ss = (time.perf_counter() - t0) / reps
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        wall, busy, nev, by_name, _ = device_profile(torch, run)
        log(f"  steady single_pipeline({SEARCH_NOBS}): {t_ss * 1e3:.2f} ms = "
            f"{SEARCH_NOBS / t_ss:.1f} obs/s = "
            f"{SEARCH_NOBS * n / t_ss / 1e9:.2f} Gsamples/s; peak memory "
            f"{peak / 2**30:.3f} GiB; profiled wall {wall * 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms ({busy / 1e6 / wall:.1%}), "
            f"{nev} device events ({self.card_line})")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
            log(f"  {us / 1e3:9.3f} ms {k:4d}x  {name[:100]}")
        self.search_rate = (SEARCH_NOBS / t_ss, peak)

        # (c) the card against the host: observations 0-1 at full width,
        # scenario-free and with every effect
        nh = SEARCH_HOST_NOBS
        stack = ["scintillation", "rfi", "single_pulse:lognormal"]
        sp = {"rfi_imp_prob": 0.3, "rfi_nb_prob": 0.3, "scint_mod": 0.8}
        for label, kw in (("scenario-free", {}),
                          ("scintillation + rfi + lognormal",
                           {"scenario": stack, "scenario_params": sp})):
            self._zero_counts()
            card = run(hk[:nh], **kw).cpu().numpy()
            counts = self._counts()
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}")
            os.environ["PSS_SAMPLER"] = "hw"
            try:
                t0 = time.perf_counter()
                host = single_pipeline(hk[:nh], dms[:nh], nns[:nh], prof,
                                       cfg, device="cpu", **kw).numpy()
                t_host = time.perf_counter() - t0
            finally:
                os.environ.pop("PSS_SAMPLER", None)
            peak_v = np.abs(host).max()
            err = np.abs(card - host)
            bad = err > 1e-5 * np.abs(host) + 1e-5 * peak_v
            log(f"  (c) {label}: observations 0-{nh - 1} against "
                f"device='cpu' (PSS_SAMPLER=hw, {t_host:.1f} s on "
                f"the host): max|diff| {err.max():.3g} (peak {peak_v:.3g}), "
                f"{int(bad.sum())} beyond rtol 1e-5 + 1e-5 of the peak; "
                f"bit-equal {np.mean(card == host):.4f}")
            if bad.any():
                raise AssertionError(f"{label}: the card differs from the host")

        # (d) the same observations at another batch width: bit-equal
        two = run(hk[:nh])
        again = run()[:nh]
        if not torch.equal(two, again):
            raise AssertionError("SEARCH blocks depend on the batch width")
        log(f"  (d) observations 0-{nh - 1} in a batch of {nh} and of "
            f"{SEARCH_NOBS}: bit-equal")
        del two, again

        # (e) the exact (full-stream) shift on two observations; cuFFT plans
        # the length-L transform on its first use, outside the timing
        fcfg = dataclasses.replace(cfg, shift_mode="fft")
        run(hk[:1], c=fcfg)
        torch.cuda.synchronize()
        self._zero_counts()
        t0 = time.perf_counter()
        fb = run(hk[:nh], c=fcfg)
        torch.cuda.synchronize()
        t_fft = time.perf_counter() - t0
        counts = self._counts()
        if counts != want or not bool(torch.isfinite(fb).all()):
            raise AssertionError(f"exact shift: launches {counts} or "
                                 "non-finite samples")
        log(f"  (e) PSS_EXACT_SHIFT mode, {nh} observations: "
            f"{t_fft * 1e3:.1f} ms, launches {counts}")
        del fb

        # (f) the flat layout's time at the main path's shape
        fk = stage_key(stage_key(key(0, dev), "user",
                                 torch.arange(SEARCH_NOBS, device=dev)),
                       "pulse")
        fseeds = rng_hw.seed_words(fk).contiguous()
        fdfs = torch.zeros(SEARCH_NOBS, device=dev)
        fpos = torch.zeros((SEARCH_NOBS, 2), dtype=torch.int32, device=dev)
        ms = cuda_time_ms(lambda: rng_hw.rng_flat_field(
            fseeds, fdfs, fpos, "chi2_1", 0, n), 10)

        def plain_fields():   # one field at a time bounds the temporaries
            for b in range(SEARCH_NOBS):
                rng_hw.rng_flat_field_plain(fseeds[b:b + 1], fdfs[b:b + 1],
                                            fpos[b:b + 1], "chi2_1", 0, n)

        plain_ms = cuda_time_ms(plain_fields, 1)
        library_ms = cuda_time_ms(lambda: torch.randn(
            (SEARCH_NOBS, n), device=dev), 10)
        total = SEARCH_NOBS * n
        b_ms, b_by, parts = bound(FLAT_OPS, total,
                                  4 * total + SEARCH_NOBS * (8 + 4 + 8))
        self.kernels["rng_flat_field"].update(
            name="rng_flat_field", route="cuda",
            source="psrsigsim_torch/csrc/rng_field.cu",
            replaces="psrsigsim_tpu/ops/rng_pallas.py:115 (flat order: "
                     "psrsigsim_tpu/ops/stats.py:266-354)",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
        log(f"  rng_flat_field ({SEARCH_NOBS} x {n}, chi2_1): {ms:.4f} ms = "
            f"{ms / SEARCH_NOBS:.4f} ms per field, {b_ms / ms:.1%} of its "
            f"bound {b_ms:.4f} ms, {b_by} ({fmt_parts(parts)}); plain "
            f"{plain_ms:.1f} ms ({SEARCH_NOBS} fields, one call each); "
            f"torch.randn {library_ms:.4f} ms ({self.card_line})")

    # -- 14 -----------------------------------------------------------------
    def datasets(self):
        """The dataset factory on the card (see the module docstring)."""
        torch = self.torch
        import hashlib
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.datasets import DatasetFactory, DatasetReader
        from psrsigsim_torch.runtime import FaultPlan, StageTimers
        from psrsigsim_torch.runtime.integrity import scrub_dataset_dir

        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_INTEGRITY", None)
        dev = self.dev
        spec = DATASET_SPEC
        nrec = spec["n_records"]
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="dataset-", dir=build)

        def corpus_sha(out):
            h = hashlib.sha256()
            for name in sorted(os.listdir(out)):
                if name.startswith("shard-"):
                    with open(os.path.join(out, name), "rb") as fh:
                        h.update(name.encode() + fh.read())
            return h.hexdigest()

        def flat_only(chunks):
            return {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                    "rng_flat_field": 2 * chunks}

        try:
            # (a) a clean corpus in 64-record chunks, twice (the second
            # steady), then in 37-record chunks: byte-identical
            runs = {}
            for label, chunk in (("first", 64), ("steady", 64),
                                 ("chunk 37", 37)):
                out = os.path.join(work, label.replace(" ", ""))
                tel = StageTimers()
                fac = DatasetFactory(spec, device=dev)
                self._zero_counts()
                t0 = time.perf_counter()
                res = fac.run(out, chunk_size=chunk, telemetry=tel)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = self._counts()
                nchunks = -(-nrec // chunk)
                if counts != flat_only(nchunks):
                    raise AssertionError(f"{label}: launches {counts}, "
                                         f"expected {flat_only(nchunks)}")
                runs[label] = (out, corpus_sha(out), wall, res)
                snap = res["telemetry"]
                stages = ", ".join(
                    f"{st} {snap[f'{st}_s']:.3f} s"
                    for st in ("dispatch", "fetch", "encode", "write")
                    if f"{st}_s" in snap) + f" (bottleneck {snap['bottleneck']})"
                log(f"  (a) DatasetFactory.run({nrec} records, chunk_size="
                    f"{chunk}) [{label}]: {wall:.3f} s = {nrec / wall:.1f} "
                    f"records/s, {res['commits']} commits, stride "
                    f"{res['stride']} B, launches {counts}; stages: "
                    f"{stages}; sha256 {runs[label][1][:16]}")
            if len({v[1] for v in runs.values()}) != 1:
                raise AssertionError("corpora differ between chunk sizes 64 "
                                     "and 37")
            clean, clean_sha = runs["first"][0], runs["first"][1]
            self.dataset_rate = nrec / runs["steady"][2]
            log("  (a) chunk sizes 64 and 37: shards and indexes "
                "byte-identical")

            # (b) SIGKILL after chunk 128's commit, resume with chunk 37
            killed = os.path.join(work, "killed")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), DATASET_KILL_CHILD,
                 killed, os.path.join(work, "kill_plan")],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != -9:
                raise AssertionError(
                    f"the child exited {proc.returncode}, expected SIGKILL:\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            with open(os.path.join(killed, "dataset_journal.jsonl")) as fh:
                starts = [json.loads(line)["start"] for line in fh]
            if starts != [0, 64, 128]:
                raise AssertionError(f"the killed run journaled {starts}")
            self._zero_counts()
            res = DatasetFactory(spec, device=dev).run(killed, chunk_size=37)
            counts = self._counts()
            if corpus_sha(killed) != clean_sha:
                raise AssertionError("the resumed corpus differs from the "
                                     "clean one")
            log(f"  (b) a child SIGKILLed after chunk 128's commit (journal "
                f"{starts}), resumed with chunk_size=37: byte-identical, "
                f"{res['commits']} commits, launches {counts}")

            # (c) integrity: host.corrupt and device.sdc healed in one run,
            # disk.bitrot found by the scrub and healed by a resume
            armed = os.path.join(work, "armed")
            self._zero_counts()
            res = DatasetFactory(spec, device=dev).run(
                armed, chunk_size=64, integrity=1.0, faults=FaultPlan(
                    os.path.join(work, "plan_c"),
                    {"host.corrupt": {"after_start": 64},
                     "device.sdc": {"after_start": 192}}))
            counts = self._counts()
            st = res["integrity"]
            if (corpus_sha(armed) != clean_sha or st["healed_chunks"] != 2
                    or st["checksum_mismatches"] != 1
                    or st["audit_mismatches"] != 1):
                raise AssertionError(f"integrity leg: {st}")
            rot = os.path.join(work, "rot")
            DatasetFactory(spec, device=dev).run(
                rot, chunk_size=64, faults=FaultPlan(
                    os.path.join(work, "plan_r"),
                    {"disk.bitrot": {"match": "start=256"}}))
            bad = scrub_dataset_dir(rot)["bad"]
            res2 = DatasetFactory(spec, device=dev).run(rot, chunk_size=64)
            if (bad != [256] or res2["commits"] != 1
                    or corpus_sha(rot) != clean_sha
                    or scrub_dataset_dir(rot)["bad"]):
                raise AssertionError(f"bitrot leg: scrub found {bad}, the "
                                     f"resume made {res2['commits']} commits")
            log(f"  (c) integrity=1.0 with host.corrupt on chunk 64 and "
                f"device.sdc on chunk 192: healed, byte-identical (checks "
                f"{st['checks']}, audits {st['audits']}, checksum mismatches "
                f"{st['checksum_mismatches']}, audit mismatches "
                f"{st['audit_mismatches']}, healed {st['healed_chunks']}; "
                f"launches {counts}); disk.bitrot on chunk 256: the scrub "
                f"found {bad}, a resume recomputed 1 chunk, byte-identical")

            # (d) the card against the host: records 0-3 (PSS_SAMPLER=hw)
            reader = DatasetReader(clean)
            os.environ["PSS_SAMPLER"] = "hw"
            try:
                host = DatasetFactory(spec, device="cpu").sampler
                hrec = [host.record_host(i) for i in range(4)]
            finally:
                os.environ.pop("PSS_SAMPLER", None)
            worst = 0.0
            for i, h in enumerate(hrec):
                r = reader.read_index(i)
                for name in ("params", "scenario_params", "energies",
                             "rfi_mask"):
                    if r[name].tobytes() != h[name].tobytes():
                        raise AssertionError(f"record {i}: {name} differs "
                                             "from the host")
                err = np.abs(r["tile"] - h["tile"])
                worst = max(worst, float(err.max()))
                if (err > 1e-5 * np.abs(h["tile"])
                        + 1e-5 * np.abs(h["tile"]).max()).any():
                    raise AssertionError(f"record {i}: the tile differs "
                                         "from the host")
            epoch = sum(1 for _ in reader.iter_epoch(0))
            reader.close()
            log(f"  (d) records 0-3 against device='cpu': labels byte-equal, "
                f"tiles max|diff| {worst:.3g} (rtol 1e-5 + 1e-5 of the "
                f"peak); a reader epoch visits {epoch} records")
            if epoch != nrec:
                raise AssertionError("the reader's epoch misses records")
            for d in (clean, killed, armed, rot):
                shutil.rmtree(d, ignore_errors=True)

            # (e) a few records at config 4's geometry, every effect on
            spec4 = DATASET_CONFIG4
            out4 = os.path.join(work, "config4")
            self._zero_counts()
            t0 = time.perf_counter()
            res = DatasetFactory(spec4, device=dev).run(out4, chunk_size=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
            nbytes = res["stride"] * spec4["n_records"]
            if counts != flat_only(2):
                raise AssertionError(f"config-4 corpus: launches {counts}")
            r4 = DatasetReader(out4).read_index(spec4["n_records"] - 1)
            if not np.isfinite(r4["tile"]).all():
                raise AssertionError("config-4 record not finite")
            log(f"  (e) config-4 geometry ({spec4['nchan']} x "
                f"{r4['tile'].shape[1]}, every effect), {spec4['n_records']} "
                f"records in chunks of 4: {wall:.2f} s = "
                f"{spec4['n_records'] / wall:.2f} records/s, "
                f"{nbytes / 1e9:.2f} GB written ({nbytes / wall / 1e9:.2f} "
                f"GB/s), launches {counts}")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    # -- 15 -----------------------------------------------------------------
    def baseband(self):
        """Baseband at BASELINE config 3's full width (see the module
        docstring)."""
        torch = self.torch
        import dataclasses

        import numpy as np

        from psrsigsim_torch.ops import rng_hw, shift
        from psrsigsim_torch.simulate import baseband_pipeline
        from psrsigsim_torch.utils import key, stage_key

        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_EXACT_SHIFT", None)
        dev = self.dev
        cfg, sp, nn = config3()
        B, npol, L = BASEBAND_NOBS, sp.shape[0], cfg.nsamp
        n = npol * L
        log(f"  config3_baseband: npol {npol} nph {cfg.nph} nsamp {L} "
            f"os_plan {tuple(cfg.os_plan) if cfg.os_plan else None} "
            f"noise_norm {nn:.6g}")

        # (a) the flat layout in normal mode at the config-3 span
        hk = stage_key(key(0, "cpu"), "user", torch.arange(B))
        seeds = rng_hw.seed_words(stage_key(hk, "pulse")).to(dev).contiguous()
        dfs = torch.zeros(B, device=dev)
        pos = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        got = rng_hw.rng_flat_field(seeds, dfs, pos, "normal", 0, n)
        want = rng_hw.rng_flat_field_plain(seeds, dfs, pos, "normal", 0, n)
        err = float((got - want).abs().max())
        log(f"  (a) flat normal {B} x {n}: max|kernel-plain| {err:.3g}")
        if not torch.equal(got, want):
            raise AssertionError("the flat layout's normal mode differs from "
                                 "its plain version at the config-3 span")
        self.kernels["rng_flat_field"]["baseband_max_abs_err"] = err
        del got, want
        ms = cuda_time_ms(lambda: rng_hw.rng_flat_field(
            seeds, dfs, pos, "normal", 0, n), 10)
        plain_ms = cuda_time_ms(lambda: rng_hw.rng_flat_field_plain(
            seeds, dfs, pos, "normal", 0, n), 1)
        library_ms = cuda_time_ms(lambda: torch.randn((B, n), device=dev), 10)
        b_ms, b_by, parts = bound(NORMAL_OPS, B * n, 4 * B * n + B * 20)
        self.kernels["rng_flat_field"].update(
            baseband_ms=ms, baseband_plain_ms=plain_ms,
            baseband_bound_ms=b_ms, baseband_bound_by=b_by,
            baseband_library_ms=library_ms)
        log(f"  rng_flat_field ({B} x {n}, normal): {ms:.4f} ms, "
            f"{b_ms / ms:.1%} of its bound {b_ms:.4f} ms, {b_by} "
            f"({fmt_parts(parts)}); plain {plain_ms:.1f} ms; torch.randn "
            f"{library_ms:.4f} ms ({self.card_line})")

        # (b) the main path: baseband_pipeline(8) at full width
        dms = torch.full((B,), CONFIG3["dm"])
        nns = torch.full((B,), nn, dtype=torch.float32)
        sdev = torch.as_tensor(sp, device=dev)

        def run(k=hk, c=cfg):
            return baseband_pipeline(k, dms[:k.shape[0]], nns[:k.shape[0]],
                                     sdev, c)

        run(hk[:1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        self._zero_counts()
        t0 = time.perf_counter()
        block = run()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = self._counts()
        want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                "rng_flat_field": 2}
        if counts != want:
            raise AssertionError(f"baseband_pipeline({B}): launches {counts}, "
                                 f"expected {want}")
        self.kernels["rng_flat_field"]["baseband_launches"] = \
            counts["rng_flat_field"]
        self._path(f"15 baseband_pipeline({B})", counts)
        if tuple(block.shape) != (B, npol, L) or not bool(
                torch.isfinite(block).all()):
            raise AssertionError("baseband_pipeline: wrong shape or non-finite")
        # power: dispersion is unitary (up to the plan's halo truncation),
        # so <x^2> = <tiled sqrt_profile^2> + noise_norm^2 per observation
        amp2 = sp.astype(np.float64) ** 2
        expect = float(np.tile(amp2, (1, -(-L // cfg.nph)))[:, :L].mean()
                       + nn * nn)
        rel = np.abs((block.double() ** 2).mean(dim=(1, 2)).cpu().numpy()
                     / expect - 1)
        log(f"  (b) baseband_pipeline({B}) at {npol} x {L}: first "
            f"{t_first:.3f} s, launches {counts}; mean power vs expectation "
            f"{expect:.6g}: max rel dev {rel.max():.3g}")
        if rel.max() > 0.02:
            raise AssertionError("baseband power off by > 2%")
        del block
        reps = 5

        def steady(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps

        def cold():
            # the transfer function's host cycle planes rebuilt each batch
            # (the first design; the reference folds them in at compile time)
            shift._cycle_planes.cache_clear()
            return run()

        t_cached = [steady(run)]
        t_cold = [steady(cold), steady(cold)]
        t_cached.append(steady(run))
        t_ss = min(t_cached)
        log(f"  steady baseband_pipeline({B}) in turns: host planes cached "
            f"{t_cached[0] * 1e3:.2f}, {t_cached[1] * 1e3:.2f} ms; rebuilt "
            f"each batch {t_cold[0] * 1e3:.2f}, {t_cold[1] * 1e3:.2f} ms")
        wall, busy, nev, by_name, _ = device_profile(torch, run)
        groups = {"draws": 0.0, "ffts": 0.0, "rest": 0.0}
        for name, (us, _) in by_name.items():
            low = name.lower()
            g = ("draws" if "rng_field" in low
                 else "ffts" if "fft" in low else "rest")
            groups[g] += us / 1e3
        log(f"  steady baseband_pipeline({B}): {t_ss * 1e3:.2f} ms = "
            f"{B / t_ss:.1f} obs/s = {B * n / t_ss / 1e6:.1f} Msamples/s; "
            f"peak memory {peak / 2**30:.3f} GiB; profiled wall "
            f"{wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / 1e6 / wall:.1%}), {nev} device events; by kernel "
            f"class: " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                   groups.items()) + f" ({self.card_line})")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
            log(f"  {us / 1e3:9.3f} ms {k:4d}x  {name[:100]}")

        # (c) the card against the host: observations 0-1 at full width
        nh = BASEBAND_HOST_NOBS

        def against_host(label, c):
            card = run(hk[:nh], c).cpu().numpy()
            os.environ["PSS_SAMPLER"] = "hw"
            try:
                t0 = time.perf_counter()
                host = baseband_pipeline(hk[:nh], dms[:nh], nns[:nh], sp, c,
                                         device="cpu").numpy()
                t_host = time.perf_counter() - t0
            finally:
                os.environ.pop("PSS_SAMPLER", None)
            peak_v = np.abs(host).max()
            err = np.abs(card - host)
            bad = err > 1e-5 * np.abs(host) + 1e-5 * peak_v
            log(f"  {label}: observations 0-{nh - 1} against device='cpu' "
                f"(PSS_SAMPLER=hw, {t_host:.1f} s on the host): max|diff| "
                f"{err.max():.3g} (peak {peak_v:.3g}), {int(bad.sum())} beyond "
                f"rtol 1e-5 + 1e-5 of the peak; bit-equal "
                f"{np.mean(card == host):.4f}")
            if bad.any():
                raise AssertionError(f"{label}: the card differs from the host")

        against_host("(c) overlap-save plan", cfg)

        # (d) the same observations in a batch of 2: bit-equal
        two = run(hk[:nh])
        again = run()[:nh]
        if not torch.equal(two, again):
            raise AssertionError("baseband blocks depend on the batch width")
        log(f"  (d) observations 0-{nh - 1} in a batch of {nh} and of {B}: "
            "bit-equal")
        del two, again

        # (e) exact_fft=True: the monolithic 4,000,000-point transforms
        ecfg = dataclasses.replace(cfg, os_plan=None)
        run(hk[:1], ecfg)
        torch.cuda.synchronize()
        self._zero_counts()
        t0 = time.perf_counter()
        eb = run(hk[:nh], ecfg)
        torch.cuda.synchronize()
        t_exact = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb = run(hk[:nh])
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        counts = self._counts()
        if counts != {**want, "rng_flat_field": 4}:
            raise AssertionError(f"exact_fft: launches {counts}")
        d = (eb - pb).abs().max() / pb.abs().max()
        log(f"  (e) exact_fft=True, {nh} observations: {t_exact * 1e3:.1f} ms "
            f"against {t_plan * 1e3:.1f} ms with the plan; the plan's halo "
            f"truncation: max|exact - plan| {float(d):.3g} of the peak")
        del eb, pb
        against_host("(e) exact_fft=True", ecfg)

        # (f) the object-oriented flow, card against host
        self.baseband_oo()

    def baseband_oo(self):
        """Phase 15 (f): BasebandSignal -> make_pulses -> disperse ->
        radiometer_noise -> to_FilterBank(512), on the card and the host."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.models.ism import ISM
        from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
        from psrsigsim_torch.models.telescope import Receiver
        from psrsigsim_torch.signal import BasebandSignal

        g = CONFIG3

        def flow(device):
            sig = BasebandSignal(g["fcent"], g["bw"],
                                 sample_rate=g["samprate_mhz"], device=device)
            psr = Pulsar(g["period_s"], g["smean"], GaussProfile(width=0.05),
                         name="BENCH", seed=0)
            rcvr = Receiver(fcent=g["fcent"], bandwidth=g["bw"], name="R",
                            seed=1)
            out, times = {}, {}
            steps = (("make_pulses", lambda: psr.make_pulses(
                          sig, tobs=g["tobs_s"])),
                     ("disperse", lambda: ISM().disperse(sig, g["dm"])),
                     ("radiometer_noise", lambda: rcvr.radiometer_noise(
                         sig, psr, gain=1.0, Tsys=35.0)))
            for name, fn in steps:
                t0 = time.perf_counter()
                fn()
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
                times[name] = time.perf_counter() - t0
                out[name] = sig.data.cpu().numpy()
            t0 = time.perf_counter()
            fb = sig.to_FilterBank(OO_BASEBAND_NSUB)
            out["to_FilterBank"] = fb.data.cpu().numpy()
            times["to_FilterBank"] = time.perf_counter() - t0
            meta = (fb.Nchan, int(fb.nsamp), float(fb.samprate.value),
                    float(fb.tobs.value), str(fb.data.device.type))
            return out, times, meta

        card, t_first, m_card = flow(self.dev)
        again, t_card, _ = flow(self.dev)
        if any(not np.array_equal(card[k], again[k]) for k in card):
            raise AssertionError("(f) a second run on the card differs")
        host, t_host, m_host = flow("cpu")
        if m_card[:4] != m_host[:4] or m_card[4] != "cuda":
            raise AssertionError(f"to_FilterBank metadata {m_card} vs {m_host}")
        if not np.array_equal(card["make_pulses"], host["make_pulses"]):
            raise AssertionError("make_pulses: the card's draws differ from "
                                 "the host's")
        for name in ("disperse", "radiometer_noise", "to_FilterBank"):
            a, b = card[name], host[name]
            peak_v = np.abs(b).max()
            err = np.abs(a - b)
            bad = err > 1e-5 * np.abs(b) + 1e-5 * peak_v
            log(f"  (f) {name}: card against host max|diff| {err.max():.3g} "
                f"(peak {peak_v:.3g}), {int(bad.sum())} beyond the bound")
            if bad.any():
                raise AssertionError(f"(f) {name}: the card differs from the "
                                     "host")
        log(f"  (f) the object-oriented flow ({m_card[0]} x {m_card[1]} "
            f"filterbank): make_pulses bit-equal, a second card run "
            f"bit-equal; step times on the card, first run (cuFFT plans) "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t_first.items())
            + "; second run " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                          for k, v in t_card.items())
            + "; on the host " + ", ".join(f"{k} {v:.2f} s"
                                          for k, v in t_host.items()))

    # -- 16 -----------------------------------------------------------------
    def multipulsar(self):
        """The multi-pulsar ensemble at BASELINE config 5 (see the module
        docstring)."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
        from psrsigsim_torch.simulate import fold_pipeline_hetero
        from psrsigsim_torch.utils import fold_in, key, stage_key

        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_EXACT_SHIFT", None)
        dev = self.dev
        work = config5()
        E, chunk = MULTI_EPOCHS, MULTI_EPOCH_CHUNK
        ens = MultiPulsarFoldEnsemble(work, epoch_chunk=chunk, device=dev)
        sizes = {bk: len(m) for bk, m in ens._buckets.items()}
        log(f"  config5_multipulsar: {len(work)} pulsars, "
            f"{len({c.period_s for c, _, _, _ in work})} distinct periods, "
            f"buckets (nchan, nph, nsub): {sizes}")

        # (a) the rows layout in chi2_sel mode with per-row dfs, at the
        # biggest bucket's shape
        bkey = max(sizes, key=lambda b: (sizes[b], b[1]))
        nch, nph, nsub = bkey
        members = ens._buckets[bkey]
        L = nph * nsub
        rows = len(members) * chunk
        keys = stage_key(key(0, "cpu"), "user", torch.arange(rows))
        seeds = rng_hw.seed_words(stage_key(keys, "pulse")).to(dev).contiguous()
        nf = np.asarray([work[i][0].nfold for i in members], np.float32)
        dfs = torch.as_tensor(np.repeat(nf, chunk), device=dev)
        dfs[0] = 1.0
        pos = torch.zeros((rows, 2), dtype=torch.int32, device=dev)
        got = rng_hw.rng_field(seeds, dfs, pos, "chi2_sel", nch, L)
        want = rng_hw.rng_field_plain(seeds, dfs, pos, "chi2_sel", nch, L)
        err = float((got - want).abs().max())
        log(f"  (a) rows chi2_sel {rows} x {nch} x {L} (dfs "
            f"{float(nf.min()):.1f}-{float(nf.max()):.1f} and one 1.0): "
            f"max|kernel-plain| {err:.3g}")
        if not torch.equal(got, want):
            raise AssertionError("chi2_sel rows differ from the plain version")
        self.kernels["rng_field"]["multipulsar_max_abs_err"] = err
        del got, want
        ms = cuda_time_ms(lambda: rng_hw.rng_field(
            seeds, dfs, pos, "chi2_sel", nch, L), 20)
        plain_ms = cuda_time_ms(lambda: rng_hw.rng_field_plain(
            seeds, dfs, pos, "chi2_sel", nch, L), 1)
        library_ms = cuda_time_ms(lambda: torch.randn((rows, nch, L),
                                                      device=dev), 20)
        total = rows * nch * L
        b_ms, b_by, parts = bound(DRAW_OPS, total, 4 * total + rows * 20)
        self.kernels["rng_field"].update(
            multipulsar_ms=ms, multipulsar_plain_ms=plain_ms,
            multipulsar_bound_ms=b_ms, multipulsar_bound_by=b_by,
            multipulsar_library_ms=library_ms)
        log(f"  rng_field ({rows} x {nch} x {L}, chi2_sel): {ms:.4f} ms, "
            f"{b_ms / ms:.1%} of its bound {b_ms:.4f} ms, {b_by} "
            f"({fmt_parts(parts)}); plain {plain_ms:.1f} ms; torch.randn "
            f"{library_ms:.4f} ms ({self.card_line})")

        # (b) run(8) with epoch_chunk=2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        self._zero_counts()
        t0 = time.perf_counter()
        out = ens.run(E, seed=0)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = self._counts()
        n_launch = 2 * ens.n_buckets * -(-E // chunk)
        want = {"rng_field": n_launch, "fold_quantize": 0, "packed_digest": 0}
        if counts != want:
            raise AssertionError(f"run({E}): launches {counts}, expected "
                                 f"{want}")
        self.kernels["rng_field"]["multipulsar_launches"] = \
            counts["rng_field"]
        self._path(f"16 MultiPulsarFoldEnsemble.run({E})", counts)
        worst = 0.0
        for (cfg, prof, nn, _), a in zip(work, out):
            if tuple(a.shape) != (E, cfg.meta.nchan, cfg.nsamp) or not bool(
                    torch.isfinite(a).all()):
                raise AssertionError("run: wrong shape or non-finite")
            exp_c = (cfg.draw_norm * cfg.nfold
                     * prof.astype(np.float64).mean(axis=1) + cfg.nfold * nn)
            got_c = a.double().mean(dim=(0, 2)).cpu().numpy()
            worst = max(worst, float(np.abs(got_c / exp_c - 1).max()))
        nbytes = sum(a.numel() * 4 for a in out)
        log(f"  (b) run({E}), epoch_chunk {chunk}: first {t_first:.3f} s = "
            f"{len(work) * E / t_first:.1f} pulsar-epochs/s, launches "
            f"{counts} ({ens.n_buckets} buckets x {-(-E // chunk)} chunks x "
            f"2), output {nbytes / 2**30:.3f} GiB, peak memory "
            f"{peak / 2**30:.3f} GiB; channel means vs expectation: max rel "
            f"dev {worst:.3g}")
        if worst > 0.02:
            raise AssertionError("multi-pulsar channel means off by > 2%")
        ref = [a.clone() for a in out]
        del out
        reps = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = ens.run(E, seed=0)
        torch.cuda.synchronize()
        t_ss = (time.perf_counter() - t0) / reps
        del out
        wall, busy, nev, by_name, _ = device_profile(
            torch, lambda: ens.run(E, seed=0))
        log(f"  steady run({E}): {t_ss * 1e3:.1f} ms = "
            f"{len(work) * E / t_ss:.1f} pulsar-epochs/s; profiled wall "
            f"{wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
            f"({busy / 1e6 / wall:.1%}), {nev} device events "
            f"({self.card_line})")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            log(f"  {us / 1e3:9.3f} ms {k:4d}x  {name[:100]}")

        # (c) epoch splits and chunk sizes change no draw
        half = E // 2
        first, second = ens.run(half, seed=0), ens.run(half, seed=0,
                                                       epoch_start=half)
        wide = MultiPulsarFoldEnsemble(work, epoch_chunk=2 * chunk,
                                       device=dev).run(E, seed=0)
        for i, r in enumerate(ref):
            if not torch.equal(torch.cat([first[i], second[i]]), r):
                raise AssertionError(f"pulsar {i}: run({half}) + run({half}, "
                                     f"epoch_start={half}) != run({E})")
            if not torch.equal(wide[i], r):
                raise AssertionError(f"pulsar {i}: epoch_chunk {2 * chunk} != "
                                     f"{chunk}")
        log(f"  (c) run({half}) + run({half}, epoch_start={half}) and "
            f"epoch_chunk {2 * chunk}: bit-equal to run({E})")
        del first, second, wide

        # (d) MULTI_HOST pulsars x 2 epochs against device="cpu", and (e)
        # one pulsar alone on the card against its rows in the full run
        pick = members[:MULTI_HOST]
        st = ens._staged(bkey, members)
        cfg0 = work[pick[0]][0]
        root = key(0, "cpu")
        hkeys = fold_in(stage_key(root, "user", torch.tensor(pick))[:, None, :],
                        torch.arange(2))
        sl = slice(0, len(pick))

        def inputs(device):
            return [st[k][sl].to(device) for k in
                    ("dms", "norms", "nfolds", "draw_norms", "profiles",
                     "freqs", "dts")]

        dm_, nn_, nf_, dn_, pr_, fr_, dt_ = inputs("cpu")
        os.environ["PSS_SAMPLER"] = "hw"
        try:
            t0 = time.perf_counter()
            host = fold_pipeline_hetero(hkeys, dm_, nn_, nf_, dn_, pr_, cfg0,
                                        freqs=fr_, dt_ms=dt_,
                                        device="cpu").numpy()
            t_host = time.perf_counter() - t0
        finally:
            os.environ.pop("PSS_SAMPLER", None)
        card = np.stack([ref[p][:2].cpu().numpy() for p in pick])
        peak_v = np.abs(host).max()
        err = np.abs(card - host)
        bad = err > 1e-5 * np.abs(host) + 1e-5 * peak_v
        log(f"  (d) pulsars {pick} x 2 epochs against device='cpu' "
            f"(PSS_SAMPLER=hw, {t_host:.1f} s on the host): max|diff| "
            f"{err.max():.3g} (peak {peak_v:.3g}), {int(bad.sum())} beyond "
            f"rtol 1e-5 + 1e-5 of the peak; bit-equal "
            f"{np.mean(card == host):.4f}")
        if bad.any():
            raise AssertionError("(d) the card differs from the host")
        p = pick[0]
        one_keys = fold_in(stage_key(root, "user", torch.tensor([p]))[:, None,
                                                                      :],
                           torch.arange(E))
        dm_, nn_, nf_, dn_, pr_, fr_, dt_ = (v[:1] for v in inputs(dev))
        alone = fold_pipeline_hetero(one_keys, dm_, nn_, nf_, dn_, pr_, cfg0,
                                     freqs=fr_, dt_ms=dt_)
        if not torch.equal(alone[0], ref[p]):
            raise AssertionError(f"(e) pulsar {p} alone differs from its rows "
                                 "in the full run")
        log(f"  (e) pulsar {p} alone ({E} epochs): bit-equal to its rows in "
            "the full run")

    # -- 17 -----------------------------------------------------------------
    def serving(self):
        """The serving core on the card at BASELINE config 1's width (see the
        module docstring)."""
        import shutil
        import tempfile

        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops import rng_hw, stats
        from psrsigsim_torch.runtime import FaultPlan
        from psrsigsim_torch.serve import (SimulationService, build_geometry,
                                           canonicalize, spec_hash)
        from psrsigsim_torch.serve.service import request_keys
        from psrsigsim_torch.utils import as_key, stage_key

        os.environ.pop("PSS_SAMPLER", None)
        os.environ.pop("PSS_EXACT_SHIFT", None)
        dev = self.dev
        cfg, profiles, noise_norm = build_geometry(canonicalize(SERVE_SPEC))
        nch, L = cfg.meta.nchan, cfg.nsamp
        W = SERVE_WIDTHS[-1]
        log(f"  serve spec at config 1's width: nchan {nch} nph {cfg.nph} "
            f"nsub {cfg.nsub} nfold {cfg.nfold:g} noise_df {cfg.noise_df:g}; "
            f"widths {SERVE_WIDTHS}")

        # (a) K1' at the w32 serve shape: the pulse field of 32 requests
        canon = [canonicalize(serve_spec(i)) for i in range(W)]
        keys = as_key(request_keys([c["seed"] for c in canon],
                                   [spec_hash(c) for c in canon]), "cpu")
        mode = stats._hw_chi2_mode(cfg.nfold)
        seeds = rng_hw.seed_words(stage_key(keys, "pulse")).to(dev)
        seeds = seeds.contiguous()
        dfs = torch.full((W,), float(cfg.nfold), device=dev)
        pos = torch.zeros((W, 2), dtype=torch.int32, device=dev)
        got = rng_hw.rng_field(seeds, dfs, pos, mode, nch, L)
        want = rng_hw.rng_field_plain(seeds, dfs, pos, mode, nch, L)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"(a) rng_field at the serve shape differs "
                                 f"from its plain version by {err:.3g}")
        del got, want
        ms = cuda_time_ms(lambda: rng_hw.rng_field(seeds, dfs, pos, mode,
                                                   nch, L), 20)
        plain_ms = cuda_time_ms(lambda: rng_hw.rng_field_plain(
            seeds, dfs, pos, mode, nch, L), 1)
        library_ms = cuda_time_ms(lambda: torch.randn((W, nch, L),
                                                      device=dev), 20)
        n = W * nch * L
        b_ms, b_by, parts = bound(DRAW_OPS, n, 4 * n + W * (8 + 4 + 8))
        self.kernels["rng_field"].update(
            serve_shape=[W, nch, L], serve_max_abs_err=err, serve_ms=ms,
            serve_plain_ms=plain_ms, serve_bound_ms=b_ms,
            serve_bound_by=b_by, serve_library_ms=library_ms)
        log(f"  (a) rng_field ({W} x {nch} x {L}, {mode}, request keys): "
            f"bit-equal to its plain version; {ms:.4f} ms, {b_ms / ms:.1%} of "
            f"its bound {b_ms:.4f} ms, {b_by} ({fmt_parts(parts)}); plain "
            f"{plain_ms:.1f} ms; torch.randn {library_ms:.4f} ms "
            f"({self.card_line})")

        def serve(specs, widths, window, device=dev, **kw):
            """Serve ``specs`` concurrently through a fresh service; every
            request must reach done.  The rows, and the width -> calls
            map."""
            svc = SimulationService(widths=widths, batch_window_s=window,
                                    device=device, **kw)
            try:
                svc.warmup(specs[0])
                ids = [svc.submit(s)[0] for s in specs]
                rows = [svc.result(i, timeout=600) for i in ids]
                svc.registry.assert_single_compile()
                calls = {w: c for (_, w), c in
                         svc.registry.call_counts().items()}
                return rows, calls, svc
            finally:
                svc.close()

        # (c) solo, coalesced, w1/w8/w32 and a 5-request batch padded to 8
        target = serve_spec(0)
        legs = {"w1 solo": ([target], (1,)),
                "w8 coalesced": ([serve_spec(i) for i in range(1, 8)]
                                 + [target], (8,)),
                "w32": ([serve_spec(i) for i in range(1, W)] + [target],
                        (W,)),
                "5 padded to 8": ([serve_spec(i) for i in range(1, 5)]
                                  + [target], (8,))}
        ref = None
        for label, (specs, widths) in legs.items():
            rows, calls, _ = serve(specs, widths, 0.5)
            if set(calls) != set(widths):
                raise AssertionError(f"(c) {label}: bucket calls {calls}")
            if ref is None:
                ref = rows[-1]
            elif rows[-1].tobytes() != ref.tobytes():
                raise AssertionError(f"(c) {label}: the target's row differs "
                                     "from its solo row")
        log(f"  (c) the same request solo (w1), coalesced (w8), in a w32 "
            f"batch and in a 5-request batch padded to 8: bit-equal; shape "
            f"{ref.shape}, finite {bool(np.isfinite(ref).all())}")
        if ref.shape != (nch, cfg.nph) or not np.isfinite(ref).all():
            raise AssertionError("(c) wrong shape or non-finite profile")
        # a folded profile sums nsub subints of the pulse and noise terms
        expect = cfg.nsub * (cfg.draw_norm * cfg.nfold
                             * profiles.astype(np.float64).mean(axis=1)
                             + cfg.noise_df * noise_norm)
        rel = np.abs(ref.astype(np.float64).mean(axis=1) / expect - 1)
        log(f"  (c) channel means vs expectation: max rel dev {rel.max():.3g}")
        if rel.max() > 0.01:
            raise AssertionError("(c) served channel means off by > 1%")

        # (d) PSS_SAMPLER=threefry: the card against the host
        os.environ["PSS_SAMPLER"] = "threefry"
        try:
            card = serve([target], (1,), 0.0)[0][0]
            t0 = time.perf_counter()
            host = serve([target], (1,), 0.0, device="cpu")[0][0]
            t_host = time.perf_counter() - t0
        finally:
            os.environ.pop("PSS_SAMPLER", None)
        peak_v = np.abs(host).max()
        d = np.abs(card - host)
        bad = d > 1e-5 * np.abs(host) + 1e-5 * peak_v
        log(f"  (d) threefry, card against device='cpu' ({t_host:.1f} s on "
            f"the host): max|diff| {d.max():.3g} (peak {peak_v:.3g}), "
            f"{int(bad.sum())} beyond rtol 1e-5 + 1e-5 of the peak; "
            f"bit-equal {np.mean(card == host):.4f}")
        if bad.any():
            raise AssertionError("(d) the card differs from the host")

        # (e) throughput, latency, launches, busy share, peak memory
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="serve-", dir=build)
        try:
            self._serve_rates(work, ref, target)
            self._serve_cli(work, ref, target)
        finally:
            shutil.rmtree(work, ignore_errors=True)

        # (g) integrity with a device.sdc fault heals to the clean bytes
        scratch = tempfile.mkdtemp(prefix="serve-faults-", dir=build)
        try:
            plan = FaultPlan(scratch, {"device.sdc": {"times": 1}})
            self._zero_counts()
            rows, _, svc = serve([target], (1,), 0.0, integrity=1.0,
                                 faults=plan)
            counts = self._counts()
            st = svc.integrity.stats()
            fired = plan.shots_fired("device.sdc")
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        log(f"  (g) integrity=1.0 with device.sdc: fired {fired}, {st}; "
            f"launches {counts}")
        if fired != 1 or st["healed_chunks"] != 1:
            raise AssertionError("(g) the device.sdc fault did not fire and "
                                 "heal")
        if rows[0].tobytes() != ref.tobytes():
            raise AssertionError("(g) the healed row differs from the clean "
                                 "one")
        if counts["packed_digest"] or counts["fold_quantize"]:
            raise AssertionError(f"(g) unexpected kernels {counts}")

    def _serve_rates(self, work, ref, target):
        """Phase 17 (b), (e): the service in process over a cache dir."""
        torch = self.torch
        from psrsigsim_torch.serve import SimulationService

        cache = os.path.join(work, "cache")

        def service():
            return SimulationService(cache_dir=cache, widths=SERVE_WIDTHS,
                                     device=self.dev)

        svc = service()
        try:
            svc.warmup(target)
            t0 = time.perf_counter()
            for i in range(SERVE_SERIAL):
                rid, _ = svc.submit(serve_spec(100 + i))
                svc.result(rid, timeout=600)
            t_serial = time.perf_counter() - t0

            def burst(first):
                ids = [svc.submit(serve_spec(first + i))[0]
                       for i in range(SERVE_BURST)]
                return [svc.result(i, timeout=600) for i in ids]

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            calls0 = svc.registry.device_calls
            self._zero_counts()
            t0 = time.perf_counter()
            burst(1000)
            t_burst = time.perf_counter() - t0
            counts = self._counts()
            execs = svc.registry.device_calls - calls0
            peak = torch.cuda.max_memory_allocated() - base
            want = {"rng_field": 2 * execs, "fold_quantize": 0,
                    "packed_digest": 0}
            log(f"  (b) {SERVE_BURST} concurrent requests: {execs} bucket "
                f"executions {svc.registry.call_counts()}, launches {counts}")
            if counts != want or execs <= 0:
                raise AssertionError(f"(b) launches {counts}, expected "
                                     f"{want}")
            self._path("serve", counts)
            wall, busy, nev, by_name, _ = device_profile(
                torch, lambda: burst(2000))
            snap = svc.timers.snapshot()
        finally:
            svc.close()
        stages = ", ".join(f"{k} {snap[k + '_s']:.3f} s"
                           for k in ("enqueue", "batch", "compute",
                                     "respond"))
        log(f"  (e) serial w1: {SERVE_SERIAL / t_serial:.1f} req/s; "
            f"{SERVE_BURST} concurrent: {SERVE_BURST / t_burst:.1f} req/s; "
            f"request p50 {snap['request_p50_s'] * 1e3:.2f} ms, p95 "
            f"{snap['request_p95_s'] * 1e3:.2f} ms, p99 "
            f"{snap['request_p99_s'] * 1e3:.2f} ms; stages {stages}; "
            f"bottleneck {snap['bottleneck']}; profiled burst wall "
            f"{wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
            f"({busy / 1e6 / wall:.1%}), {nev} device events; peak memory "
            f"{peak / 2**30:.3f} GiB ({self.card_line})")
        for name, (us, k) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            log(f"  {us / 1e3:9.3f} ms {k:4d}x  {name[:100]}")

        # cache hits from a fresh service over the same directory
        svc = service()
        try:
            t0 = time.perf_counter()
            ids = [svc.submit(serve_spec(1000 + i)) for i in
                   range(SERVE_BURST)]
            rows = [svc.result(rid, timeout=60) for rid, _ in ids]
            t_hit = time.perf_counter() - t0
            calls = svc.registry.device_calls
            hits = svc.cache_hits
        finally:
            svc.close()
        log(f"  (e) {SERVE_BURST} cache hits from a fresh service: "
            f"{SERVE_BURST / t_hit:.1f} req/s, device calls {calls}, hits "
            f"{hits}")
        if calls != 0 or hits != SERVE_BURST or any(
                s != "done" for _, s in ids) or len(rows) != SERVE_BURST:
            raise AssertionError("(e) the cache hits touched the device")

    def _serve_cli(self, work, ref, target):
        """Phase 17 (f): ``python -m psrsigsim_torch.serve`` on the card."""
        import signal
        import urllib.request

        import numpy as np

        spec_path = os.path.join(work, "warm.json")
        with open(spec_path, "w") as f:
            json.dump(target, f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        err_path = os.path.join(work, "cli-stderr.txt")
        with open(err_path, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "psrsigsim_torch.serve", "--port",
                 "0", "--cache-dir", os.path.join(work, "cli-cache"),
                 "--warmup", spec_path], stdout=subprocess.PIPE, stderr=err,
                text=True, cwd=ROOT, env=env)
        try:
            t0 = time.perf_counter()
            ready = json.loads(proc.stdout.readline() or "{}")
            t_ready = time.perf_counter() - t0
            if not ready.get("ready"):
                with open(err_path) as err:
                    raise AssertionError(f"(f) no ready line: "
                                         f"{err.read()[-3000:]}")
            base = f"http://127.0.0.1:{ready['port']}"

            def call(path, body=None):
                req = urllib.request.Request(
                    base + path, None if body is None
                    else json.dumps(body).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    return r.status, json.loads(r.read())

            ids = []
            for spec in (target, serve_spec(1), serve_spec(2)):
                code, body = call("/simulate", dict(spec, wait=300))
                if code != 200 or body["status"] != "done":
                    raise AssertionError(f"(f) /simulate: {code} {body}")
                ids.append(body["id"])
            code, res = call("/result/" + ids[0])
            row = np.asarray(res["profile"], np.float32)
            if code != 200 or row.tobytes() != ref.tobytes():
                raise AssertionError("(f) /result differs from the "
                                     "in-process row")
            _, m = call("/metrics")
            _, h = call("/healthz")
            if not h["ok"] or m["programs"]["device_calls"] < 1:
                raise AssertionError(f"(f) /healthz {h} /metrics programs "
                                     f"{m['programs']}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log(f"  (f) python -m psrsigsim_torch.serve: ready in {t_ready:.1f} "
            f"s; 3 POST /simulate done, /result equal to the in-process "
            f"row, /metrics device calls {m['programs']['device_calls']}, "
            f"/healthz ok; SIGTERM drained, exit {rc}")
        if rc != 0:
            raise AssertionError(f"(f) the server exited {rc} on SIGTERM")

    # -- 18 -----------------------------------------------------------------
    def fleet(self):
        """The serving fleet on the card (see the module docstring)."""
        import shutil
        import tempfile

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="fleet-", dir=build)
        try:
            self._fleet(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def _fleet(self, work):
        import numpy as np

        from psrsigsim_torch.serve import (SimulationService, build_geometry,
                                           canonicalize)

        for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_INTEGRITY"):
            os.environ.pop(k, None)
        specs = {leg: {i: serve_spec(i) for i in ix}
                 for leg, ix in FLEET_STREAMS.items()}
        # every stream's bytes from an in-process service on the card
        n_all = sum(len(v) for v in specs.values())
        svc = SimulationService(widths=SERVE_WIDTHS, device=self.dev,
                                max_queue=n_all)
        try:
            svc.warmup(SERVE_SPEC)
            calls0 = svc.registry.device_calls
            self._zero_counts()
            t0 = time.perf_counter()
            ids = {i: svc.submit(sp)[0] for leg in specs
                   for i, sp in specs[leg].items()}
            want = {i: svc.result(rid, timeout=600).tobytes()
                    for i, rid in ids.items()}
            t_ref = time.perf_counter() - t0
            counts = self._counts()
            execs = svc.registry.device_calls - calls0
        finally:
            svc.close()
        log(f"  in-process service on the card: {len(want)} requests in "
            f"{t_ref:.2f} s, {execs} bucket executions, launches {counts}")
        if counts != {"rng_field": 2 * execs, "fold_quantize": 0,
                      "packed_digest": 0}:
            raise AssertionError(f"in-process launches {counts}, expected "
                                 f"2 x {execs} of rng_field alone")
        cfg, _, _ = build_geometry(canonicalize(SERVE_SPEC))
        for row in want.values():
            arr = np.frombuffer(row, np.float32)
            if arr.size != cfg.meta.nchan * cfg.nph or not np.isfinite(
                    arr).all():
                raise AssertionError("an in-process profile has the wrong "
                                     "size or a non-finite value")
        self._fleet_work, self._fleet_want = work, want
        self._fleet_warm = os.path.join(work, "warm.json")
        with open(self._fleet_warm, "w") as f:
            json.dump(SERVE_SPEC, f)
        try:
            # (c) solo: one replica over a fresh cache
            fleet = self._fleet_start(1, "solo")
            try:
                solo = self._fleet_burst("(c) solo", fleet, specs["c"],
                                         FLEET_CLIENTS_C)
            finally:
                fleet.drain()
            # (c) fleet, (a) and (b): two replicas over a fresh cache
            fleet = self._fleet_start(2, "pair")
            try:
                duo = self._fleet_burst("(c) fleet", fleet, specs["c"],
                                        FLEET_CLIENTS_C)
                self._fleet_path(fleet, specs["a"])
                self._fleet_chaos(fleet, specs["b"])
            finally:
                codes = fleet.drain()
            self._fleet_audit("(a)-(c) pair", "pair", codes,
                              len(specs["c"]) + len(specs["a"])
                              + len(specs["b"]))
            ratio = solo["wall_s"] / duo["wall_s"]
            log(f"  (c) fleet_over_solo {ratio:.3f}: solo "
                f"{solo['req_s']:.2f} req/s, fleet {duo['req_s']:.2f} req/s "
                f"({self.card_line})")
            # (d) the elastic ramp
            self._fleet_elastic(specs["d"])
        except Exception:
            self._fleet_logs()
            raise

    def _fleet_start(self, n, cache, **kw):
        """A started fleet of ``n`` replicas on the card over
        ``build/.../<cache>``, and its boot time logged."""
        from psrsigsim_torch.serve import ReplicaFleet

        kw.setdefault("quorum", 1)
        fleet = ReplicaFleet(
            n, os.path.join(self._fleet_work, cache), widths=SERVE_WIDTHS,
            warmup_path=self._fleet_warm,
            log_dir=os.path.join(self._fleet_work, "logs"), **kw)
        t0 = time.perf_counter()
        fleet.start()
        if fleet.healthy_count() != n:
            fleet.drain()
            raise AssertionError(f"{fleet.healthy_count()} of {n} replicas "
                                 f"came up: {fleet.health()}")
        log(f"  {n} replica(s) over {cache}: ready in "
            f"{time.perf_counter() - t0:.1f} s (started one after another)")
        return fleet

    def _fleet_logs(self):
        logs = os.path.join(self._fleet_work, "logs")
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
            with open(os.path.join(logs, name), errors="replace") as f:
                tail = f.read()[-3000:]
            log(f"  --- {name} (tail)\n{tail}")

    def _fleet_replicas(self, fleet, path):
        """``{replica id: GET path}`` over the live replicas."""
        import urllib.request

        out = {}
        for rid, url in fleet.endpoints():
            with urllib.request.urlopen(url + path, timeout=60) as r:
                out[rid] = json.loads(r.read())
        return out

    def _fleet_drive(self, router, specs, clients):
        """Serve ``specs`` through ``router`` from ``clients`` threads; every
        request must reach done, bit-equal to the in-process service.
        ``(wall_s, latencies)``."""
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        bad = []

        def one(i):
            t0 = time.perf_counter()
            status, resp = router.submit(specs[i], deadline_s=FLEET_DEADLINE_S,
                                         wait=True)
            lat = time.perf_counter() - t0
            if status != 200 or resp.get("status") != "done":
                raise AssertionError(f"request {i}: HTTP {status} "
                                     f"{str(resp)[:300]}")
            if np.asarray(resp["profile"], np.float32).tobytes() \
                    != self._fleet_want[i]:
                bad.append(i)
            return lat

        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            lats = list(pool.map(one, sorted(specs)))
        wall = time.perf_counter() - t0
        if bad:
            raise AssertionError(f"{len(bad)} profiles differ from the "
                                 f"in-process service's: {sorted(bad)[:8]}")
        return wall, lats

    def _fleet_burst(self, label, fleet, specs, clients):
        """One timed burst through a fresh router: req/s, p50/p99, the
        card's busy share and the replicas' stage seconds."""
        import numpy as np

        from psrsigsim_torch.serve import FleetRouter

        router = FleetRouter(fleet, **FLEET_ROUTER)
        try:
            m0 = self._fleet_replicas(fleet, "/metrics")
            with GpuBusy() as busy:
                wall, lats = self._fleet_drive(router, specs, clients)
            m1 = self._fleet_replicas(fleet, "/metrics")
            share = router.stats()["per_replica"]
        finally:
            router.close()
        stages = {k: sum(m1[r]["stages"][k + "_s"] - m0[r]["stages"][k + "_s"]
                         for r in m1) for k in ("compute", "respond")}
        p50, p99 = np.percentile(lats, [50, 99])
        out = {"req_s": len(specs) / wall, "wall_s": wall, "p50_s": p50,
               "p99_s": p99, "busy": busy.share, "busy_samples": busy.n,
               "per_replica": share, **{f"{k}_s": v for k, v in
                                        stages.items()}}
        log(f"  {label}: {len(specs)} requests from {clients} clients over "
            f"{len(m1)} replica(s): {out['req_s']:.2f} req/s, p50 "
            f"{p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms; card busy "
            f"{busy.share:.1%} (nvidia-smi, {busy.n} samples); replicas' "
            f"compute {stages['compute']:.3f} s, respond "
            f"{stages['respond']:.3f} s of a {wall:.3f} s wall; requests "
            f"per replica {share} ({self.card_line})")
        return out

    def _fleet_path(self, fleet, specs):
        """(a): the fleet's main path, its kernels read from each replica's
        /healthz just before and just after."""
        from psrsigsim_torch.serve import FleetRouter

        router = FleetRouter(fleet, **FLEET_ROUTER)
        try:
            h0 = self._fleet_replicas(fleet, "/healthz")
            wall, _ = self._fleet_drive(router, specs, FLEET_CLIENTS_A)
            h1 = self._fleet_replicas(fleet, "/healthz")
            share = router.stats()["per_replica"]
        finally:
            router.close()
        if set(h0) != set(h1) or len(h1) != 2:
            raise AssertionError(f"(a) replicas changed under the burst: "
                                 f"{sorted(h0)} -> {sorted(h1)}")
        execs = sum(h1[r]["device_calls"] - h0[r]["device_calls"] for r in h1)
        launches = {k: sum(h1[r]["kernel_launches"][k]
                           - h0[r]["kernel_launches"][k] for r in h1)
                    for k in h1[min(h1)]["kernel_launches"]}
        builds = {r: h1[r]["compile_counts"] for r in h1}
        log(f"  (a) 2 replicas, {len(specs)} requests from "
            f"{FLEET_CLIENTS_A} clients in {wall:.2f} s, bit-equal to the "
            f"in-process service; requests per replica {share}; bucket "
            f"executions {execs} "
            f"({ {r: h1[r]['device_calls'] - h0[r]['device_calls'] for r in h1} }"
            f"); kernel launches read from /healthz {launches}, derived "
            f"2 x executions = {2 * execs}; builds per replica {builds}")
        if launches != {"rng_field": 2 * execs, "rng_flat_field": 0,
                        "fold_quantize": 0, "packed_digest": 0} or execs <= 0:
            raise AssertionError(f"(a) launches {launches}, expected 2 x "
                                 f"{execs} of rng_field alone")
        if any(c != 1 for b in builds.values() for c in b.values()):
            raise AssertionError(f"(a) a replica built a bucket twice: "
                                 f"{builds}")
        if sum(share.values()) != len(specs):
            raise AssertionError(f"(a) routed {share}")
        self._path("fleet", {"rng_field": launches["rng_field"]})

    def _fleet_chaos(self, fleet, specs):
        """(b): replica.kill mid-traffic, failover and restart."""
        import signal
        import threading

        from psrsigsim_torch.runtime import FaultPlan
        from psrsigsim_torch.serve import FleetRouter

        plan = FaultPlan(os.path.join(self._fleet_work, "chaos-scratch"),
                         {"replica.kill": {"after_requests":
                                           FLEET_KILL_AFTER}})
        gens = {i: fleet.endpoint_gen(i) for i, _ in fleet.endpoints()}
        killed, ready = {}, {}
        kill = fleet.kill_replica

        def timed_kill(i, sig=signal.SIGKILL):
            killed[i] = time.perf_counter()
            kill(i, sig)

        fleet.kill_replica = timed_kill
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                for i in killed:
                    if i not in ready and fleet.endpoint_gen(i) > gens[i]:
                        ready[i] = time.perf_counter()
                time.sleep(0.01)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        router = FleetRouter(fleet, faults=plan, **FLEET_ROUTER)
        try:
            wall, _ = self._fleet_drive(router, specs, FLEET_CLIENTS_A)
            t_end = time.monotonic() + 300
            while (fleet.healthy_count() < 2 or len(ready) < len(killed)) \
                    and time.monotonic() < t_end:
                time.sleep(0.05)
            st = router.stats()
        finally:
            stop.set()
            watcher.join()
            router.close()
            fleet.kill_replica = kill
        restarts = sum(fleet.health()["restarts"].values())
        spans = {i: ready[i] - killed[i] for i in ready}
        log(f"  (b) replica.kill after {FLEET_KILL_AFTER} of {len(specs)} "
            f"requests: kills fired {st['kills_fired']} (replica "
            f"{sorted(killed)}), failovers {st['failovers']}, restarts "
            f"{restarts}, all {len(specs)} bit-equal in {wall:.2f} s; "
            f"from the kill to the restarted replica's ready line "
            + ", ".join(f"{spans[i]:.1f} s" for i in sorted(spans))
            + f" ({self.card_line})")
        if st["kills_fired"] < 1 or restarts < 1 or st["failovers"] < 1 \
                or fleet.healthy_count() != 2 or len(spans) != len(killed):
            raise AssertionError(f"(b) no kill, failover or restart: {st}, "
                                 f"restarts {restarts}, {fleet.health()}")

    def _fleet_audit(self, label, cache, codes, n):
        """The drained cache under a verify re-hash: no lost or torn
        commit, no leaked claim or temp file, every replica exited 0."""
        from psrsigsim_torch.serve import ResultCache

        d = os.path.join(self._fleet_work, cache)
        c = ResultCache(d, verify=True)
        entries, dropped = len(c), c.dropped
        c.close()
        claims = os.listdir(os.path.join(d, "claims"))
        tmps = [x for x in os.listdir(os.path.join(d, "results"))
                if x.endswith(".tmp")]
        log(f"  {label}: drained, exit codes {codes}; verify re-hash: "
            f"{entries} entries for {n} requests, {dropped} lost or torn, "
            f"{len(claims)} claims and {len(tmps)} temp files left")
        if dropped or claims or tmps or entries != n or set(
                codes.values()) != {0}:
            raise AssertionError(f"{label}: the shared cache lost commits")

    def _fleet_elastic(self, specs):
        """(d): an autoscaled fleet scales up under a burst and back down
        through a SIGTERM drain when idle; nothing lost."""
        from psrsigsim_torch.serve import FleetRouter

        fleet = self._fleet_start(
            1, "elastic", autoscale=True, min_replicas=1, max_replicas=2,
            max_queue=16, scale_up_queue_frac=0.1,
            scale_down_queue_frac=0.02, scale_interval_s=0.05,
            scale_up_cooldown_s=0.1, scale_down_cooldown_s=1.0,
            health_interval_s=0.05)
        ix = sorted(specs)
        waves = [ix[0:32], ix[32:64], ix[64:96]]
        served = 0
        try:
            router = FleetRouter(fleet, **FLEET_ROUTER)
            t0 = time.perf_counter()
            for wave in waves:
                self._fleet_drive(router, {i: specs[i] for i in wave}, 8)
                served += len(wave)
                t_end = time.monotonic() + 5.0
                while time.monotonic() < t_end and not (
                        fleet.pending_scale_up() or fleet.scale_events):
                    time.sleep(0.05)
                if fleet.pending_scale_up() or fleet.scale_events:
                    break
            t_end = time.monotonic() + 300
            while fleet.healthy_count() < 2 and time.monotonic() < t_end:
                time.sleep(0.1)
            up = fleet.healthy_count() == 2
            t_up = time.perf_counter() - t0
            wave_b = {i: specs[i] for i in ix[96:104]}
            self._fleet_drive(router, wave_b, 4)
            served += len(wave_b)
            t_end = time.monotonic() + 300
            while fleet.active_count() > 1 and time.monotonic() < t_end:
                time.sleep(0.1)
            down = fleet.active_count() == 1
            wave_c = {i: specs[i] for i in ix[104:108]}
            self._fleet_drive(router, wave_c, 2)
            served += len(wave_c)
            events = [(e["action"], e["replica"]) for e in fleet.scale_events]
            router.close()
        finally:
            codes = fleet.drain()
        log(f"  (d) elastic 1 -> 2 -> 1: scaled up {up}, down {down}, "
            f"events {events}, {served} requests bit-equal, up within "
            f"{t_up:.1f} s of the first burst")
        if not (up and down) or [a for a, _ in events] != ["up", "down"]:
            raise AssertionError(f"(d) the fleet did not scale up and back "
                                 f"down: {events}")
        self._fleet_audit("(d) elastic", "elastic", codes, served)

    # -- 19 -----------------------------------------------------------------
    def exact_gamma(self):
        """The exact-gamma χ² branch (see the module docstring)."""
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.ops import gamma, stats
        from psrsigsim_torch.simulate.pipeline import fused_route
        from psrsigsim_torch.utils import fold_in, key, stage_key

        torch = self.torch
        dev = self.dev
        for k in ("PSS_SAMPLER", "PSS_EXACT_CHI2", "PSS_EXACT_SHIFT"):
            os.environ.pop(k, None)
        ens = geometry(GAMMA_MAIN, dev)
        cfg = ens.cfg
        C, L = cfg.meta.nchan, cfg.nsamp
        nblk = -(-L // stats.SEQ_RNG_BLOCK)
        log(f"  Nfold {cfg.nfold:g} (noise df {cfg.noise_df:g}), {C} x {L} "
            f"({cfg.nsub} x {cfg.nph}); fused_route {fused_route(cfg, dev)}")
        if cfg.nfold >= stats.CHI2_WH_MIN_DF or fused_route(cfg, dev):
            raise AssertionError("phase 19's geometry must take the exact "
                                 "branch on the unfused route")

        # (a) K9 against its plain version on the card, bit for bit: the
        # (observation, channel, block) keys of a whole 128-observation
        # chunk's pulse field, and a shape-level draw
        obs = stage_key(key(0, dev), "user",
                        torch.arange(MAIN_NOBS, device=dev))
        rows = fold_in(fold_in(stage_key(obs, "pulse")[:, None, :],
                               torch.arange(C, device=dev))[..., None, :],
                       torch.arange(nblk, device=dev)).reshape(-1, 2)
        R, n = rows.shape[0], stats.SEQ_RNG_BLOCK
        worst, passes, plain_full_ms = 0.0, {}, None
        for alpha in GAMMA_ALPHAS:
            a = torch.full((R,), alpha, device=dev)
            got = gamma.gamma_field(rows, a, n, scale=2.0)
            counts = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            diff = 0
            for r0 in range(0, R, GAMMA_PLAIN_ROWS):
                want = stats.gamma_plain(rows[r0:r0 + GAMMA_PLAIN_ROWS],
                                         a[r0:r0 + GAMMA_PLAIN_ROWS], n,
                                         scale=2.0, counts=counts)
                part = got[r0:r0 + GAMMA_PLAIN_ROWS]
                diff += int((part.view(torch.int32)
                             != want.view(torch.int32)).sum())
                worst = max(worst, float((part - want).abs().max()))
                del want
            torch.cuda.synchronize()
            t_plain = (time.perf_counter() - t0) * 1e3
            passes[alpha] = {k: v / (R * n) for k, v in counts.items()}
            if alpha == 10.0:
                plain_full_ms = t_plain
            log(f"  (a) K9 vs gamma_plain, alpha {alpha:g}, {R} x {n} "
                f"(obs, channel, block) rows: {diff} of {R * n} differ; "
                f"passes per element {passes[alpha]}; plain {t_plain:.0f} ms")
            if diff:
                raise AssertionError(f"K9 differs from gamma_plain at alpha "
                                     f"{alpha}")
            del got
        # (the last is the receiver noise's form, V = v^3 at the noise df)
        k1 = stage_key(key(5, dev), "user", 0)[None]
        for alpha, traced, cube in ((10.0, True, False), (0.3, False, False),
                                    (0.5, True, False),
                                    (cfg.noise_df / 2.0, False, True)):
            a = torch.full((1,), alpha, device=dev)
            got = gamma.gamma_field(k1, a, C * L, scale=2.0, traced=traced,
                                    cube=cube)
            want = stats.gamma_plain(k1, a, C * L, traced=traced, scale=2.0,
                                     cube=cube)
            diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            log(f"  (a) shape-level draw ({C} x {L} from one key), alpha "
                f"{alpha:g} {'traced' if traced else 'static'}"
                f"{', cube=True' if cube else ''}: {diff} differ")
            if diff:
                raise AssertionError("K9 differs from gamma_plain on a "
                                     "shape-level draw")
        self.kernels["gamma_field"]["max_abs_err"] = worst

        # (b) the card draws what the host draws: one observation's field
        one = rows[:C * nblk]
        a = torch.full((one.shape[0],), cfg.nfold / 2.0, device=dev)
        t0 = time.perf_counter()
        card = stats.gamma_plain(one, a, n, scale=2.0)
        torch.cuda.synchronize()
        plain_one_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = gamma.gamma_field(one.cpu(), a.cpu(), n, scale=2.0)
        host_ms = (time.perf_counter() - t0) * 1e3
        diff = int((card.cpu().view(torch.int32)
                    != host.view(torch.int32)).sum())
        log(f"  (b) one observation's field ({one.shape[0]} x {n}): the "
            f"card's plain version against the host's: {diff} differ "
            f"(card {plain_one_ms:.0f} ms, host {host_ms:.0f} ms)")
        if diff:
            raise AssertionError("the card's plain version differs from the "
                                 "host's")

        # (c) statistics of 1e7 draws against chi2(df)
        from scipy import stats as sps

        for df in GAMMA_STAT_DFS:
            x = stats._exact_chi2(key(9, dev), df, (GAMMA_STAT_N,),
                                  traced=False).double()
            mean, var = float(x.mean()), float(x.var())
            xs = torch.sort(x).values.cpu().numpy()
            cdf = sps.chi2.cdf(xs, df)
            i = np.arange(1, GAMMA_STAT_N + 1) / GAMMA_STAT_N
            ks = float(max((i - cdf).max(), (cdf - (i - 1 / GAMMA_STAT_N)).max()))
            se_mean = np.sqrt(2 * df / GAMMA_STAT_N)
            se_var = np.sqrt((12 * df * (df + 4) + 2 * (2 * df) ** 2)
                             / GAMMA_STAT_N)
            ks_crit = 1.95 / np.sqrt(GAMMA_STAT_N)  # 0.1% level
            log(f"  (c) df {df:g}: mean {mean:.6f} ({(mean - df) / se_mean:+.2f}"
                f" sigma), var {var:.5f} ({(var - 2 * df) / se_var:+.2f} "
                f"sigma), KS {ks:.3g} (0.1% critical {ks_crit:.3g})")
            if (abs(mean - df) > 6 * se_mean or abs(var - 2 * df) > 6 * se_var
                    or ks > ks_crit):
                raise AssertionError(f"1e7 draws of chi2({df}) fail the "
                                     "statistics")
            del x

        # (d) the main path at Nfold 20: run_quantized(128), chunk sizes,
        # then iter_chunks -> the PSRFITS export with one writer
        ens.run_quantized(8, seed=0)
        torch.cuda.synchronize()
        self._zero_counts()
        t0 = time.perf_counter()
        d, s_, o_ = ens.run_quantized(MAIN_NOBS, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = self._counts()
        want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                "gamma_field": 2}
        if counts != want:
            raise AssertionError(f"run_quantized({MAIN_NOBS}) at Nfold 20: "
                                 f"launches {counts}, expected {want}")
        self.kernels["gamma_field"]["launches"] = counts["gamma_field"]
        self._path(f"19 run_quantized({MAIN_NOBS}) Nfold 20", counts)
        rate_d = MAIN_NOBS / wall
        half = np.concatenate([c[1][0] for c in ens.iter_chunks(
            MAIN_NOBS, chunk_size=MAIN_NOBS // 2, seed=0, quantized=True,
            byte_order="little")])
        same = bool(np.array_equal(half, d.cpu().numpy()))
        log(f"  (d) run_quantized({MAIN_NOBS}) at Nfold 20: {wall:.3f} s = "
            f"{rate_d:.1f} obs/s; launches {counts}; codes of chunk sizes "
            f"{MAIN_NOBS // 2} and {MAIN_NOBS} equal: {same}")
        if not same:
            raise AssertionError("codes differ between chunk sizes")
        del d, s_, o_, half
        self.device_breakdown("(d) run_quantized(128) at Nfold 20",
                              lambda: ens.run_quantized(MAIN_NOBS, seed=0))
        from psrsigsim_torch.io import export_ensemble_psrfits

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="gamma-export-", dir=build)
        try:
            self._zero_counts()
            t0 = time.perf_counter()
            paths = export_ensemble_psrfits(
                ens, GAMMA_EXPORT_NOBS, work, TEMPLATE, ens.pulsar, seed=0,
                chunk_size=MAIN_NOBS, writers=1)
            wall = time.perf_counter() - t0
            counts = self._counts()
            nbytes = sum(os.path.getsize(p) for p in paths)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                "gamma_field": 4}
        self._path(f"19 export({GAMMA_EXPORT_NOBS}) Nfold 20", counts)
        log(f"  (d) iter_chunks -> export of {GAMMA_EXPORT_NOBS} at Nfold 20, "
            f"writers=1: {len(paths)} files, {nbytes / 1e9:.3f} GB in "
            f"{wall:.3f} s = {GAMMA_EXPORT_NOBS / wall:.1f} obs/s; launches "
            f"{counts}")
        if counts != want or len(paths) != GAMMA_EXPORT_NOBS:
            raise AssertionError(f"export: launches {counts}, expected {want}")

        # (e) BASELINE config 1 unchanged under PSS_EXACT_CHI2=1
        main = self.main_ensemble()
        os.environ["PSS_EXACT_CHI2"] = "1"
        try:
            if fused_route(main.cfg, dev):
                raise AssertionError("the hatch must leave the fused route")
            main.run_quantized(8, seed=0)
            torch.cuda.synchronize()
            self._zero_counts()
            t0 = time.perf_counter()
            d, _, _ = main.run_quantized(MAIN_NOBS, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
        finally:
            del os.environ["PSS_EXACT_CHI2"]
        self._path(f"19 run_quantized({MAIN_NOBS}) config 1 hatch", counts)
        log(f"  (e) config 1 (Nfold {main.cfg.nfold:g}) under PSS_EXACT_CHI2=1:"
            f" run_quantized({MAIN_NOBS}) {wall:.3f} s = "
            f"{MAIN_NOBS / wall:.1f} obs/s; launches {counts}")
        want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                "gamma_field": 2}
        if counts != want:
            raise AssertionError(f"hatch run_quantized: launches {counts}, "
                                 f"expected {want}")
        if d.shape[0] != MAIN_NOBS:
            raise AssertionError("hatch run_quantized: wrong shape")
        del d

        # (f) one object-oriented observation at Nfold 20, card and host
        flows = {}
        for where in (dev, "cpu"):
            self._zero_counts()
            flows[str(where)] = self._gamma_oo(where)
            if where == dev:
                counts = self._counts()
        self._path("19 object-oriented Nfold 20", counts)
        a, b = flows[str(dev)], flows["cpu"]
        pulses_equal = torch.equal(a["pulses"].cpu(), b["pulses"])
        obs_err = float((a["obs"].cpu() - b["obs"]).abs().max()
                        / b["obs"].abs().max())
        log(f"  (f) make_pulses -> disperse -> observe(noise) at Nfold "
            f"{a['nfold']:g}, {tuple(a['obs'].shape)}: pulses card == host "
            f"{pulses_equal}; observed max |card-host| / peak {obs_err:.3g}; "
            f"launches {counts}")
        if (not pulses_equal or obs_err > 2e-5 or counts.get("gamma_field") != 2
                or not bool(torch.isfinite(a["obs"]).all())):
            raise AssertionError("the object-oriented flow at Nfold 20 failed")

        # (g) SEARCH under the hatch at config 4's geometry
        from psrsigsim_torch.simulate import single_pipeline

        cfg4, prof4, nn4 = config4()
        C4, L4 = cfg4.meta.nchan, cfg4.nsamp
        hk = stage_key(key(0, "cpu"), "user", torch.arange(GAMMA_SEARCH_NOBS))
        freqs = torch.as_tensor(np.asarray(cfg4.meta.dat_freq_mhz(),
                                           np.float32), device=dev)
        def search():
            return single_pipeline(
                hk, torch.full((GAMMA_SEARCH_NOBS,), CONFIG4["dm"]),
                torch.full((GAMMA_SEARCH_NOBS,), nn4, dtype=torch.float32),
                torch.as_tensor(prof4, device=dev), cfg4, freqs=freqs,
                chan_ids=torch.arange(C4))

        os.environ["PSS_EXACT_CHI2"] = "1"
        try:
            search()  # warm: the timed call below is not a first call
            torch.cuda.synchronize()
            self._zero_counts()
            t0 = time.perf_counter()
            block = search()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = self._counts()
        finally:
            del os.environ["PSS_EXACT_CHI2"]
        self._path(f"19 single_pipeline({GAMMA_SEARCH_NOBS}) hatch", counts)
        live = 1.0 - cfg4.n_null / cfg4.nsub
        expect = (cfg4.draw_norm * prof4.astype(np.float64).mean(axis=1) * live
                  * (cfg4.nsub * cfg4.nph / L4) + cfg4.noise_df * nn4)
        rel = np.abs(block.double().mean(dim=(0, 2)).cpu().numpy() / expect
                     - 1)
        log(f"  (g) single_pipeline({GAMMA_SEARCH_NOBS}) under the hatch at "
            f"{C4} x {L4}: {wall:.3f} s = {GAMMA_SEARCH_NOBS / wall:.2f} obs/s "
            f"(after a warm call); launches {counts}; channel means max rel "
            f"dev {rel.max():.3g}")
        want = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0,
                "gamma_field": 3}
        if (counts != want or rel.max() > 0.02
                or not bool(torch.isfinite(block).all())):
            raise AssertionError("SEARCH under the hatch failed")
        del block

        # (h) K9's time at the main path's shape (one chunk's pulse field)
        a = torch.full((R,), cfg.nfold / 2.0, device=dev)
        ms = cuda_time_ms(lambda: gamma.gamma_field(rows, a, n, scale=2.0), 5)
        alphas = torch.full((R, n), cfg.nfold / 2.0, device=dev)
        library_ms = cuda_time_ms(lambda: torch._standard_gamma(alphas), 5)
        del alphas
        # the threefry calls the output needs (csrc/gamma_field.cu's
        # bound): the element's key, then its first pass's key; three a
        # pass and one after each rejection; two an inner pass and one
        # after each repeat; two a boost
        p = passes[10.0]
        calls = 1 + 3 * p["outer"] + 3 * p["inner"] + 2 * p["boost"]
        int_ops = THREEFRY_INT_OPS * calls + 4 * (p["outer"] + p["inner"])
        fp_ops = GAMMA_FP32_INNER * p["inner"] + GAMMA_FP32_OUTER * p["outer"] + 2
        t_issue = (int_ops + fp_ops) * R * n / ISSUE_RATE * 1e3
        t_bytes = (4 * R * n + R * (8 + 16)) / PEAK_BYTES_PER_S * 1e3
        b_ms = max(t_issue, t_bytes)
        b_by = "operations" if t_issue >= t_bytes else "bytes"
        # the integer pipe alone (64 a clock) is no bound here: ptxas
        # issues part of the adds as IMAD on the FMA pipe
        parts = {"issue": t_issue, "bytes": t_bytes,
                 "int32_pipe_alone": int_ops * R * n / RATES["int32"] * 1e3}
        self.kernels["gamma_field"].update(
            name="gamma_field", route="cuda",
            source="psrsigsim_torch/csrc/gamma_field.cu",
            replaces="psrsigsim_tpu/ops/stats.py:50 (_exact_chi2: "
                     "jax.random.gamma, an XLA while loop, no Pallas kernel)",
            ms=ms, plain_ms=plain_full_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
        log(f"  (h) gamma_field ({R} x {n}, alpha {cfg.nfold / 2:g}): {ms:.4f} "
            f"ms; plain {plain_full_ms:.0f} ms ({plain_one_ms:.0f} ms at one "
            f"observation); torch._standard_gamma {library_ms:.4f} ms; "
            f"{calls:.3f} threefry calls, {int_ops:.1f} integer and "
            f"{fp_ops:.1f} float32 operations an element; bound {b_ms:.4f} "
            f"ms, {b_by} at the issue limit ({fmt_parts(parts)}); K9 at "
            f"{b_ms / ms:.1%} of it, on {self.card_line}")

    def _gamma_oo(self, device):
        """Phase 19(f): make_pulses -> ISM().disperse -> observe(noise) of
        one fold observation at Nfold 20 and config 1's width, on
        ``device``."""
        from psrsigsim_torch.ism import ISM
        from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
        from psrsigsim_torch.models.telescope import (Backend, Receiver,
                                                      Telescope)
        from psrsigsim_torch.signal import FilterBankSignal

        g = GAMMA_MAIN
        with contextlib.redirect_stdout(io.StringIO()):
            sig = FilterBankSignal(g["fcent"], g["bw"], Nsubband=g["nchan"],
                                   sample_rate=g["samprate_mhz"], fold=True,
                                   sublen=g["sublen_s"], device=device)
        psr = Pulsar(g["period_s"], g["smean"], GaussProfile(width=0.05),
                     name="P", seed=3)
        psr.make_pulses(sig, tobs=g["tobs_s"])
        pulses = sig.data.clone()
        ISM().disperse(sig, dm=g["dm"])
        tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="T")
        tel.add_system("S", Receiver(fcent=g["fcent"], bandwidth=g["bw"],
                                     name="R", seed=4),
                       Backend(samprate=12.5, name="B"))
        tel.observe(sig, psr, system="S", noise=True)
        if device != "cpu":
            self.torch.cuda.synchronize()
        return {"pulses": pulses, "obs": sig.data, "nfold": sig.Nfold}

    # -- 20 -----------------------------------------------------------------
    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def _expect(self, label, want):
        """The launches since :meth:`_zero_counts` must be ``want`` (the
        kernels it omits: none); recorded under ``label``."""
        counts = self._counts()
        full = {"rng_field": 0, "fold_quantize": 0, "packed_digest": 0}
        full.update(want)
        full = {k: v for k, v in full.items()
                if v or k in ("rng_field", "fold_quantize", "packed_digest")}
        if counts != full:
            raise AssertionError(f"{label}: launches {counts}, expected {full}")
        self._path(label, counts)
        return counts

    def _timed(self, fn):
        """``fn()`` once, after the card is idle: ``(result, seconds)``."""
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        return out, time.perf_counter() - t0

    def meshes(self):
        """Meshes and sequence sharding on one card (see the module
        docstring): every mesh of repeated cuda:0 positions, so the shards
        run in series — the cost of sharding, not a speed-up."""
        for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        self._mesh_seq_search()
        self._mesh_obs_seq()
        self._mesh_baseband()
        self._mesh_fold()
        self._mesh_users()
        self._mesh_exact()
        self._mesh_guard()
        log(f"  phase 20 steps done in {time.perf_counter() - t0:.1f} s "
            f"({self.card_line})")

    def _seq_inputs(self):
        torch = self.torch
        from psrsigsim_torch.utils import key, stage_key

        cfg, prof, nn = config4()
        hk = stage_key(key(0, "cpu"), "user", torch.tensor(0))
        return cfg, torch.as_tensor(prof, device=self.dev), nn, hk

    def _mesh_seq_search(self):
        """(a) seq_sharded_search at config 4, n in SEQ_NS, both modes."""
        torch = self.torch
        import dataclasses

        from psrsigsim_torch.parallel import make_seq_mesh, seq_sharded_search
        from psrsigsim_torch.simulate import single_pipeline

        cfg, pdev, nn, hk = self._seq_inputs()
        dm = CONFIG4["dm"]
        for mode in ("envelope", "fft"):
            c = dataclasses.replace(cfg, shift_mode=mode)

            def single(c=c):
                return single_pipeline(hk, torch.tensor(dm),
                                       torch.tensor(nn, dtype=torch.float32),
                                       pdev, c)

            single()
            ref, t_single = self._timed(single)
            l2 = float(torch.sqrt((ref.double() ** 2).mean() * ref.shape[-1]))
            log(f"  (a) {mode}: single_pipeline(1) at {cfg.meta.nchan} x "
                f"{cfg.nsamp}: {t_single * 1e3:.2f} ms")
            for n in SEQ_NS:
                run = seq_sharded_search(
                    c, make_seq_mesh(devices=[self.dev] * n))
                run(hk, dm, nn, pdev)
                self._zero_counts()
                out, t = self._timed(lambda: run(hk, dm, nn, pdev))
                # per shard: the pulse and noise fields (one flat launch
                # each: every channel's span shares the tile phase) and
                # the nulled pulses' replacement row
                counts = self._expect(f"20a seq_search {mode} n={n}",
                                      {"rng_field": n,
                                       "rng_flat_field": 2 * n})
                if tuple(out.shape) != tuple(ref.shape) or not bool(
                        torch.isfinite(out).all()):
                    raise AssertionError(f"seq_search {mode} n={n}: shape "
                                         "or non-finite")
                err = float((out - ref).abs().max())
                equal = bool(torch.equal(out, ref))
                log(f"  (a) {mode} n={n:2d} (L={cfg.nsamp // n}"
                    f"{'' if (cfg.nsamp // n) % 4096 == 0 else ', unaligned'}"
                    f"): {t * 1e3:.2f} ms, launches {counts}; against "
                    f"single_pipeline: bit-equal {equal}, max|diff| "
                    f"{err:.3g} ({err / l2:.3g} of l2)")
                if mode == "envelope" and not equal:
                    raise AssertionError(f"envelope seq_search n={n} is not "
                                         "bit-equal to single_pipeline")
                if err >= 1e-5 * l2:
                    raise AssertionError(f"fft seq_search n={n}: max|diff| "
                                         f"{err:.3g} >= 1e-5 l2")
                del out
            del ref

    def _mesh_obs_seq(self):
        """(b) seq_sharded_search_ensemble, SEQ_ENS_NOBS observations."""
        torch = self.torch

        from psrsigsim_torch.parallel import (make_obs_seq_mesh,
                                              seq_sharded_search_ensemble)
        from psrsigsim_torch.simulate import single_pipeline
        from psrsigsim_torch.utils import key, stage_key

        cfg, pdev, nn, _ = self._seq_inputs()
        B = SEQ_ENS_NOBS
        hk = stage_key(key(0, "cpu"), "user", torch.arange(B))
        dms = torch.full((B,), CONFIG4["dm"])
        nns = torch.full((B,), nn, dtype=torch.float32)
        ref = single_pipeline(hk, dms, nns, pdev, cfg)
        phase13 = getattr(self, "search_rate", None)
        for shape in SEQ_ENS_SHAPES:
            k = shape[0] * shape[1]
            run = seq_sharded_search_ensemble(
                cfg, make_obs_seq_mesh(shape, [self.dev] * k))
            run(hk, dms, nns, pdev)
            self._zero_counts()
            out, t = self._timed(lambda: run(hk, dms, nns, pdev))
            counts = self._expect(f"20b obs_seq {shape}",
                                  {"rng_field": k, "rng_flat_field": 2 * k})
            equal = bool(torch.equal(out, ref))
            log(f"  (b) obs x seq {shape}: {B} observations in "
                f"{t * 1e3:.2f} ms = {B / t:.1f} obs/s (phase 13's "
                f"single_pipeline({SEARCH_NOBS}): "
                f"{phase13[0] if phase13 else float('nan'):.1f} obs/s), "
                f"launches {counts}; bit-equal to single_pipeline({B}) "
                f"{equal}")
            if not equal:
                raise AssertionError(f"obs x seq {shape} differs from "
                                     "single_pipeline")
            del out
        del ref

    def _mesh_baseband(self):
        """(c) seq_sharded_baseband / seq_sharded_dedisperse at config 3."""
        torch = self.torch
        import numpy as np

        from psrsigsim_torch.ops.shift import coherent_dedisperse
        from psrsigsim_torch.ops.stats import flat_normal_field, flat_spans
        from psrsigsim_torch.parallel import (make_seq_mesh,
                                              seq_sharded_baseband,
                                              seq_sharded_dedisperse)
        from psrsigsim_torch.utils import key, stage_key
        from psrsigsim_torch.utils.device import to_device

        cfg, sp, nn = config3()
        dm = CONFIG3["dm"]
        npol, L = sp.shape[0], cfg.nsamp
        hk = stage_key(key(0, "cpu"), "user", torch.tensor(0))
        # the draws: each slab's spans are baseband_pipeline's flat stream
        for stage in ("pulse", "noise"):
            k = to_device(stage_key(hk, stage), self.dev)
            whole = flat_normal_field(k, 0, npol * L).reshape(npol, L)
            for n in (1, 2):
                S = L // n
                got = torch.cat([flat_spans(k, [p * L + s * S
                                                for p in range(npol)], S)
                                 for s in range(n)], dim=-1)
                if not torch.equal(got, whole):
                    raise AssertionError(f"baseband {stage} draws at n={n} "
                                         "differ from baseband_pipeline's")
            del whole, got
        sdev = torch.as_tensor(sp, device=self.dev)
        meshes = {1: (make_seq_mesh(devices=[self.dev]), None),
                  2: (make_seq_mesh(devices=[self.dev] * 2), BASEBAND_HALO)}
        outs, times = {}, {}
        for n, (m, halo) in meshes.items():
            run = seq_sharded_baseband(cfg, dm, mesh=m, halo=halo)
            run(hk, nn, sdev)
            self._zero_counts()
            outs[n], times[n] = self._timed(lambda: run(hk, nn, sdev))
            # per shard and stage one flat launch per polarization: the two
            # spans p*nsamp + t0 lie at different tile phases
            self._expect(f"20c seq_baseband n={n}",
                         {"rng_flat_field": 2 * npol * n})
        o1 = outs[1]
        std = float(o1.double().std())
        e = (outs[2] - o1).double()
        log(f"  (c) seq_sharded_baseband at {npol} x {L}: n=1 (the full "
            f"circular filter) {times[1] * 1e3:.2f} ms, n=2 (halo "
            f"{BASEBAND_HALO}) {times[2] * 1e3:.2f} ms; truncation error of "
            f"n=2 against n=1: max {float(e.abs().max()) / std:.3g}, rms "
            f"{float(e.std()) / std:.3g} of the std ({self.card_line})")
        del e
        x = torch.randn((npol, L), generator=torch.Generator(
            device=self.dev).manual_seed(5), device=self.dev)
        d = {}
        for n, (m, halo) in meshes.items():
            run = seq_sharded_dedisperse(cfg, dm, mesh=m, halo=halo)
            run(x)
            d[n], t = self._timed(lambda: run(x))
            log(f"  (c) seq_sharded_dedisperse n={n}: {t * 1e3:.2f} ms")
        if not torch.equal(d[1], coherent_dedisperse(
                x, dm, cfg.fcent_mhz, cfg.bw_mhz, cfg.dt_us)):
            raise AssertionError("seq_sharded_dedisperse n=1 is not the "
                                 "full circular filter")
        e = (d[2] - d[1]).double()
        std = float(d[1].double().std())
        log(f"  (c) dedisperse truncation error of n=2 against n=1: max "
            f"{float(e.abs().max()) / std:.3g}, rms {float(e.std()) / std:.3g}"
            " of the std")
        del d, e, x
        # the card against the host: the same sharded call at n=2 on the
        # kernel's stream (its plain version on the host)
        os.environ["PSS_SAMPLER"] = "hw"
        try:
            run = seq_sharded_baseband(cfg, dm, mesh=make_seq_mesh(
                devices=["cpu"] * 2), halo=BASEBAND_HALO)
            host, t_host = self._timed(lambda: run(hk, nn, sp))
        finally:
            os.environ.pop("PSS_SAMPLER", None)
        card = outs[2].cpu().numpy()
        host = host.numpy()
        peak_v = np.abs(host).max()
        err = np.abs(card - host)
        bad = err > 1e-5 * np.abs(host) + 1e-5 * peak_v
        log(f"  (c) n=2 card against host ({t_host:.1f} s on the host): "
            f"max|diff| {err.max():.3g} ({err.max() / peak_v:.3g} of the "
            f"peak), {int(bad.sum())} beyond rtol 1e-5 + 1e-5 of the peak; "
            f"bit-equal {np.mean(card == host):.4f}")
        if bad.any():
            raise AssertionError("seq_sharded_baseband: the card differs "
                                 "from the host")
        del outs, o1, card, host

    def _mesh_fold(self):
        """(d) FoldEnsemble at config 1 over meshes of cuda:0."""
        torch = self.torch
        import hashlib
        import shutil
        import tempfile

        from psrsigsim_torch.io import export_ensemble_psrfits
        from psrsigsim_torch.parallel import make_mesh

        base = self.main_ensemble()
        want, t_base = self._timed(lambda: base.run_quantized(MAIN_NOBS))
        want, t_base = self._timed(lambda: base.run_quantized(MAIN_NOBS))
        wantf = base.run(FLOAT_NOBS)
        log(f"  (d) mesh-free run_quantized({MAIN_NOBS}): "
            f"{t_base * 1e3:.2f} ms = {MAIN_NOBS / t_base:.1f} obs/s")
        for shape in FOLD_MESHES:
            k = shape[0] * shape[1]
            ens = geometry(MAIN, self.dev, mesh=make_mesh(
                shape, [self.dev] * k))
            self._zero_counts()
            got = ens.run_quantized(MAIN_NOBS)
            self._sync()
            self._expect(f"20d run_quantized({MAIN_NOBS}) {shape}",
                         {"fold_quantize": k})
            for name, a, b in zip(("codes", "DAT_SCL", "DAT_OFFS"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{shape}: {name} differ from the "
                                         "mesh-free run")
            _, t = self._timed(lambda: ens.run_quantized(MAIN_NOBS))
            self._zero_counts()
            gotf = ens.run(FLOAT_NOBS)
            self._sync()
            self._expect(f"20d run({FLOAT_NOBS}) {shape}",
                         {"rng_field": 2 * k})
            if not torch.equal(gotf, wantf):
                raise AssertionError(f"{shape}: run({FLOAT_NOBS}) differs")
            log(f"  (d) {shape}: run_quantized({MAIN_NOBS}) bit-equal, fused "
                f"kernel {k} launches, {t * 1e3:.2f} ms = "
                f"{MAIN_NOBS / t:.1f} obs/s; run({FLOAT_NOBS}) bit-equal")
            del got, gotf, ens
        del want, wantf
        # the export of EXPORT_NOBS observations, one writer: mesh-free and
        # on (2, 2), file for file
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        work = tempfile.mkdtemp(prefix="mesh-export-", dir=build)
        meshed = geometry(MAIN, self.dev, mesh=make_mesh((2, 2),
                                                         [self.dev] * 4))
        try:
            shas, rates = [], {}
            # in turns, mesh-free then (2, 2), twice
            for k, (label, ens) in enumerate((("mesh-free", base),
                                              ("(2, 2)", meshed)) * 2):
                out = os.path.join(work, str(k))
                self._zero_counts()
                _, t = self._timed(lambda: export_ensemble_psrfits(
                    ens, EXPORT_NOBS, out, TEMPLATE, ens.pulsar, seed=0,
                    chunk_size=MAIN_NOBS, writers=1))
                self._expect(f"20d export({EXPORT_NOBS}) {label}",
                             {"fold_quantize": (EXPORT_NOBS // MAIN_NOBS)
                              * ens.mesh.size})
                h = {}
                for name in sorted(os.listdir(out)):
                    if name.endswith(".fits"):
                        with open(os.path.join(out, name), "rb") as fh:
                            h[name] = hashlib.sha256(fh.read()).hexdigest()
                shas.append(h)
                rates.setdefault(label, []).append(EXPORT_NOBS / t)
                shutil.rmtree(out)
            log(f"  (d) export({EXPORT_NOBS}), writers=1, in turns: "
                + "; ".join(f"{label} {', '.join(f'{r:.1f}' for r in v)} "
                            "obs/s" for label, v in rates.items()))
            if any(h != shas[0] for h in shas) or \
                    len(shas[0]) != EXPORT_NOBS:
                raise AssertionError("the (2, 2) export's files differ from "
                                     "the mesh-free export's")
            log(f"  (d) the (2, 2) export's {EXPORT_NOBS} files are "
                "byte-identical to the mesh-free export's")
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def _mesh_users(self):
        """(e) the study on (4, 1), the 128-pulsar ensemble on (2, 2), a
        corpus on (2, 1)."""
        torch = self.torch
        import hashlib
        import shutil
        import tempfile

        import numpy as np

        from psrsigsim_torch.datasets import DatasetFactory
        from psrsigsim_torch.mc import MonteCarloStudy
        from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble, make_mesh
        from psrsigsim_torch.simulate import Simulation

        sim = Simulation(psrdict=MC_BENCH, device=self.dev)
        m41 = make_mesh((4, 1), [self.dev] * 4)
        res = {}
        for label, kw in (("mesh-free", {}), ("(4, 1)", {"mesh": m41})):
            study = MonteCarloStudy.from_simulation(sim, MC_PRIORS, seed=1,
                                                    **kw)
            study.run(MESH_MC_TRIALS, chunk_size=MC_CHUNK)
            self._zero_counts()
            res[label], t = self._timed(lambda: study.run(
                MESH_MC_TRIALS, chunk_size=MC_CHUNK))
            shards = 1 if not kw else 4
            self._expect(f"20e study({MESH_MC_TRIALS}) {label}",
                         {"rng_field": 2 * shards * (MESH_MC_TRIALS
                                                     // MC_CHUNK)})
            log(f"  (e) study {label} (a second run): {MESH_MC_TRIALS} "
                f"trials in {t:.3f} s = {MESH_MC_TRIALS / t:.1f} trials/s")
        if not (np.array_equal(res["(4, 1)"].metrics,
                               res["mesh-free"].metrics)
                and np.array_equal(res["(4, 1)"].hist,
                                   res["mesh-free"].hist)):
            raise AssertionError("the (4, 1) study's rows differ")
        log("  (e) the (4, 1) study's rows and histograms are bit-identical")

        work = config5()
        plain = MultiPulsarFoldEnsemble(work, epoch_chunk=MULTI_EPOCH_CHUNK,
                                        device=self.dev)
        plain.run(MULTI_EPOCH_CHUNK)
        want, t_plain = self._timed(lambda: plain.run(MULTI_EPOCH_CHUNK))
        ens = MultiPulsarFoldEnsemble(work, epoch_chunk=MULTI_EPOCH_CHUNK,
                                      mesh=make_mesh((2, 2), [self.dev] * 4))
        ens.run(MULTI_EPOCH_CHUNK)
        self._zero_counts()
        got, t = self._timed(lambda: ens.run(MULTI_EPOCH_CHUNK))
        self._expect(f"20e multipulsar({MULTI_EPOCH_CHUNK}) (2, 2)",
                     {"rng_field": 2 * 4 * ens.n_buckets})
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the (2, 2) multi-pulsar run differs")
        pe = len(work) * MULTI_EPOCH_CHUNK
        log(f"  (e) multi-pulsar, {len(work)} pulsars x {MULTI_EPOCH_CHUNK} "
            f"epochs on (2, 2): bit-equal, {t * 1e3:.1f} ms = "
            f"{pe / t:.1f} pulsar-epochs/s (mesh-free {t_plain * 1e3:.1f} ms "
            f"= {pe / t_plain:.1f}; second runs)")
        del got, want, ens, plain

        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        out = tempfile.mkdtemp(prefix="mesh-dataset-", dir=build)
        try:
            shas = {}
            for label, kw in (("mesh-free", {"device": self.dev}),
                              ("(2, 1)", {"mesh": make_mesh(
                                  (2, 1), [self.dev] * 2)})):
                path = os.path.join(out, label.strip("()").replace(", ", "x"))
                fac = DatasetFactory(MESH_DATASET_SPEC, **kw)
                fac.run(path + "-warm", chunk_size=64)
                _, t = self._timed(lambda: fac.run(path, chunk_size=64))
                h = hashlib.sha256()
                for name in sorted(os.listdir(path)):
                    if name.startswith("shard-"):
                        with open(os.path.join(path, name), "rb") as fh:
                            h.update(name.encode() + fh.read())
                shas[label] = h.hexdigest()
                log(f"  (e) corpus {label} (a second run): "
                    f"{MESH_DATASET_SPEC['n_records']} records in {t:.3f} s")
            if shas["(2, 1)"] != shas["mesh-free"]:
                raise AssertionError("the (2, 1) corpus differs")
            log("  (e) the (2, 1) corpus is byte-identical")
        finally:
            shutil.rmtree(out, ignore_errors=True)

    def _mesh_exact(self):
        """(e) (a) under PSS_EXACT_CHI2=1 at n = 1 and 2: the exact-gamma
        kernel draws every field."""
        torch = self.torch

        from psrsigsim_torch.parallel import make_seq_mesh, seq_sharded_search
        from psrsigsim_torch.simulate import single_pipeline

        cfg, pdev, nn, hk = self._seq_inputs()
        dm = CONFIG4["dm"]
        os.environ["PSS_EXACT_CHI2"] = "1"
        try:
            ref = single_pipeline(hk, torch.tensor(dm),
                                  torch.tensor(nn, dtype=torch.float32),
                                  pdev, cfg)
            for n in (1, 2):
                run = seq_sharded_search(cfg, make_seq_mesh(
                    devices=[self.dev] * n))
                run(hk, dm, nn, pdev)   # warm: time the second call
                self._zero_counts()
                out, t = self._timed(lambda: run(hk, dm, nn, pdev))
                # per shard: pulse, noise and the replacement row
                counts = self._expect(f"20e exact seq_search n={n}",
                                      {"gamma_field": 3 * n})
                equal = bool(torch.equal(out, ref))
                log(f"  (e) PSS_EXACT_CHI2=1 n={n}: {t * 1e3:.2f} ms, "
                    f"launches {counts}, bit-equal to single_pipeline "
                    f"{equal}")
                if not equal:
                    raise AssertionError(f"exact seq_search n={n} differs")
        finally:
            os.environ.pop("PSS_EXACT_CHI2", None)

    def _mesh_guard(self):
        """(f) a 4-channel chan shard raises the 8-channel-group rule."""
        from psrsigsim_torch.parallel import make_mesh

        try:
            geometry(MAIN, self.dev, mesh=make_mesh((1, 16), [self.dev] * 16))
        except ValueError as err:
            if "8-channel group" not in str(err):
                raise
            log(f"  (f) a (1, 16) mesh (4 channels a shard) raises: {err}")
            return
        raise AssertionError("a (1, 16) mesh on the kernel path did not raise")

    # -- 21 -----------------------------------------------------------------
    def pods(self):
        """Pods on the one card (see the module docstring)."""
        import shutil
        import tempfile

        for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
                  "PSS_INTEGRITY", "PSS_POD_FETCH"):
            os.environ.pop(k, None)
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        libs = sorted(n for n in os.listdir(build) if n.endswith(".so"))
        work = tempfile.mkdtemp(prefix="pods-", dir=build)
        t0 = time.perf_counter()
        try:
            self._pod_identity(work)
            self._pod_export(work)
            self._pod_serve(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        now = sorted(n for n in os.listdir(build) if n.endswith(".so"))
        if now != libs:
            raise AssertionError(f"a pod process built a kernel: "
                                 f"{sorted(set(now) - set(libs))}")
        log(f"  no pod process built a kernel ({len(libs)} libraries in "
            f"build/ before and after); phase 21 steps done in "
            f"{time.perf_counter() - t0:.1f} s ({self.card_line})")

    @staticmethod
    def _pod_runner():
        """The pod driver, loaded from its file under a name of its own
        (a top-level ``pod_runner`` may be another module)."""
        import importlib.util

        name = "psrsigsim_torch_pod_runner"
        mod = sys.modules.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(ROOT, "psrsigsim_torch", "tools",
                                   "pod_runner.py"))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        return mod

    def _pod_expect(self, label, got, want):
        """One rank's launches (a pod_runner leg's counts) must be
        ``want`` (the kernels it omits: none); recorded under ``label``."""
        full = {k: want.get(k, 0) for k in got}
        if got != full:
            raise AssertionError(f"{label}: launches {got}, expected {full}")
        self._path(label, {k: v for k, v in got.items() if v})

    def _pod_identity(self, work):
        """(a) and (d): the ensemble, the study and a corpus on the pod,
        against one-process runs in this process."""
        torch = self.torch
        import hashlib

        import numpy as np

        from psrsigsim_torch.datasets import DatasetFactory
        from psrsigsim_torch.mc import MonteCarloStudy
        from psrsigsim_torch.ops import fold_quantize as fq
        from psrsigsim_torch.ops import rng_hw
        from psrsigsim_torch.parallel import make_mesh
        from psrsigsim_torch.simulate import Simulation
        from psrsigsim_torch.utils import key, stage_key

        pr = self._pod_runner()
        sim = Simulation(psrdict=main_psrdict(), device=self.dev)
        sim.init_all()
        want = {}
        for label, mesh in (("mesh-free", None),
                            ("(2, 1)", make_mesh((2, 1), [self.dev] * 2))):
            ens = sim.to_ensemble(mesh=mesh)
            d, s_, o = (t.cpu().numpy()
                        for t in ens.run_quantized(MAIN_NOBS, seed=pr.SEED))
            f = ens.run(FLOAT_NOBS, seed=pr.SEED).cpu().numpy()
            want[label] = {"ensemble_quantized": pr.sha(d, s_, o),
                           "ensemble_float": pr.sha(f)}
            del ens, d, s_, o, f
        if want["mesh-free"] != want["(2, 1)"]:
            raise AssertionError("the one-process (2, 1) mesh differs from "
                                 "the mesh-free run")
        msim = Simulation(psrdict=dict(pr.MC_BENCH), device=self.dev)
        msim.init_all()
        res = MonteCarloStudy.from_simulation(
            msim, pr.MC_BENCH_PRIORS, seed=pr.SEED).run(
                MC_TRIALS, chunk_size=MC_CHUNK, out_dir=None)
        want_mc = {"mc_metrics": pr.sha(res.metrics),
                   "mc_hist": pr.sha(res.hist)}
        corpus = os.path.join(work, "corpus-solo")
        DatasetFactory(dict(pr.DATASET_BENCH), device=self.dev).run(
            corpus, chunk_size=64, resume=False)
        h = hashlib.sha256()
        for name in sorted(os.listdir(corpus)):
            if name.startswith("shard-") and name.endswith(".records"):
                with open(os.path.join(corpus, name), "rb") as fh:
                    h.update(fh.read())
        want_corpus = h.hexdigest()

        # the pod: two ranks on cuda:0, one mesh position each
        cmd = [sys.executable, os.path.join(ROOT, "psrsigsim_torch", "tools",
                                            "pod_runner.py"),
               "--mode", "identity", "--hosts", str(POD_PROCS),
               "--families", "ensemble,mc,dataset", "--device", "cuda",
               "--geometry", "config1", "--total-devices", str(POD_PROCS),
               "--ens-obs", str(MAIN_NOBS), "--ens-float", str(FLOAT_NOBS),
               "--ens-chunk", "0", "--warm", "--mc-geometry", "bench",
               "--mc-trials", str(MC_TRIALS), "--mc-chunk", str(MC_CHUNK),
               "--dataset-out", os.path.join(work, "corpus-pod"),
               "--threads", str(POD_THREADS), "--timeout", str(POD_TIMEOUT_S)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=POD_TIMEOUT_S + 60)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the pod failed (rc {proc.returncode}): "
                                 f"{proc.stderr[-3000:]}")
        verdict = json.loads(proc.stdout.strip().splitlines()[-1])
        if not verdict["ok"] or verdict["mismatches"]:
            raise AssertionError(f"the pod's ranks disagree: "
                                 f"{verdict['mismatches']}")
        ranks = verdict["workers"][str(POD_PROCS)]
        expect = dict(want["mesh-free"], **want_mc,
                      dataset_corpus=want_corpus)
        for w in ranks:
            r = w["process_id"]
            # every rank holds the whole result: each rank's own hashes
            for k, v in expect.items():
                if w["hashes"].get(k) != v:
                    raise AssertionError(f"pod rank {r}'s {k} differs from "
                                         "the one-process run")
            per = MC_TRIALS // MC_CHUNK
            for leg, counts in (("run_quantized", {"fold_quantize": 1}),
                                ("run", {"rng_field": 2}),
                                ("mc", {"rng_field": 2 * per}),
                                ("dataset", {"rng_flat_field": 2 * (
                                    pr.DATASET_BENCH["n_records"] // 64)})):
                self._pod_expect(f"21 {leg} pod rank {r}",
                                 w["launches"][leg], counts)
        lead = ranks[0]
        ex = lead["exchange"]["run_quantized"]
        t_rq = lead["timings"]["run_quantized"]
        log(f"  (a) pod of {POD_PROCS} ranks on cuda:0 in {wall:.1f} s: "
            f"run_quantized({MAIN_NOBS}) and run({FLOAT_NOBS}) on every rank "
            "bit-equal to the one-process (2, 1) mesh and the mesh-free run; "
            "fused kernel "
            "1 launch a rank, sampler 2 a rank in run; run_quantized "
            f"{t_rq * 1e3:.1f} ms = {MAIN_NOBS / t_rq:.1f} obs/s, of which "
            f"the channel exchange {ex['seconds'] * 1e3:.1f} ms, "
            f"{ex['bytes_sent']} bytes sent and {ex['bytes_received']} "
            f"received a chunk (rank 0); run({FLOAT_NOBS}) "
            f"{lead['timings']['run'] * 1e3:.1f} ms, exchange "
            f"{lead['exchange']['run']['seconds'] * 1e3:.1f} ms "
            f"({self.card_line})")
        log(f"  (d) the bench study ({MC_TRIALS} trials, chunks of "
            f"{MC_CHUNK}: {lead['timings']['mc']:.2f} s) and a "
            f"{pr.DATASET_BENCH['n_records']}-record corpus "
            f"({lead['timings']['dataset']:.2f} s) on the pod bit-identical "
            "to their one-process runs on every rank")

        # each kernel against its plain version at a rank's shapes
        a, kw, _ = self.main_fused_args(nobs=MAIN_NOBS // POD_PROCS)
        g = fq.fold_quantize(**a, **kw)
        w_ = fq.fold_quantize_plain(**a, **kw)
        if not (torch.equal(g[0], w_[0]) and torch.equal(g[1], w_[1])):
            raise AssertionError("fused kernel differs from its plain version "
                                 "at a rank's shape")
        nobs = FLOAT_NOBS // POD_PROCS
        obs = stage_key(key(pr.SEED, self.dev), "user",
                        torch.arange(nobs, device=self.dev))
        nsamp = sim.to_ensemble().cfg.nsamp
        worst = 0.0
        for stage in ("pulse", "noise"):
            k = stage_key(obs, stage)
            gr = rng_hw.hw_chan_field(k, 0, 12000.0, 0, mode="chi2_wh",
                                      nchan=MAIN["nchan"], length=nsamp)
            wr = rng_hw.rng_field_plain(
                rng_hw.seed_words(k),
                torch.full((nobs,), 12000.0, device=self.dev),
                torch.zeros((nobs, 2), dtype=torch.int32, device=self.dev),
                "chi2_wh", MAIN["nchan"], nsamp)
            err, ok = ulp_close(gr, wr)
            if not ok:
                raise AssertionError("sampler differs from its plain version "
                                     "at a rank's shape")
            worst = max(worst, err)
        log(f"  (a) at a rank's shapes: fused kernel {tuple(g[0].shape)} "
            f"bit-equal to its plain version; sampler {tuple(gr.shape)} "
            f"max|kernel-plain| {worst:.3g}")
        del g, w_, gr, wr
        if not np.isfinite(res.metrics).all():
            raise AssertionError("the study's metrics are not finite")

    def _pod_export(self, work):
        """(b): the export program group, a follower's death, the resume.

        At depth 0 each chunk's exchange happens when it is dispatched, one
        chunk ahead of the loop's consumer: the exchange of chunk k+2
        follows the leader's commit of chunk k, so a follower SIGKILLed
        after its loop passed chunk 1 leaves chunk 0 committed (chunk 1
        too if the leader's writes beat its watchdog) and the leader short
        of chunk 3's exchange."""
        import hashlib

        from psrsigsim_torch.runtime import supervised_export

        pr = self._pod_runner()

        def hashes(out):
            res = {}
            for n in sorted(os.listdir(out)):
                if n.endswith(".fits"):
                    with open(os.path.join(out, n), "rb") as fh:
                        res[n] = hashlib.sha256(fh.read()).hexdigest()
            return res

        if self.sup_clean is not None:
            want = self.sup_clean[0]
            origin = "phase 9's clean export"
        else:   # phase 21 alone: the same export in this process
            ref = os.path.join(work, "export-solo")
            ens = geometry(MAIN, self.dev)
            supervised_export(ens, SUP_NOBS, ref, TEMPLATE, ens.pulsar,
                              seed=0, chunk_size=MAIN_NOBS, writers=1)
            want = hashes(ref)
            origin = "a one-process export"
        out = os.path.join(work, "export-pod")
        plan = os.path.join(work, "podkill.json")
        with open(plan, "w") as fh:
            json.dump({"scratch_dir": os.path.join(work, "podkill"),
                       "spec": {"pod.kill": {"after_chunks": 2}}}, fh)
        common = dict(timeout=POD_TIMEOUT_S, device="cuda",
                      geometry="config1", devices_per_host=1, seed=0,
                      threads=POD_THREADS)
        ends = []
        t0 = time.perf_counter()
        (lrc, _, lerr), (frc, _, ferr) = pr.spawn_export_group(
            out, POD_PROCS, SUP_NOBS, POD_EXPORT_CHUNK, follower_plan=plan,
            pipeline_depth=0, ends=ends, **common)
        t_kill = time.perf_counter() - t0
        if frc not in (-9, 137):
            raise AssertionError(f"the follower was not SIGKILLed (rc {frc}): "
                                 f"{ferr[-2000:]}")
        if lrc != 73:
            raise AssertionError(f"the leader did not exit 73 (rc {lrc}): "
                                 f"{lerr[-2000:]}")
        gap = ends[0] - ends[1]
        if gap > POD_KILL_BOUND_S:
            raise AssertionError(f"the leader took {gap:.1f} s to notice its "
                                 "follower's death")
        partial = hashes(out)
        with open(os.path.join(out, "run_journal.jsonl")) as fh:
            committed = [json.loads(line)["ident"] for line in fh
                         if json.loads(line)["e"] == "commit"]
        if committed not in ([0], [0, POD_EXPORT_CHUNK]) \
                or not POD_EXPORT_CHUNK <= len(partial) < SUP_NOBS \
                or any(want[n] != v for n, v in partial.items()):
            raise AssertionError(f"after the kill: commits {committed}, "
                                 f"{len(partial)} files (or one differs "
                                 "from the one-process export)")
        ends = []
        t0 = time.perf_counter()
        res = pr.spawn_export_group(out, POD_PROCS, SUP_NOBS,
                                    POD_EXPORT_CHUNK, pipeline_depth=2,
                                    ends=ends, **common)
        t_res = time.perf_counter() - t0
        missing = SUP_NOBS // POD_EXPORT_CHUNK - len(committed)
        for r, (rc, o, e) in enumerate(res):
            if rc != 0:
                raise AssertionError(f"resume rank {r} rc {rc}: {e[-2000:]}")
            self._pod_expect(f"21 export resume pod rank {r}",
                             json.loads(o.strip().splitlines()[-1])[
                                 "launches"], {"fold_quantize": missing})
        if hashes(out) != want:
            raise AssertionError("the resumed pod export differs from the "
                                 "one-process export")
        log(f"  (b) export group of {SUP_NOBS} in chunks of "
            f"{POD_EXPORT_CHUNK}: pod.kill after the follower's second "
            f"chunk, the follower SIGKILLed, the leader exited 73 "
            f"{gap:.2f} s later (group {t_kill:.1f} s; chunks {committed} "
            f"committed, {len(partial)} files on disk, each {origin}'s); "
            f"the resume (verify) {t_res:.1f} s, the "
            f"fused kernel {missing} times a rank (the missing chunks "
            f"only), all {SUP_NOBS} files byte-identical to {origin} "
            f"({self.card_line})")

    def _pod_serve(self, work):
        """(c): a serving replica that is a 2-process pod group."""
        import signal
        import urllib.request
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        from psrsigsim_torch.serve import (FleetRouter, ReplicaFleet,
                                           SimulationService)

        specs = {i: serve_spec(i) for i in POD_SERVE}
        svc = SimulationService(widths=SERVE_WIDTHS, device=self.dev,
                                max_queue=len(specs))
        try:
            svc.warmup(SERVE_SPEC)
            ids = {i: svc.submit(sp)[0] for i, sp in specs.items()}
            want = {i: svc.result(rid, timeout=600).tobytes()
                    for i, rid in ids.items()}
        finally:
            svc.close()
        warm = os.path.join(work, "warm.json")
        with open(warm, "w") as fh:
            json.dump(SERVE_SPEC, fh)

        def drive(router):
            def one(i):
                t0 = time.perf_counter()
                status, resp = router.submit(specs[i], deadline_s=300.0,
                                             wait=True)
                if status != 200 or resp.get("status") != "done":
                    raise AssertionError(f"request {i}: HTTP {status} "
                                         f"{str(resp)[:300]}")
                if np.asarray(resp["profile"], np.float32).tobytes() \
                        != want[i]:
                    raise AssertionError(f"request {i} differs from the "
                                         "in-process service")
                return time.perf_counter() - t0

            t0 = time.perf_counter()
            with ThreadPoolExecutor(POD_SERVE_CLIENTS) as pool:
                lats = list(pool.map(one, sorted(specs)))
            return time.perf_counter() - t0, np.asarray(lats)

        def health(fleet):
            (_, url), = fleet.endpoints()
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                return json.loads(r.read())

        fleet = ReplicaFleet(1, os.path.join(work, "serve-cache"),
                             widths=SERVE_WIDTHS, warmup_path=warm,
                             quorum=1, group_hosts=POD_PROCS,
                             log_dir=os.path.join(work, "serve-logs"))
        t0 = time.perf_counter()
        fleet.start()
        try:
            if fleet.healthy_count() != 1:
                raise AssertionError(f"the pod group did not come up: "
                                     f"{fleet.health()}")
            t_up = time.perf_counter() - t0
            router = FleetRouter(fleet, **FLEET_ROUTER)
            try:
                # the warm-up's own launches (one a width) come before
                h0 = health(fleet)
                wall, lats = drive(router)
                h = health(fleet)
                if h["pod"] != {"process_id": 0, "num_processes": POD_PROCS,
                                "is_pod": True}:
                    raise AssertionError(f"/healthz pod block {h['pod']}")
                execs = h["device_calls"] - h0["device_calls"]
                launches = {k: v - h0["kernel_launches"][k]
                            for k, v in h["kernel_launches"].items()}
                if launches != {"rng_field": 2 * execs, "rng_flat_field": 0,
                                "fold_quantize": 0, "packed_digest": 0}:
                    raise AssertionError(f"the leader's launches {launches} "
                                         f"for {execs} bucket executions")
                self._path("21 serve pod leader", {"rng_field":
                                                   launches["rng_field"]})
                leader = fleet._sups[0].proc
                follower = fleet._group_procs[0][0]
                t_kill = time.perf_counter()
                os.kill(follower.pid, signal.SIGKILL)
                deadline = time.monotonic() + POD_KILL_BOUND_S
                while leader.poll() is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                if leader.poll() != 73:
                    raise AssertionError(f"the leader's exit {leader.poll()} "
                                         "after its follower's death")
                t_dead = time.perf_counter() - t_kill
                deadline = time.monotonic() + 240
                while time.monotonic() < deadline and not (
                        fleet._sups[0].alive() and fleet.endpoints()
                        and fleet._sups[0].proc is not leader):
                    time.sleep(0.1)
                if fleet._sups[0].proc is leader or not fleet.endpoints():
                    raise AssertionError("the pod group never restarted")
                t_back = time.perf_counter() - t_kill
                wall2, _ = drive(router)
                h2 = health(fleet)
                if h2["device_calls"] != 0:
                    raise AssertionError(f"the restarted group ran "
                                         f"{h2['device_calls']} batches: a "
                                         "commit was lost")
            finally:
                router.close()
        finally:
            fleet.drain()
        log(f"  (c) pod group (leader + 1 follower on cuda:0) up in "
            f"{t_up:.1f} s; {len(specs)} requests from {POD_SERVE_CLIENTS} "
            f"clients bit-equal to the in-process service in {wall:.2f} s = "
            f"{len(specs) / wall:.2f} req/s, p50 "
            f"{np.percentile(lats, 50) * 1e3:.1f} ms, p99 "
            f"{np.percentile(lats, 99) * 1e3:.1f} ms; {execs} bucket "
            f"executions, the leader's sampler {launches['rng_field']} "
            f"launches; follower SIGKILL: the leader exited 73 after "
            f"{t_dead:.2f} s, the group served again {t_back:.1f} s after "
            f"the kill, all {len(specs)} requests from the cache in "
            f"{wall2:.2f} s, bit-equal, no batch run ({self.card_line})")

    # -- 22 -----------------------------------------------------------------
    def linter(self):
        """The port's linter on its own tree, and its device probe on the
        card under sync-debug "error" (see the module docstring)."""
        from psrsigsim_torch import ops
        from psrsigsim_torch.analysis import trace_check

        for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
                  "PSS_INTEGRITY"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        lint = subprocess.run(
            [sys.executable, "-m", "psrsigsim_torch.analysis"], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        tail = (lint.stdout.strip().splitlines() or [""])[-1]
        if lint.returncode != 0:
            raise AssertionError(f"python -m psrsigsim_torch.analysis exited "
                                 f"{lint.returncode}:\n{lint.stdout[-3000:]}"
                                 f"{lint.stderr[-3000:]}")
        log(f"  python -m psrsigsim_torch.analysis: exit 0, {tail!r} "
            f"({time.perf_counter() - t0:.1f} s)")
        self._zero_counts()
        t1 = time.perf_counter()
        results = trace_check.run_trace_check(device="cuda")
        if [r.name for r in results] != list(ops.__all__):
            raise AssertionError("the probe did not cover ops.__all__")
        results += trace_check.run_serve_trace_check(widths=(1, 8),
                                                     device="cuda")
        results += trace_check.run_dataset_trace_check(device="cuda")
        # the main path's own steady call at config 1's full width
        results += trace_check.run_ensemble_trace_check(self.main_ensemble(),
                                                        MAIN_NOBS)
        self._sync()
        counts = self._counts()
        if self.torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError("the probe left the sync-debug mode on")
        for name in ("rng_field", "rng_flat_field", "fold_quantize",
                     "packed_digest"):
            if not counts.get(name):
                raise AssertionError(f"the probe never launched {name}: "
                                     f"{counts}")
        self._path("22 probe", counts)
        by = {s: [r.name for r in results if r.status == s]
              for s in ("ok", "sync", "exempt")}
        log(f"  probe on the card: {len(results)} probes "
            f"({len(ops.__all__)} ops symbols, 2 serve buckets, 1 dataset "
            f"chunk, run_quantized({MAIN_NOBS}) at config 1): {len(by['ok'])} clean under sync-debug 'error', "
            f"{len(by['sync'])} syncing by design ({', '.join(by['sync'])}), "
            f"{len(by['exempt'])} exempt; launches {counts} "
            f"({time.perf_counter() - t1:.1f} s)")
        log(f"  phase 22 done in {time.perf_counter() - t0:.1f} s "
            f"({self.card_line})")

    # -- 23 -----------------------------------------------------------------
    def tutorials(self):
        """Every tutorial of docs/torch/ on the card (see the module
        docstring), through the CPU test's runner
        (psrsigsim_torch/tools/tutorials.py) with DEVICE = "cuda", from a
        scratch directory under build/."""
        import glob
        import shutil
        import tempfile

        from psrsigsim_torch.tools.tutorials import number, run_tutorial

        for k in ("PSS_SAMPLER", "PSS_EXACT_SHIFT", "PSS_EXACT_CHI2",
                  "PSS_INTEGRITY"):
            os.environ.pop(k, None)
        paths = sorted(glob.glob(os.path.join(ROOT, "docs", "torch",
                                              "tutorial_*.md")), key=number)
        if len(paths) != 12:
            raise AssertionError(f"{len(paths)} tutorials in docs/torch/")
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        t0 = time.perf_counter()
        for path in paths:
            name = os.path.basename(path)
            work = tempfile.mkdtemp(prefix="tutorial-", dir=build)
            self._zero_counts()
            t1 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    n_blocks = run_tutorial(path, "cuda", work)
                self._sync()
            finally:
                shutil.rmtree(work, ignore_errors=True)
            seconds = time.perf_counter() - t1
            counts = self._counts()
            self._path(f"23 tutorial {number(path)}", counts)
            log(f"  {name}: {n_blocks} blocks in {seconds:.2f} s; K1' "
                f"rows {counts['rng_field']}, K1' flat "
                f"{counts.get('rng_flat_field', 0)}, K3' "
                f"{counts['fold_quantize']}, K4 {counts['packed_digest']}, "
                f"K9 {counts.get('gamma_field', 0)}")
        log(f"  phase 23: {len(paths)} tutorials on cuda in "
            f"{time.perf_counter() - t0:.1f} s ({self.card_line})")

    def run(self, with_profile=False):
        self.phase("1 card", self.card)
        built = self.phase("2 build", self.build)
        if built:
            self.phase("3 rng_field vs plain", self.kernel_vs_plain)
            self.phase("3b fold_quantize vs plain and unfused",
                       self.fused_vs_plain)
            self.phase("3c packed_digest vs plain", self.digest_vs_plain)
            self.phase("4 statistics", self.statistics)
            self.phase("5 main paths", self.main_path)
            if with_profile:
                self.phase("5b profile", self.profile)
        self.phase("6 threefry parity", self.parity)
        if built and not self.failed:
            self.phase("7 kernel timing", self.measure)
        if built:
            self.phase("8 export", self.export)
            self.phase("9 supervised export", self.supervised)
            self.phase("10 object-oriented flow and Simulation", self.oo_flow)
            self.phase("11 Monte-Carlo study", self.mc_study)
            self.phase("12 scenario engine", self.scenarios)
            self.phase("13 SEARCH mode", self.search)
            self.phase("14 dataset factory", self.datasets)
            self.phase("15 baseband", self.baseband)
            self.phase("16 multi-pulsar ensemble", self.multipulsar)
            self.phase("17 serving", self.serving)
            self.phase("18 serving fleet", self.fleet)
            self.phase("19 exact-gamma chi2", self.exact_gamma)
            self.phase("20 meshes and sequence sharding", self.meshes)
            self.phase("21 pods", self.pods)
            self.phase("22 linter and probe on the card", self.linter)
            self.phase("23 tutorials on the card", self.tutorials)
        if self.failed:
            log(f"FAILED phases: {', '.join(self.failed)}")
            return 1
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        # the fused kernel's scenario launches and times ride beside its
        # scenario-free ones (phase 12), the sampler's baseband and
        # multi-pulsar ones beside its main path's (phases 15-16), and
        # every path's launches under launches_by_path; the sampler's
        # serving shape beside them (phase 17)
        extra = ("scenario_", "baseband_", "multipulsar_", "serve_",
                 "launches_by_path")
        print(json.dumps({"kernels": [
            {**{k: kern[k] for k in keys},
             **{k: v for k, v in kern.items() if k.startswith(extra)}}
            for kern in self.kernels.values()]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": self.torch.cuda.get_device_name(0),
            "count": self.torch.cuda.device_count()}}))
        return 0


def kill_child(out, scratch):
    """Phase 9's process that must die: the supervised export of the main
    path with ``run.kill`` armed after chunk 0's journal commit."""
    from psrsigsim_torch.runtime import FaultPlan, supervised_export

    ens = geometry(MAIN, "cuda")
    supervised_export(ens, SUP_NOBS, out, TEMPLATE, ens.pulsar, seed=0,
                      chunk_size=MAIN_NOBS, writers=1,
                      faults=FaultPlan(scratch, {"run.kill": {"after_start": 0}}))
    print("the export survived run.kill", file=sys.stderr)
    return 1


def dataset_kill_child(out, scratch):
    """Phase 14's process that must die: the dataset factory with
    ``dataset.kill`` armed after chunk 128's journal commit."""
    from psrsigsim_torch.datasets import DatasetFactory
    from psrsigsim_torch.runtime import FaultPlan

    DatasetFactory(DATASET_SPEC, device="cuda").run(
        out, chunk_size=DATASET_CHUNKS[0],
        faults=FaultPlan(scratch, {"dataset.kill": {"after_start": 128}}))
    print("the factory survived dataset.kill", file=sys.stderr)
    return 1


def config4():
    """BASELINE config 4's SEARCH geometry through the port's objects
    (bench.py build_single_workload): ``(cfg, profiles, noise_norm)``."""
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.simulate import build_single_config
    from psrsigsim_torch.utils import make_quant

    g = CONFIG4
    sig = FilterBankSignal(g["fcent"], g["bw"], Nsubband=g["nchan"],
                           sample_rate=g["samprate_mhz"], fold=False)
    psr = Pulsar(g["period_s"], g["smean"], GaussProfile(width=0.05),
                 name="BENCH", seed=0)
    sig._tobs = make_quant(g["tobs_s"], "s")
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="BenchScope")
    tel.add_system("BenchSys", Receiver(fcent=g["fcent"], bandwidth=g["bw"],
                                        name="R"),
                   Backend(samprate=12.5, name="B"))
    return build_single_config(sig, psr, tel, "BenchSys",
                               null_frac=g["null_frac"])


def config3():
    """BASELINE config 3's baseband geometry through the port's objects
    (bench.py build_baseband_workload, plus the bench telescope for the
    amplitude noise scale): ``(cfg, sqrt_profiles, noise_norm)``."""
    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.signal import BasebandSignal
    from psrsigsim_torch.simulate import build_baseband_config
    from psrsigsim_torch.utils import make_quant

    g = CONFIG3
    sig = BasebandSignal(g["fcent"], g["bw"], sample_rate=g["samprate_mhz"])
    psr = Pulsar(g["period_s"], g["smean"], GaussProfile(width=0.05),
                 name="BENCH", seed=0)
    sig._tobs = make_quant(g["tobs_s"], "s")
    tel = Telescope(100.0, area=5500.0, Tsys=35.0, name="BenchScope")
    tel.add_system("BenchSys", Receiver(fcent=g["fcent"], bandwidth=g["bw"],
                                        name="R"),
                   Backend(samprate=12.5, name="B"))
    return build_baseband_config(sig, psr, tel, "BenchSys", dm_max=g["dm"])


def config5():
    """BASELINE config 5's heterogeneous population through the port's
    objects (bench.py time_tpu_multipulsar: 128 distinct MSP periods of
    2.5-9.5 ms, portraits, fluxes and DMs from numpy seed 0, padded to the
    [1024, 2048, 4096] grid): one ``(cfg, profiles, noise_norm, dm)`` per
    pulsar."""
    import numpy as np

    from psrsigsim_torch.models.pulsar import GaussProfile, Pulsar
    from psrsigsim_torch.models.telescope import Backend, Receiver, Telescope
    from psrsigsim_torch.parallel import MultiPulsarFoldEnsemble
    from psrsigsim_torch.signal import FilterBankSignal
    from psrsigsim_torch.simulate import build_fold_config, natural_nbin
    from psrsigsim_torch.utils import make_quant

    tscope = Telescope(100.0, area=5500.0, Tsys=35.0, name="BenchScope")
    tscope.add_system("BenchSys", Receiver(fcent=1380, bandwidth=400,
                                           name="R"),
                      Backend(samprate=12.5, name="B"))
    rng = np.random.default_rng(0)
    workloads = []
    for i in range(MULTI_PULSARS):
        period = 0.0025 + 0.007 * rng.random()
        # the bench's signals sample below the band's Nyquist rate (a
        # filterbank's time resolution): keep the 128 warnings out of the log
        with contextlib.redirect_stdout(io.StringIO()):
            sig = FilterBankSignal(1380, 400, Nsubband=64,
                                   sample_rate=0.4096, sublen=0.5, fold=True)
        psr = Pulsar(period, 0.002 + 0.02 * rng.random(), GaussProfile(
            peak=0.25 + 0.5 * rng.random(), width=0.02 + 0.06 * rng.random()
        ), name=f"P{i}")
        sig._tobs = make_quant(1.0, "s")
        nbin = MultiPulsarFoldEnsemble.choose_nbin(natural_nbin(sig, psr),
                                                   MULTI_PAD)
        cfg, profiles, noise_norm = build_fold_config(
            sig, psr, tscope, "BenchSys", nbin=nbin)
        workloads.append((cfg, profiles, noise_norm,
                          5.0 + 60.0 * rng.random()))
    return workloads


def mc_kill_child(out, scratch):
    """Phase 11's process that must die: the bench MC study with ``mc.kill``
    armed after chunk 0's journal commit."""
    from psrsigsim_torch.mc import MonteCarloStudy
    from psrsigsim_torch.runtime import FaultPlan
    from psrsigsim_torch.simulate import Simulation

    study = MonteCarloStudy.from_simulation(
        Simulation(psrdict=MC_BENCH, device="cuda"), MC_PRIORS, seed=1)
    study.run(MC_TRIALS, chunk_size=MC_CHUNK, out_dir=out,
              faults=FaultPlan(scratch, {"mc.kill": {"after_start": 0}}))
    print("the study survived mc.kill", file=sys.stderr)
    return 1


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
    if KILL_CHILD in sys.argv:
        i = sys.argv.index(KILL_CHILD)
        return kill_child(sys.argv[i + 1], sys.argv[i + 2])
    if MC_KILL_CHILD in sys.argv:
        i = sys.argv.index(MC_KILL_CHILD)
        return mc_kill_child(sys.argv[i + 1], sys.argv[i + 2])
    if DATASET_KILL_CHILD in sys.argv:
        i = sys.argv.index(DATASET_KILL_CHILD)
        return dataset_kill_child(sys.argv[i + 1], sys.argv[i + 2])
    return Smoke().run(with_profile="--profile" in sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
