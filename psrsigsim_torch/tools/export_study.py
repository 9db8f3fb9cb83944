#!/usr/bin/env python3
"""Where the PSRFITS export spends its time, on the card's host.

    python3 psrsigsim_torch/tools/export_study.py [--nobs N] [--writers 1,4,8]

On BASELINE config 1 at full width (the main path of ``chip_smoke.py``,
128-observation chunks of 672 MB):

* ``iter_chunks`` over 4 chunks at (prefetch, fetch_ahead) = (0, 0),
  (1, 0), (1, 2) and (2, 2), each chunk dropped as it comes, three
  interleaved turns after one untimed run of each;
* the writer pool's parent-side cost: one chunk copied into a fresh
  shared-memory block, and again into the same block;
* ``export_ensemble_psrfits`` of ``--nobs`` observations (default 1024),
  one per file, depth 2, with each writer count of ``--writers``, into a
  temporary directory under the checkout's ``build/`` (deleted after each
  export): wall, obs/s and the stage timers.

Prints the card's name and power limit first and the filesystem written
to; needs one CUDA card.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nobs", type=int, default=1024)
    ap.add_argument("--writers", default="1,4,8")
    args = ap.parse_args()

    import numpy as np
    import torch
    from multiprocessing import shared_memory

    import chip_smoke as cs
    from psrsigsim_torch.io import export_ensemble_psrfits
    from psrsigsim_torch.runtime import StageTimers

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    ens = cs.geometry(cs.MAIN, torch.device("cuda"))
    chunk = cs.MAIN_NOBS

    # iter_chunks with and without the overlap
    def rate(opts, n=4 * chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in ens.iter_chunks(n, chunk_size=chunk, seed=0, quantized=True,
                                 byte_order="big", prefetch=opts[0],
                                 fetch_ahead=opts[1]):
            pass
        return n / (time.perf_counter() - t0)

    settings = ((0, 0), (1, 0), (1, 2), (2, 2))
    for opts in settings:
        rate(opts)
    rates = {opts: [] for opts in settings}
    for _ in range(3):
        for opts in settings:
            rates[opts].append(rate(opts))
    for (p, f), r in rates.items():
        print(f"iter_chunks({4 * chunk}, chunk {chunk}) prefetch {p}, "
              f"fetch_ahead {f}: " + ", ".join(f"{x:.1f}" for x in r)
              + f" obs/s ({card})", flush=True)

    # the pool's copy of one chunk into shared memory
    packed, _ = ens._quantized_packed(*ens._prep_chunk(
        np.arange(chunk), 0, None, None), "big")
    host = packed.cpu().numpy()
    shm = shared_memory.SharedMemory(create=True, size=host.nbytes)
    try:
        view = np.ndarray(host.shape, host.dtype, buffer=shm.buf)
        for label in ("fresh block", "same block again"):
            t0 = time.perf_counter()
            view[...] = host
            print(f"chunk copy into shared memory, {label}: "
                  f"{time.perf_counter() - t0:.3f} s for "
                  f"{host.nbytes / 1e6:.0f} MB", flush=True)
        del view
    finally:
        shm.close()
        shm.unlink()

    # the export at each writer count
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    df = subprocess.run(["df", "-T", build], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    print(f"writing to {build}: {df}; os.cpu_count() {os.cpu_count()}",
          flush=True)
    for w in (int(x) for x in args.writers.split(",")):
        work = tempfile.mkdtemp(prefix="export-study-", dir=build)
        try:
            timers = StageTimers()
            t0 = time.perf_counter()
            export_ensemble_psrfits(ens, args.nobs, work, cs.TEMPLATE,
                                    ens.pulsar, seed=0, chunk_size=chunk,
                                    writers=w, telemetry=timers)
            wall = time.perf_counter() - t0
            s = timers.snapshot()
            print(f"export {args.nobs} obs, one per file, depth 2, {w} "
                  f"writer(s): {wall:.3f} s = {args.nobs / wall:.1f} obs/s; "
                  + ", ".join(f"{k} {s[k + '_s']:.3f} s" for k in
                              ("dispatch", "fetch", "encode", "write"))
                  + f", bottleneck {s['bottleneck']} ({card})", flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
