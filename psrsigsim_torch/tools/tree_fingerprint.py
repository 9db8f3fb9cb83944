#!/usr/bin/env python3
"""The scenario-free main path's fingerprint of one checkout, on the card.

    python3 psrsigsim_torch/tools/tree_fingerprint.py TREE [TREE ...]

For each checkout ``TREE`` (the current one is ``.``; an earlier commit
unpacked with ``git archive`` into an ignored directory), in a process of
its own, on BASELINE config 1 at full width (``chip_smoke.py``'s main
path): sha256 prefixes of ``run_quantized(128)`` (codes, scales, offsets,
finite guard), ``run(16)`` and ``iter_chunks(256, chunk_size=128)``
big-endian, of ``run_quantized(128)`` with phase 12's scenario stack and
parameters, and of ``single_pipeline`` at BASELINE config 4 (phase 13's
observations 0-1); the fused kernel's time on the main path's chunk (three
CUDA-event means of 50 launches); and the instruction count and hash of
the rows kernel's scenario-free instantiation in ``cuobjdump -sass``
(addresses and encodings dropped).  One JSON line per tree, then the
card's name and power limit.  Run trees in turns (parent, change, change,
parent) to compare two versions on one card.
"""

import glob
import hashlib
import json
import os
import re
import subprocess
import sys


def fingerprint(root):
    """The JSON-able fingerprint of the checkout at ``root`` (imports that
    checkout's package: run one tree per process)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from psrsigsim_torch.ops import _build
    from psrsigsim_torch.ops import fold_quantize as fq

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(np.ascontiguousarray(
                t.cpu().numpy() if torch.is_tensor(t) else t).tobytes())
        return h.hexdigest()[:16]

    _build.build_all()
    smoke = cs.Smoke()
    ens = smoke.main_ensemble()
    out = {"tree": root,
           "run_quantized": sha(*ens.run_quantized(128, seed=0,
                                                   return_finite=True)),
           "run16": sha(ens.run(16, seed=0)),
           "iter_chunks": sha(*[x for _, c in ens.iter_chunks(
               256, chunk_size=128, seed=0, quantized=True, byte_order="big",
               finite_mask=True) for x in c])}
    scen = cs.geometry(cs.MAIN, "cuda", scenario=cs.SCEN_STACK)
    out["scenario"] = sha(*scen.run_quantized(
        128, seed=0, scenario_params=cs.scenario_params(128)))
    from psrsigsim_torch.simulate import single_pipeline
    from psrsigsim_torch.utils import key, stage_key

    cfg4, prof4, nn4 = cs.config4()
    out["search2"] = sha(single_pipeline(
        stage_key(key(0, "cpu"), "user", torch.arange(2)),
        torch.full((2,), cs.CONFIG4["dm"]), torch.full((2,), nn4),
        torch.as_tensor(prof4, device="cuda"), cfg4))
    a, kw, _ = smoke.main_fused_args()
    out["k3_ms"] = [cs.cuda_time_ms(lambda: fq.fold_quantize(**a, **kw), 50)
                    for _ in range(3)]
    so = glob.glob(os.path.join(root, "build", "fold_quantize-*.so"))[0]
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                           so], capture_output=True, text=True,
                          check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        # the rows kernel's chi2_wh x chi2_wh instantiation, without the
        # scenario factors (a third template argument of 0 where there is one)
        if "rows_kernel" in name and ("ILi2ELi2EEEv" in name
                                      or "ILi2ELi2ELi0EEEv" in name):
            ins = [m.group(1).strip() for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s*([^;]*);", body)]
            out["rows_sass"] = [len(ins), hashlib.sha256(
                "\n".join(ins).encode()).hexdigest()[:16]]
    return out


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        print(json.dumps(fingerprint(os.path.abspath(sys.argv[2]))),
              flush=True)
        return 0
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
