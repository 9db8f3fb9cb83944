#!/usr/bin/env python3
"""The Fourier shift's FFT group size on the card: how far each group's
cuFFT algorithm rounds from the host, what the front half costs, and what
the group changed against an earlier checkout.

    python3 psrsigsim_torch/tools/fft_group_study.py [--baseline DIR]
    python3 psrsigsim_torch/tools/fft_group_study.py --parity [REPS]

On BASELINE config 1 at full width (``chip_smoke.py``'s main path, 2048
samples a row), for each number of rows per FFT call: observations 0-7's
codes on the card against ``device="cpu"`` (``PSS_SAMPLER=hw``, the same
fields), scenario-free and with phase 12's scenario stack (fraction of
codes that differ, largest difference in LSB), and the device busy time
of a 128-observation chunk's front half (``simulate.pipeline._fold_front``
under torch.profiler, three runs).  ``--baseline DIR`` (an earlier commit
unpacked with ``git archive`` into an ignored directory) also runs
``run_quantized(128)`` of seed 0 in DIR's checkout and in this one, each
in a process of its own, and compares their codes, scales and offsets.
``--parity`` runs ``chip_smoke.py`` phase 6's comparison instead
(``PSS_SAMPLER=threefry``, ``run(8)`` float blocks of the parity geometry
on the card against ``device="cpu"``, limit rel 1e-5) ``REPS`` times
(default 3) for each of 1024, 2048 and 65,536 rows per FFT call.
Prints one JSON line per measurement, then the card's name and power
limit.  Needs one card; about a minute on an H100.
"""

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROWS = (64, 256, 512, 1024, 2048, 4096, 8192)
PARITY_ROWS = (1024, 2048, 65536)

_DUMP = """
import sys, numpy as np
sys.path.insert(0, {root!r})
import chip_smoke as cs
ens = cs.geometry(cs.MAIN, "cuda")
for name, t in zip("dso", ens.run_quantized(cs.MAIN_NOBS, seed=0)):
    np.save({out!r} + "_" + name + ".npy", t.cpu().numpy())
"""


def codes_apart(a, b):
    import numpy as np

    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff != 0).mean()), int(diff.max())


def group_table():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from psrsigsim_torch.ops import shift
    from psrsigsim_torch.parallel import FoldEnsemble
    from psrsigsim_torch.simulate import pipeline

    dev = torch.device("cuda")
    free = cs.geometry(cs.MAIN, dev)
    cfg, n = free.cfg, cs.SCEN_HOST_NOBS
    sp = cs.scenario_params(cs.MAIN_NOBS)
    hp = {k: (v[:n] if np.ndim(v) else v) for k, v in sp.items()}

    def ens(device, stack):
        return FoldEnsemble.from_config(cfg, free._profiles_np,
                                        free.noise_norm, dm=free.dm,
                                        device=device, scenario=stack)

    stacks = {"free": None, "scenario": cs.SCEN_STACK}
    host = {}
    os.environ["PSS_SAMPLER"] = "hw"
    try:
        for label, stack in stacks.items():
            kw = {} if stack is None else {"scenario_params": hp}
            host[label] = ens("cpu", stack).run_quantized(n, seed=0, **kw)[0]
    finally:
        os.environ.pop("PSS_SAMPLER")
    chunk = free._prep_chunk(np.arange(cs.MAIN_NOBS), 0, None, None)

    def front():
        return pipeline._fold_front(*chunk, free._profiles, cfg, free._freqs,
                                    free._chan_ids, None, None)

    limits = dict(shift._GROUP_LIMITS)
    try:
        for rows in ROWS:
            shift._GROUP_LIMITS["cuda"] = (rows, rows * cfg.nph)
            out = {"rows_per_call": rows}
            for label, stack in stacks.items():
                kw = {} if stack is None else {"scenario_params": sp}
                card = ens(dev, stack).run_quantized_at(np.arange(n), seed=0,
                                                        **kw)[0]
                frac, worst = codes_apart(card.cpu().numpy(),
                                          host[label].numpy())
                out[f"{label}_codes_apart"] = frac
                out[f"{label}_max_lsb"] = worst
            front()
            torch.cuda.synchronize()
            out["front_half_busy_ms"] = [
                cs.device_profile(torch, front)[1] / 1e3 for _ in range(3)]
            print(json.dumps(out), flush=True)
    finally:
        shift._GROUP_LIMITS.update(limits)


def parity_table(reps):
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from psrsigsim_torch.ops import shift

    limits = dict(shift._GROUP_LIMITS)
    os.environ["PSS_SAMPLER"] = "threefry"
    try:
        card = cs.geometry(cs.PARITY, "cuda")
        want = cs.geometry(cs.PARITY, "cpu").run(8, seed=1).numpy()
        for rows in PARITY_ROWS:
            shift._GROUP_LIMITS["cuda"] = (rows, rows * card.cfg.nph)
            for rep in range(reps):
                got = card.run(8, seed=1).cpu().numpy()
                rel = np.abs(got - want) / np.abs(want)
                at = np.unravel_index(np.argmax(rel), rel.shape)
                print(json.dumps({
                    "parity_rows_per_call": rows, "rep": rep,
                    "max_rel": float(rel.max()), "at": [int(i) for i in at],
                    "beyond_1e-5": int((rel > 1e-5).sum()),
                    "bit_equal": float(np.mean(got == want))}), flush=True)
    finally:
        shift._GROUP_LIMITS.update(limits)
        os.environ.pop("PSS_SAMPLER", None)


def baseline(old):
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        arrays = {}
        for tag, root in (("baseline", os.path.abspath(old)), ("this", ROOT)):
            out = os.path.join(tmp, tag)
            subprocess.run([sys.executable, "-c",
                            _DUMP.format(root=root, out=out)],
                           check=True, cwd=root)
            arrays[tag] = [np.load(f"{out}_{k}.npy") for k in "dso"]
        (d0, s0, o0), (d1, s1, o1) = arrays["baseline"], arrays["this"]
        frac, worst = codes_apart(d0, d1)
        print(json.dumps({
            "baseline": os.path.abspath(old), "codes_apart": frac,
            "max_lsb": worst,
            "scl_max_rel": float(np.abs(s0 / s1 - 1).max()),
            "offs_max_rel": float(np.abs(o0 / o1 - 1).max())}), flush=True)


def main(argv):
    if "--parity" in argv:
        rest = argv[argv.index("--parity") + 1:]
        parity_table(int(rest[0]) if rest else 3)
    else:
        if "--baseline" in argv:
            baseline(argv[argv.index("--baseline") + 1])
        group_table()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
