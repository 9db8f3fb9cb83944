#!/usr/bin/env python3
"""Where the fused fold -> quantize -> pack kernel spends its time, on the card.

    python3 psrsigsim_torch/tools/k3_study.py [--baseline DIR] [--tag NAME]
                                              [--out DIR]

Builds copies of ``csrc/fold_quantize.cu`` and ``csrc/rng_field.cu``, each
with a few lines changed by text patches (none of them is an option of the
shipped kernels), into ``build/k3_study/<tag>/``, and for every copy:

* logs ptxas's registers, stack and spills;
* dumps its SASS (``cuobjdump --dump-sass``) into the output directory
  (``--out``, default the build directory) with a ``report.json``, and
  counts the instructions of each loop body by class;
* checks that the copies that compute the whole function write the same
  bytes as the shipped kernel;
* times it on the main path's chunk (BASELINE config 1, 128 observations)
  with CUDA events, all copies in three interleaved turns.

The copies of the shipped fused kernel: ``k3new`` (as shipped), ``r8`` and
``r2`` (8 or 2 rows per block), ``lb7`` (``__launch_bounds__`` asking for 7
blocks per SM), ``unroll1``/``unroll4`` (the draw loop unrolled 1 or 4
times instead of 2),
``libm`` (Box-Muller through logf/sqrtf/sincosf), ``jm_fma`` (the
quadrant's multiply and rounding add fused), ``reduce`` (no pass 2),
``draws`` (the draws only, XORed into the row minimum, no pass 2).  With
``--baseline DIR`` (the ``csrc`` directory of an earlier commit whose
fold_quantize.cu is the one-warp-per-row general kernel, e.g. unpacked with
``git archive <commit> psrsigsim_torch/csrc``) it adds that commit's kernel
``base_full`` and its breakdown: ``base_reduce`` (no pass 2), ``base_draws``
(draws with its own indexing, XORed out), ``base_bare`` (draws with a
row-constant key and a 32-bit counter), ``base_bare_wh`` (that, with the
chi2_wh map fixed at compile time), ``base_philox`` (Philox alone); and the
sampler ``rng_base``, beside ``rng_new``, ``rng_libm`` and ``rng_jm_fma``,
whose Box-Muller self-tests it also runs.  A patch whose
target is missing raises: the study follows the sources it names.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "psrsigsim_torch", "csrc")


def cut(src, start, end):
    i = src.index(start)
    j = src.index(end, i) + len(end)
    return src[i:j]


def apply(text, patches):
    for old, new in patches:
        n = text.count(old)
        if n != 1:
            raise RuntimeError(f"patch target found {n} times:\n{old}")
        text = text.replace(old, new)
    return text


# --- the baseline kernel's variants ------------------------------------------
PASS1_HEAD = "  // pass 1: draw, fold, keep (staged), reduce\n"
REDUCE_TAIL = "  // pass 2: codes into the packed row\n"
FOLD_BODY = """      float x = p[i] * prof[bins[i]];
      if (apply_dn) x = x * draw_norm;
      v[i] = x + n[i] * nn;
"""
FOLD_XOR = """      v[i] = __uint_as_float(__float_as_uint(p[i]) ^ __float_as_uint(n[i]));
"""
SHUFFLE_HEAD = "#pragma unroll\n  for (int off = 16; off > 0; off >>= 1) {\n"
XOR_LOOP = """  float lo = INFINITY, hi = -INFINITY;
  bool fin = true;
  uint32_t acc = 0u;
  for (long long q = q0 + lane; q <= q1; q += 32) {
    float v[kLanes];
    int bins[kLanes];
    r.fold4(q, v, bins);
#pragma unroll
    for (int i = 0; i < kLanes; ++i) acc ^= __float_as_uint(v[i]);
  }
  reinterpret_cast<uint32_t*>(out)[((static_cast<size_t>(b) * gridDim.y + sub)
      * gridDim.x + grp) * kThreads + threadIdx.x] = acc;
  if (acc == 0x12345u) flags[0] = 1;
  return;
"""
REDUCE_OUT = """  if (lane == 0) {
    flags[(static_cast<size_t>(b) * nsub + sub) * nchan + c] = fin ? 1 : 0;
    reinterpret_cast<float*>(out)[(static_cast<size_t>(b) * nsub + sub) * nchan + c] =
        scl + offs + inv + (swap ? 1.0f : 0.0f);
  }
  return;
"""
FOLD4_OLD_START = "    const long long tq = q * kLanes;\n"
FOLD4_OLD_END = "      v[i] = x + n[i] * nn;\n    }\n"
BARE_FOLD4 = """    const uint32_t ctr = w * kQuadsPerRow +
                         (static_cast<uint32_t>(q) & (kQuadsPerRow - 1));
    const float4 p4 = draw4(h0p, h1p, ctr, mp);
    const float4 n4 = draw4(h0n, h1n, ctr, mn);
    v[0] = __uint_as_float(__float_as_uint(p4.x) ^ __float_as_uint(n4.x));
    v[1] = __uint_as_float(__float_as_uint(p4.y) ^ __float_as_uint(n4.y));
    v[2] = __uint_as_float(__float_as_uint(p4.z) ^ __float_as_uint(n4.z));
    v[3] = __uint_as_float(__float_as_uint(p4.w) ^ __float_as_uint(n4.w));
#pragma unroll
    for (int i = 0; i < kLanes; ++i) bins[i] = 0;
"""
PHILOX_FOLD4 = """    const uint32_t ctr = w * kQuadsPerRow +
                         (static_cast<uint32_t>(q) & (kQuadsPerRow - 1));
    const uint4 p4 = philox4x32_10(h0p, h1p, ctr);
    const uint4 n4 = philox4x32_10(h0n, h1n, ctr);
    v[0] = __uint_as_float(p4.x ^ n4.x);
    v[1] = __uint_as_float(p4.y ^ n4.y);
    v[2] = __uint_as_float(p4.z ^ n4.z);
    v[3] = __uint_as_float(p4.w ^ n4.w);
#pragma unroll
    for (int i = 0; i < kLanes; ++i) bins[i] = 0;
"""
H1_INIT_OLD = "  r.h1p = r.h1n = 0u;\n"
H1_INIT_ROW = ("  r.h1p = seed_h1(r.s1p, r.cg, 0u);\n"
               "  r.h1n = seed_h1(r.s1n, r.cg, 0u);\n")
WH_ONLY = [("  if (m.mode == kModeNormal) return z;\n"
            "  if (m.mode == kModeChi2One) return z * z;\n", ""),
           ("  return (m.mode == kModeChi2Sel && m.k == 1.0f) ? z * z : wh;\n",
            "  return wh;\n")]


def variants_base(base):
    with open(os.path.join(base, "fold_quantize.cu")) as fh:
        cu = fh.read()
    fold4_old = cut(cu, FOLD4_OLD_START, FOLD4_OLD_END)
    pass1_old = cut(cu, PASS1_HEAD, SHUFFLE_HEAD)
    draws = [(FOLD_BODY, FOLD_XOR), (pass1_old, XOR_LOOP + SHUFFLE_HEAD)]
    bare = [(fold4_old, BARE_FOLD4), (H1_INIT_OLD, H1_INIT_ROW),
            (pass1_old, XOR_LOOP + SHUFFLE_HEAD)]
    philox = [(fold4_old, PHILOX_FOLD4), (H1_INIT_OLD, H1_INIT_ROW),
              (pass1_old, XOR_LOOP + SHUFFLE_HEAD)]
    fq = "fold_quantize"
    return {
        "base_full": (base, fq, [], [], True),
        "base_reduce": (base, fq, [(REDUCE_TAIL, REDUCE_OUT + REDUCE_TAIL)], [],
                        False),
        "base_draws": (base, fq, draws, [], False),
        "base_bare": (base, fq, bare, [], False),
        "base_bare_wh": (base, fq, bare, WH_ONLY, False),
        "base_philox": (base, fq, philox, [], False),
        "rng_base": (base, "rng_field", [], [], True),
    }


# --- the redesigned kernel's variants ----------------------------------------
LAYOUT = "constexpr int kRowsPerBlock = 4;\n"
PASS1 = "#pragma unroll 2\n  for (int i = lane; i < nq; i += 32) {\n"
BOUNDS = ("__global__ void __launch_bounds__(kRowsThreads)\n"
          "fold_quantize_rows_kernel(")
BM_NEW = """  const float r = bm_radius(w1 & 0x00FFFFFFu);
  float s, c;
  bm_sincos(w2 & 0x00FFFFFFu, &s, &c);
  return make_float2(r * c, r * s);
"""
BM_LIBM = """  const float u1 = (static_cast<float>(w1 & 0x00FFFFFFu) + 1.0f) * 0x1.0p-24f;
  const float u2 = static_cast<float>(w2 & 0x00FFFFFFu) * 0x1.0p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(static_cast<float>(6.283185307179586) * u2, &s, &c);
  return make_float2(r * c, r * s);
"""
PASS2 = "  for (int i = lane; i < nq; i += 32) d2[i] = q.code4(row[i], sel);\n"
JM = "  const float jm = x * 0x1.45f306p-1f + 12582912.0f;\n"
JM_FMA = [(JM, "  const float jm = fmaf(x, 0x1.45f306p-1f, 12582912.0f);\n")]
FOLD_START = "    const float4 w = __ldg(pq + i);\n"
FOLD_END = "    hi = max_nan(max_nan(max_nan(max_nan(hi, v.x), v.y), v.z), v.w);\n"
DRAW_XOR = """    lo = __uint_as_float(__float_as_uint(lo) ^ __float_as_uint(p.x) ^
        __float_as_uint(n.x) ^ __float_as_uint(p.y) ^ __float_as_uint(n.y) ^
        __float_as_uint(p.z) ^ __float_as_uint(n.z) ^ __float_as_uint(p.w) ^
        __float_as_uint(n.w));
"""


def layout(r):
    return [(LAYOUT, f"constexpr int kRowsPerBlock = {r};\n")]


def variants_new():
    with open(os.path.join(CSRC, "fold_quantize.cu")) as fh:
        cu = fh.read()
    fq = "fold_quantize"
    draws = [(cut(cu, FOLD_START, FOLD_END), DRAW_XOR), (PASS2, "")]
    return {
        "k3new": (CSRC, fq, [], [], True),
        "r8": (CSRC, fq, layout(8), [], True),
        "r2": (CSRC, fq, layout(2), [], True),
        "lb7": (CSRC, fq, [(BOUNDS, BOUNDS.replace("(kRowsThreads)",
                                                   "(kRowsThreads, 7)"))], [], True),
        "unroll1": (CSRC, fq, [(PASS1, PASS1.replace("#pragma unroll 2\n", ""))],
                    [], True),
        "unroll4": (CSRC, fq, [(PASS1, PASS1.replace("unroll 2", "unroll 4"))],
                    [], True),
        "libm": (CSRC, fq, [], [(BM_NEW, BM_LIBM)], True),
        "reduce": (CSRC, fq, [(PASS2, "")], [], False),
        "draws": (CSRC, fq, draws, [], False),
        "jm_fma": (CSRC, fq, [], JM_FMA, True),
        "rng_new": (CSRC, "rng_field", [], [], True),
        "rng_libm": (CSRC, "rng_field", [], [(BM_NEW, BM_LIBM)], True),
        "rng_jm_fma": (CSRC, "rng_field", [], JM_FMA, True),
    }


OPCLASS = [
    ("imad", re.compile(r"^(IMAD|IMUL)")),
    ("int_alu", re.compile(r"^(IADD3|IADD|LOP3|LOP|SHF|SHL|SHR|LEA|ISETP|IABS|"
                           r"IMNMX|SEL|PRMT|POPC|FLO|BMSK|SGXT|VIADD|VIMNMX|"
                           r"IDP|BREV|PLOP3|P2R|R2P)")),
    ("fp32", re.compile(r"^(FADD|FMUL|FFMA|FSETP|FMNMX|FSEL|FCHK|FSET|FSWZADD)")),
    ("mufu", re.compile(r"^MUFU")),
    ("conv", re.compile(r"^(I2F|F2I|FRND|F2F|I2FP|F2IP)")),
    ("mem", re.compile(r"^(LDG|STG|LDS|STS|LDL|STL|LD|ST|LDC|ATOM|RED)")),
    ("ctrl", re.compile(r"^(BRA|BSSY|BSYNC|EXIT|CALL|RET|WARPSYNC|BAR|BPT|"
                        r"NOP|YIELD|JMP|BMOV)")),
    ("shfl_vote", re.compile(r"^(SHFL|VOTE|MATCH)")),
    ("uniform", re.compile(r"^(U|S2UR|R2UR)")),
    ("move", re.compile(r"^(MOV|S2R|CS2R)")),
]
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def classify(op):
    base = op.split(".")[0]
    for name, rx in OPCLASS:
        if rx.match(base):
            return name
    return "other:" + base


def sass_functions(text):
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        if cur is None:
            continue
        m = INSN.search(line)
        if m:
            funcs[cur].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def loops(insns):
    out = []
    for addr, op, args in insns:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) <= addr:
                t = int(m.group(1), 16)
                out.append((t, addr, [i for i in insns if t <= i[0] <= addr]))
    return out


def class_counts(body):
    c = collections.Counter(classify(op) for _, op, _ in body)
    return dict(sorted(c.items(), key=lambda kv: -kv[1]))


def build(variants, outdir):
    from psrsigsim_torch.ops import _build

    procs = {}
    for name, (srcdir, kern, cu_p, cuh_p, _) in variants.items():
        d = os.path.join(outdir, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(srcdir):
            if f.endswith(".cuh"):
                with open(os.path.join(srcdir, f)) as fh:
                    text = fh.read()
                if f == "philox_field.cuh":
                    text = apply(text, cuh_p)
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(text)
        with open(os.path.join(srcdir, f"{kern}.cu")) as fh:
            text = apply(fh.read(), cu_p)
        with open(os.path.join(d, f"{kern}.cu"), "w") as fh:
            fh.write(text)
        so = os.path.join(d, f"{kern}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
               os.path.join(d, f"{kern}.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        logs[name] = log
        if p.returncode != 0:
            print(f"BUILD FAIL {name}\n{log}", flush=True)
            continue
        libs[name] = (ctypes.CDLL(so), so)
    return libs, logs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None,
                    help="csrc directory of an earlier commit to compare")
    ap.add_argument("--tag", default="study")
    ap.add_argument("--out", default=None,
                    help="where the SASS and report.json go (default: the "
                         "build directory)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()

    import torch

    import chip_smoke
    from psrsigsim_torch.ops import _build
    from psrsigsim_torch.ops.rng_hw import MODES

    bdir = os.path.join(ROOT, "build", "k3_study", a.tag)
    out = a.out or bdir
    os.makedirs(out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    variants = variants_new()
    if a.baseline:
        variants.update(variants_base(a.baseline))
    t0 = time.perf_counter()
    libs, logs = build(variants, bdir)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    report = {"card": smi, "variants": {}}
    for name, (lib, so) in libs.items():
        info = {"ptxas": chip_smoke.ptxas_summary(logs[name]), "funcs": {}}
        sass = subprocess.run([cuobjdump, "--dump-sass", so],
                              capture_output=True, text=True).stdout
        with open(os.path.join(out, f"{name}.sass"), "w") as fh:
            fh.write(sass)
        for fname, insns in sass_functions(sass).items():
            info["funcs"][fname] = {
                "n": len(insns), "classes": class_counts(insns),
                "loops": [{"start": hex(s), "end": hex(e), "n": len(body),
                           "classes": class_counts(body)}
                          for s, e, body in loops(insns)]}
        report["variants"][name] = info
        print(f"== {name}", flush=True)
        for ln in info["ptxas"]:
            print("  " + ln, flush=True)
        for fname, fi in info["funcs"].items():
            print(f"  {fname[-60:]}: {fi['n']} insns", flush=True)
            for lp in fi["loops"]:
                if lp["n"] > 30:
                    print(f"    loop {lp['start']}-{lp['end']}: {lp['n']} "
                          f"{lp['classes']}", flush=True)

    sm = chip_smoke.Smoke()
    args, kw, _ = sm.main_fused_args()
    B, C, nph = args["prof"].shape
    nsub = kw["nsub"]
    dev = torch.device("cuda")
    dn = float(kw["draw_norm"])
    L = nsub * nph

    def fq_launcher(lib, packed, flags):
        # the scenario factors (gain, energy, level) trail the argument
        # list as null pointers: the scenario-free launch, which a kernel
        # from before the factors existed takes too (it ignores them)
        fn = lib.fold_quantize_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int

        def go():
            err = fn(args["seeds"].data_ptr(), args["dfs"].data_ptr(),
                     MODES[args["modes"][0]], MODES[args["modes"][1]],
                     args["prof"].data_ptr(), args["noise_norm"].data_ptr(), dn,
                     int(dn != 1.0), packed.data_ptr(), flags.data_ptr(), B, C,
                     nsub, nph, 0, 0, 0, torch.cuda.current_stream().cuda_stream,
                     None, None, None)
            if err:
                raise RuntimeError(f"launch failed {err}")
        return go

    rseeds = args["seeds"][0].contiguous()
    rdfs = args["dfs"][0].contiguous()
    pos = torch.zeros((B, 2), dtype=torch.int32, device=dev)

    def rng_launcher(lib, field):
        # the rows layout; sources older than the flat layout name the same
        # launch rng_field_launch, without the layout and skip arguments
        extra = ()
        fn = getattr(lib, "rng_field_layout_launch", None)
        if fn is not None:
            extra = (0, 0)
        else:
            fn = lib.rng_field_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(extra))
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def go():
            err = fn(rseeds.data_ptr(), rdfs.data_ptr(), pos.data_ptr(),
                     field.data_ptr(), B, C, L, MODES["chi2_wh"], *extra,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed {err}")
        return go

    for name, (lib, so) in libs.items():
        fn = getattr(lib, "box_muller_selftest", None)
        if fn is not None:  # the sampler's copies that carry the self-test
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            miss = torch.zeros(3, dtype=torch.int64, device=dev)
            if fn(miss.data_ptr(), torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"{name}: self-test launch failed")
            print(f"  {name} Box-Muller self-test mismatches (radius, sin, "
                  f"cos): {miss.tolist()}", flush=True)
            report["variants"][name]["selftest"] = miss.tolist()

    launchers, outputs = {}, {}
    for name, (lib, so) in libs.items():
        if variants[name][1] == "fold_quantize":
            packed = torch.empty((B, nsub, C, nph + 4), dtype=torch.int16, device=dev)
            flags = torch.empty((B, nsub, C), dtype=torch.bool, device=dev)
            launchers[name] = fq_launcher(lib, packed, flags)
            outputs[name] = (packed, flags)
        else:
            field = torch.empty((B, C, L), dtype=torch.float32, device=dev)
            launchers[name] = rng_launcher(lib, field)
            outputs[name] = (field,)
    for name, go in launchers.items():
        go()
    torch.cuda.synchronize()
    for kern, ref in (("fold_quantize", "k3new"), ("rng_field", "rng_new")):
        for name in libs:
            if variants[name][1] == kern and variants[name][4]:
                same = all(torch.equal(x, y) for x, y in
                           zip(outputs[name], outputs[ref]))
                print(f"  {name} output == {ref}: {same}", flush=True)
                report["variants"][name]["equal_to_" + ref] = same
    del outputs
    names = list(launchers)
    order = names + names[::-1] + names
    times = collections.defaultdict(list)
    for name in order:
        times[name].append(chip_smoke.cuda_time_ms(launchers[name], a.reps))
    print(f"modes {args['modes']} draw_norm {dn} shape B={B} C={C} nsub={nsub} "
          f"nph={nph} on {smi}", flush=True)
    for name in names:
        ts = times[name]
        report["variants"][name]["ms"] = ts
        print(f"  {name:12s} ms {min(ts):.4f}-{max(ts):.4f}  "
              f"{[round(t, 4) for t in ts]}", flush=True)
    with open(os.path.join(out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
