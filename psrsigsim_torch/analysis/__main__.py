"""psrlint CLI: ``python -m psrsigsim_torch.analysis [paths...]``
(counterpart: psrsigsim_tpu/analysis/__main__.py).

Exit status is 0 when every finding is covered by the baseline ratchet
(analysis/baseline.txt), 1 when any (rule, file) bucket regressed, and
2 on usage errors.  ``--trace-check`` additionally runs the dynamic probe
over the public ops surface (imports torch) on ``--device``: the card by
default (it raises without one), the host with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .core import (RULES, baseline_regressions, iter_source_files,
                   load_baseline, load_config, run_lint, write_baseline)


def _default_root():
    """The installed package tree — so a bare invocation lints us."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_baseline():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m psrsigsim_torch.analysis",
        description="psrlint: PyTorch/CUDA correctness linter "
                    "(host syncs, RNG discipline, dtype/mesh hygiene)")
    parser.add_argument("paths", nargs="*",
                        help="package roots to lint (default: the "
                             "installed psrsigsim_torch tree)")
    parser.add_argument("--baseline", default=None,
                        help="baseline ratchet file (default: the "
                             "packaged analysis/baseline.txt)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding as a failure")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "(ratchet down after fixing debt)")
    parser.add_argument("--trace-check", action="store_true",
                        help="also run the dynamic probe over "
                             "psrsigsim_torch.ops (imports torch)")
    parser.add_argument("--device", default=None,
                        help="where --trace-check runs its probes "
                             "(default: the CUDA card, raising without "
                             "one; cpu runs them on the host without the "
                             "sync check)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="print only regressions, not baselined debt")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, (severity, desc) in sorted(RULES.items()):
            print(f"{rule} [{severity}] {desc}")
        return 0

    roots = args.paths or [_default_root()]
    findings = []
    scanned = set()       # rel paths (baseline keys are rel)
    scanned_abs = set()   # dedup identity is the FILE, not its rel path
    for root in roots:
        if not os.path.exists(root):
            print(f"error: no such path: {root}", file=sys.stderr)
            return 2
        config = load_config(root)
        # overlapping roots must not lint a file twice (doubled findings
        # read as phantom baseline regressions, and re-parsing is wasted
        # work) — dedup keys on the absolute path: two DIFFERENT packages
        # may both own a core.py, and the second one must still be gated
        pairs = list(iter_source_files(root, config))
        fresh = [(path, rel) for path, rel in pairs
                 if path not in scanned_abs]
        scanned_abs |= {path for path, _ in pairs}
        scanned |= {rel for _, rel in pairs}
        findings.extend(run_lint(root, config=config, files=fresh))

    baseline_path = args.baseline or _default_baseline()
    if args.write_baseline:
        # a sub-path scan re-ratchets only what it linted: entries for
        # files outside the scanned scope are preserved, not discarded
        preserve = {k: v for k, v in load_baseline(baseline_path).items()
                    if k[1] not in scanned}
        write_baseline(baseline_path, findings, preserve=preserve)
        print(f"wrote {len(findings)} findings "
              f"(+{len(preserve)} out-of-scope entries preserved) to "
              f"{baseline_path}")
        return 0

    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    regressions = baseline_regressions(findings, baseline)
    reg_keys = {(f.rule, f.path) for f in regressions}

    shown = 0
    for f in findings:
        is_reg = (f.rule, f.path) in reg_keys
        if args.quiet and not is_reg:
            continue
        tag = "" if is_reg else "  (baselined)"
        print(f.format() + tag)
        shown += 1

    status = 0
    if regressions:
        print(f"\npsrlint: {len(regressions)} finding(s) above baseline "
              f"in {len(reg_keys)} (rule, file) bucket(s) — fix them or "
              "consciously ratchet with --write-baseline", file=sys.stderr)
        status = 1
    elif shown:
        print(f"\npsrlint: {shown} baselined finding(s), no regressions")
    else:
        print("psrlint: clean")

    if args.trace_check:
        from .trace_check import (run_dataset_trace_check,
                                  run_serve_trace_check, run_trace_check)

        results = run_trace_check(device=args.device)
        results += run_serve_trace_check(device=args.device)
        results += run_dataset_trace_check(device=args.device)
        count = {s: sum(1 for r in results if r.status == s)
                 for s in ("ok", "sync", "exempt")}
        print(f"trace-check on {args.device or 'cuda'}: {count['ok']} "
              "probe(s) clean, "
              f"{count['sync']} syncing by design, {count['exempt']} "
              "exempt (ops, the serving bucket programs and the dataset "
              "record program)")

    return status


if __name__ == "__main__":
    sys.exit(main())
