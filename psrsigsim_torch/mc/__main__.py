"""CLI: run a Monte-Carlo study from a declarative spec file (counterpart:
psrsigsim_tpu/mc/__main__.py).

Usage::

    python -m psrsigsim_torch.mc study.toml [--n-trials N] [--out DIR]
        [--chunk-size N] [--seed N] [--no-resume] [--quiet]
        [--device DEVICE]

The study runs on the CUDA card; ``--device cpu`` runs it on the host
(the port's one flag beyond the JAX package's).

The spec has three tables (TOML; a ``.json`` file with the same shape is
also accepted)::

    [simulation]            # Simulation psrdict keys (simulate/simulate.py)
    fcent = 1400.0
    bandwidth = 400.0
    ...

    [study]
    n_trials = 10000
    seed = 1
    chunk_size = 256
    out_dir = "mc_out"      # optional: enables journal + artifact

    [priors.dm]             # one table per varied knob (mc/study.py KNOBS)
    dist = "uniform"
    lo = 10.0
    hi = 20.0

Python 3.11+ parses TOML with the stdlib ``tomllib``; on older runtimes a
built-in minimal TOML-subset reader (tables, scalars, arrays — exactly
the shapes above) keeps the CLI dependency-free.

Prints one machine-parseable JSON line on stdout (summary digest, artifact
fingerprint, stage-timer snapshot); everything chatty goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_scalar(tok):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(t) for t in inner.split(",")]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        raise ValueError(f"cannot parse TOML value: {tok!r}") from None


def parse_toml_min(text):
    """Minimal TOML-subset reader for study specs (fallback when the
    stdlib ``tomllib`` is unavailable, i.e. Python < 3.11).

    Supports ``[dotted.tables]``, ``key = value`` with strings, ints,
    floats, booleans, and flat arrays, plus ``#`` comments — the complete
    grammar the spec format uses.  Anything fancier raises loudly rather
    than mis-reading a study definition.
    """
    root = {}
    table = root
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if not line.endswith("]") or line.startswith("[["):
                raise ValueError(f"line {lineno}: unsupported TOML table "
                                 f"syntax: {raw!r}")
            table = root
            for part in line[1:-1].strip().split("."):
                part = part.strip()
                if not part:
                    raise ValueError(f"line {lineno}: empty table name")
                table = table.setdefault(part, {})
            continue
        if "=" not in line:
            raise ValueError(f"line {lineno}: expected key = value: {raw!r}")
        key, _, val = line.partition("=")
        val = val.strip()
        # strip trailing comments outside strings (good enough for the
        # restricted value grammar: quotes never contain '#' in specs)
        if "#" in val and not (val.startswith('"') or val.startswith("'")):
            val = val.partition("#")[0].strip()
        table[key.strip()] = _parse_scalar(val)
    return root


def load_spec(path):
    """Load a study spec: stdlib tomllib when available, the minimal
    subset reader otherwise; ``.json`` files load as JSON directly."""
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f)
    try:
        import tomllib
    except ModuleNotFoundError:
        tomllib = None
    if tomllib is not None:
        with open(path, "rb") as f:
            return tomllib.load(f)
    with open(path) as f:
        return parse_toml_min(f.read())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m psrsigsim_torch.mc",
        description="Run a Monte-Carlo TOA/statistics study from a spec file")
    ap.add_argument("spec", help="study spec (.toml or .json)")
    ap.add_argument("--n-trials", type=int, default=None,
                    help="override [study].n_trials")
    ap.add_argument("--out", default=None, help="override [study].out_dir")
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true",
                    help="start clean even if the out_dir holds a journal")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the progress meter")
    ap.add_argument("--device", default=None,
                    help="where the trials run (default: the CUDA card; "
                         "'cpu' for the host)")
    args = ap.parse_args(argv)

    spec = load_spec(args.spec)
    simdict = spec.get("simulation")
    if not isinstance(simdict, dict) or not simdict:
        raise SystemExit("spec needs a [simulation] table of psrdict keys")
    study_cfg = dict(spec.get("study") or {})
    priors = {k: dict(v) for k, v in dict(spec.get("priors") or {}).items()}

    n_trials = args.n_trials or int(study_cfg.get("n_trials", 0))
    if n_trials <= 0:
        raise SystemExit("set [study].n_trials (or pass --n-trials)")
    seed = args.seed if args.seed is not None else int(
        study_cfg.get("seed", 0))
    chunk_size = args.chunk_size or int(study_cfg.get("chunk_size", 256))
    out_dir = args.out or study_cfg.get("out_dir")

    progress = None
    if not args.quiet:
        def progress(done, total):
            print(f"\r{done}/{total} trials", end="", file=sys.stderr,
                  flush=True)

    # keep stdout clean for the single JSON result line: the OO layer's
    # reference-parity warnings (sub-Nyquist sampling etc.) print to stdout
    import contextlib

    with contextlib.redirect_stdout(sys.stderr):
        from ..simulate import Simulation

        sim = Simulation(psrdict=simdict, device=args.device)
        result = sim.run_mc_study(
            priors, n_trials, seed=seed, out_dir=out_dir,
            chunk_size=chunk_size, resume=not args.no_resume,
            progress=progress)
    if progress is not None:
        print("", file=sys.stderr)

    summary = result.summary()
    line = {
        "metric": "mc_study",
        "n_trials": result.n_trials,
        "params": list(result.param_names),
        "metrics": list(result.metric_names),
        "per_metric": {
            name: {k: summary["per_metric"][name][k]
                   for k in ("mean", "std", "min", "max")}
            for name in result.metric_names
        },
        "artifact_sha256": result.fingerprint,
        "out_dir": out_dir,
        "pipeline": result.telemetry,
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
