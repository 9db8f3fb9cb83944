"""psrlint core: findings, configuration, suppression, baseline, driver
(counterpart: psrsigsim_tpu/analysis/core.py, copied and re-pointed).

The checkers themselves live in :mod:`psrsigsim_torch.analysis.checkers`;
this module is pure stdlib (no torch import) so ``python -m
psrsigsim_torch.analysis`` starts instantly and runs anywhere — the
dynamic probe (:mod:`psrsigsim_torch.analysis.trace_check`) is the only
part that touches torch or a device.

Design notes
------------
* A :class:`Finding` is one (path, line, rule) diagnostic with a stable
  rule ID (``PSR1xx``).  Output format is the classic
  ``path:line:col: RULE [severity] message``.
* Suppression is source-level: ``# psrlint: disable=PSR102`` on a line
  silences that line; the same comment on a ``def`` line silences the
  whole function body (checkers attach the owning function's line to
  each finding for exactly this purpose).
* The baseline file is a RATCHET, not an allowlist of lines: it records
  per ``(rule, file)`` finding COUNTS, so pre-existing debt neither
  blocks CI nor shields new regressions in other files, and shrinking a
  count can be locked in with ``--write-baseline``.  Line-based
  baselines rot on every unrelated edit; count ratchets do not.
* The configuration is the port's own: :class:`LintConfig`'s defaults.
  No pyproject.toml is read: the ``[tool.psrlint]`` section of this
  repository's pyproject.toml configures the JAX package's linter (its
  device modules, its sinks).  The TOML reader is kept for parity with
  the reference's parser.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass, field

__all__ = [
    "Finding",
    "LintConfig",
    "load_config",
    "run_lint",
    "load_baseline",
    "write_baseline",
    "baseline_regressions",
    "iter_source_files",
    "RULES",
]

# rule ID -> (severity, one-line description); the registry the CLI and
# docs/torch/static_analysis.md both mirror.  The IDs and severities are the
# JAX package's; the descriptions say what each rule means on tensors.
# Checkers are registered against these IDs in checkers.py.
RULES = {
    "PSR100": ("error", "source file does not parse"),
    "PSR101": ("error", "host sync in hot code: Python control flow / "
                        "coercion / host transfer of a device tensor"),
    "PSR102": ("warning", "host numpy/scipy call on a tensor-derived value "
                          "in a device module (forces a host round-trip)"),
    "PSR103": ("error", "threefry key passed to two sinks without an "
                        "intervening split/fold_in"),
    "PSR104": ("warning", "float64/implicit dtype in device code "
                          "(bit-reproducibility hazard)"),
    "PSR105": ("warning", "module-level mutable state rebound from a "
                          "function body"),
    "PSR106": ("error", "mesh axis name not defined by the mesh"),
}


@dataclass(frozen=True)
class Finding:
    """One diagnostic, ordered for stable output."""

    path: str        # posix relpath from the scan root
    line: int
    col: int
    rule: str
    message: str
    severity: str = "warning"
    func_line: int = 0   # def-line of the owning function (0 = module)

    def format(self):
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.severity}] {self.message}")

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)


@dataclass
class LintConfig:
    """Checker scoping knobs.  The defaults ARE the port's configuration
    (the JAX package's ``[tool.psrlint]`` lists, with the port-only
    ``tools/*`` excluded); fixtures pass their own."""

    include: tuple = ("*.py",)
    # tools/* (port-only) holds measurement scripts for the card, not
    # library code: excluded like analysis/*
    exclude: tuple = ("analysis/*", "data/*", "io/native/*", "tools/*")
    # globs (relative to the scan root) of modules whose functions feed
    # the device pipelines: PSR102/PSR104 only fire inside these
    device_modules: tuple = ("ops/*", "parallel/*", "models/*",
                             "simulate/pipeline.py", "mc/priors.py",
                             "scenarios/registry.py", "datasets/sampler.py",
                             "runtime/dist.py")
    # every top-level function in these globs is hot code (a host sync
    # there stalls the card) even without a local staging site (ops are the
    # pipeline's kernels and their wrappers)
    assume_jitted: tuple = ("ops/*",)
    # np.<attr> accesses that never force a host round-trip on tensors
    numpy_allow: tuple = ("ndim", "shape", "size", "iinfo", "finfo",
                          "dtype", "result_type", "promote_types")
    # local wrappers that CONSUME a threefry key (utils/rng.py) like a
    # sampler of the rng module
    rng_sinks: tuple = ("chi2_sample", "normal_sample", "blocked_chan_chi2",
                        "blocked_chan_normal", "chan_chi2_field",
                        "chan_normal_field", "flat_normal_field",
                        "flat_chi2_field", "hw_chan_field", "sample_priors")
    # axis names beyond those discovered in parallel/mesh.py (the seq
    # pipeline defines its own 1-D mesh in parallel/seqshard.py)
    mesh_axes_extra: tuple = ("seq",)
    # explicit axis set: overrides discovery entirely (used by fixtures)
    mesh_axes: tuple = ()


_LIST_RE = re.compile(r"^\s*([A-Za-z0-9_-]+)\s*=\s*\[(.*)\]\s*$")
_SCALAR_RE = re.compile(r"^\s*([A-Za-z0-9_-]+)\s*=\s*(.+?)\s*$")


def _parse_toml_section(text, section):
    """Minimal TOML reader for one flat section (python 3.10 has no
    tomllib and this container must not grow dependencies): supports
    ``key = "str"`` and string arrays — single-line or spread across
    lines, as TOML formatters emit them."""
    out = {}
    in_section = False
    pending_key = None   # multi-line array being accumulated
    pending_buf = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0] if not raw.lstrip().startswith("#") else ""
        if pending_key is not None:
            pending_buf += " " + line.strip()
            if "]" in line:
                out[pending_key] = re.findall(r'"([^"]*)"', pending_buf)
                pending_key = None
            continue
        if not line.strip():
            continue
        if line.strip().startswith("["):
            in_section = line.strip() == f"[{section}]"
            continue
        if not in_section:
            continue
        m = _LIST_RE.match(line)
        if m:
            out[m.group(1)] = re.findall(r'"([^"]*)"', m.group(2))
            continue
        m = re.match(r"^\s*([A-Za-z0-9_-]+)\s*=\s*\[(.*)$", line)
        if m:   # array opened but not closed on this line
            pending_key, pending_buf = m.group(1), m.group(2)
            continue
        m = _SCALAR_RE.match(line)
        if m:
            val = m.group(2).strip().strip('"')
            out[m.group(1)] = val
    return out


def load_config(start_dir):
    """The port's :class:`LintConfig` for a scan rooted at ``start_dir``:
    always its defaults.  No pyproject.toml is read (the repository's
    ``[tool.psrlint]`` is the JAX package's); ``start_dir`` is kept for the
    reference's signature."""
    return LintConfig()


def _matches(rel, patterns):
    return any(fnmatch.fnmatch(rel, pat) for pat in patterns)


def _package_anchor(root):
    """The directory rel paths are measured from: the TOPMOST package
    directory on ``root``'s ancestor chain (so ``psrsigsim_torch/models``
    and ``psrsigsim_torch/io/ephem.py`` lint with the same rel paths —
    ``models/...``, ``io/ephem.py`` — as a whole-package scan, keeping
    the device-module globs and baseline keys stable no matter which
    sub-path the CLI is pointed at).  A tree with no ``__init__.py``
    (fixture dirs) anchors at ``root`` itself."""
    d = root if os.path.isdir(root) else os.path.dirname(root)
    anchor = d
    while os.path.isfile(os.path.join(d, "__init__.py")):
        anchor = d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return anchor


def iter_source_files(root, config):
    """Yield (abspath, posix relpath) of lintable files under ``root``
    (a directory, or a single file).  Rel paths are anchored at the
    enclosing package root, not at ``root`` — see :func:`_package_anchor`."""
    root = os.path.abspath(root)
    anchor = _package_anchor(root)
    if os.path.isfile(root):
        rel = os.path.relpath(root, anchor).replace(os.sep, "/")
        # the single-file form honors the same include/exclude globs as
        # the directory walk — an excluded file must not lint (or
        # ratchet) through the side door
        if _matches(rel, config.include) and not _matches(rel,
                                                          config.exclude):
            yield root, rel
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, anchor).replace(os.sep, "/")
            if not _matches(rel, config.include):
                continue
            if _matches(rel, config.exclude):
                continue
            yield path, rel


# -- suppression -------------------------------------------------------------

_DISABLE_RE = re.compile(r"#\s*psrlint:\s*disable=([A-Z0-9, ]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*psrlint:\s*disable-file=([A-Z0-9, ]+)")


def _suppressions(src):
    """Per-line and per-file rule suppressions from magic comments."""
    by_line = {}
    whole_file = set()
    for i, line in enumerate(src.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m:
            by_line[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        m = _DISABLE_FILE_RE.search(line)
        if m:
            whole_file |= {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
    return by_line, whole_file


def _suppressed(finding, by_line, whole_file):
    if finding.rule in whole_file:
        return True
    for line in (finding.line, finding.func_line):
        rules = by_line.get(line)
        if rules and (finding.rule in rules or "ALL" in rules):
            return True
    return False


# -- mesh axis discovery -----------------------------------------------------

def discover_mesh_axes(root, config):
    """Axis names the mesh defines: string constants assigned to
    ``*_AXIS`` names at module level of ``parallel/mesh.py`` (the single
    source of truth for the 2-D ensemble mesh), plus config extras."""
    if config.mesh_axes:
        return set(config.mesh_axes) | set(config.mesh_axes_extra)
    axes = set(config.mesh_axes_extra)
    mesh_py = os.path.join(_package_anchor(os.path.abspath(root)),
                           "parallel", "mesh.py")
    if os.path.isfile(mesh_py):
        with open(mesh_py, encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                return axes
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.endswith("_AXIS")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                axes.add(node.value.value)
    return axes


# -- baseline ratchet --------------------------------------------------------

def load_baseline(path):
    """Read ``rule<TAB>path<TAB>count`` lines -> {(rule, path): count}."""
    counts = {}
    if not path or not os.path.isfile(path):
        return counts
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 3:
                continue
            try:
                counts[(parts[0], parts[1])] = int(parts[2])
            except ValueError:   # hand-edited/merge-conflicted count
                continue
    return counts


def write_baseline(path, findings, preserve=None):
    """Write the ratchet file from ``findings``.

    ``preserve``: entries from a previous baseline to carry over
    verbatim — the CLI passes every entry for files OUTSIDE the scanned
    scope, so ``--write-baseline`` on a sub-path re-ratchets only what
    was actually linted instead of silently discarding the rest."""
    counts = dict(preserve or {})
    for f in findings:
        counts[(f.rule, f.path)] = counts.get((f.rule, f.path), 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# psrlint baseline: rule<TAB>file<TAB>count ratchet.\n"
                 "# Regenerate with: python -m psrsigsim_torch.analysis "
                 "--write-baseline\n")
        for (rule, rel), n in sorted(counts.items()):
            fh.write(f"{rule}\t{rel}\t{n}\n")


def baseline_regressions(findings, baseline):
    """Findings in (rule, file) buckets whose count EXCEEDS the baseline.

    The whole bucket is reported when it regresses — a count ratchet
    cannot tell old findings from new, and showing every candidate beats
    guessing wrong."""
    buckets = {}
    for f in findings:
        buckets.setdefault((f.rule, f.path), []).append(f)
    regressions = []
    for key, items in sorted(buckets.items()):
        if len(items) > baseline.get(key, 0):
            regressions.extend(items)
    return regressions


# -- driver ------------------------------------------------------------------

@dataclass
class ModuleContext:
    """Everything a checker may need about one source file."""

    path: str          # absolute
    rel: str           # posix relpath from scan root
    src: str
    tree: ast.AST
    config: LintConfig
    mesh_axes: set = field(default_factory=set)
    # per-module scratch shared across checkers (resolver, reachability —
    # built once, read six times)
    cache: dict = field(default_factory=dict)

    def in_device_modules(self):
        return _matches(self.rel, self.config.device_modules)

    def assume_jitted(self):
        return _matches(self.rel, self.config.assume_jitted)


def run_lint(root, config=None, checkers=None, files=None):
    """Lint every source file under ``root``; returns sorted findings
    (suppressions applied, baseline NOT applied — the caller compares).

    ``files``: optional pre-computed ``(abspath, rel)`` pairs to lint
    instead of walking ``root`` — the CLI passes only the not-yet-seen
    files of each root so overlapping roots don't pay a double parse."""
    from .checkers import default_checkers

    config = config if config is not None else load_config(root)
    checkers = default_checkers() if checkers is None else checkers
    mesh_axes = discover_mesh_axes(root, config)
    findings = []
    pairs = iter_source_files(root, config) if files is None else files
    for path, rel in pairs:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as err:
            findings.append(Finding(rel, err.lineno or 1, 0, "PSR100",
                                    f"syntax error: {err.msg}", "error"))
            continue
        ctx = ModuleContext(path=path, rel=rel, src=src, tree=tree,
                            config=config, mesh_axes=mesh_axes)
        by_line, whole_file = _suppressions(src)
        for checker in checkers:
            for finding in checker.check(ctx):
                if not _suppressed(finding, by_line, whole_file):
                    findings.append(finding)
    return sorted(findings, key=Finding.sort_key)
