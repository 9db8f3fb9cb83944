"""psrlint on the port: fixture tests per rule, the CI gate, and the probe
(counterpart: tests/test_psrlint.py, one case for each of its 36, class by
class, on PyTorch fixtures).

Each rule gets a positive fixture (the bug pattern MUST be flagged) and a
negative one (the sanctioned idiom MUST NOT be).  Where a rule means what
it meant in the JAX package (PSR100, PSR105, PSR106, suppression, the
ratchet, the TOML reader, package-relative paths), the same fixture also
runs through the reference's linter, in a child process (this file run as
a script, with the R1/R2 shims of tests/test_torch_toa.py), and the
findings must be equal: path, line, column and rule.  The gate at the
bottom is the CI wiring: ``psrsigsim_torch/`` must lint clean against its
own ``analysis/baseline.txt``, with or without this repository's
pyproject.toml (whose ``[tool.psrlint]`` is the JAX package's), and every
public ``ops`` symbol must pass the device probe (here on the CPU; on the
card under sync-debug "error", chip_smoke.py phase 22).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_toa import child_env, shims  # noqa: E402

ROOT = os.path.dirname(HERE)
PKG_DIR = os.path.join(ROOT, "psrsigsim_torch")
BASELINE = os.path.join(PKG_DIR, "analysis", "baseline.txt")

# fixtures lint against a fixed config so they do not depend on the
# package's defaults: fixture modules live under ops/ (device scope)
FIX = {"device_modules": ["ops/*"], "assume_jitted": ["ops/*"],
       "mesh_axes": ["obs", "chan"]}


def _src(text):
    return textwrap.dedent(text)


# -- fixtures whose rule means what it means in the JAX package --------------

PARITY = {
    "psr100": {"ops/fixture.py": "def f(:\n    return 1\n"},
    "psr105_pos": {"host/fixture.py": _src("""
        _ACTIVE_KERNEL = None

        def set_kernel(path):
            global _ACTIVE_KERNEL
            _ACTIVE_KERNEL = path
    """)},
    "psr105_neg": {"host/fixture.py": _src("""
        _TABLE = {"a": 1}

        def lookup(k):
            return _TABLE[k]

        class Holder:
            def set(self, v):
                self.v = v          # instance state is fine
    """)},
    "psr106_pos": {"parallel/fixture.py": _src("""
        from jax.sharding import PartitionSpec as P

        SPEC = P("obs", "epoch")
    """)},
    "psr106_neg": {"parallel/fixture.py": _src("""
        from jax.sharding import Mesh, PartitionSpec as P

        SPEC = P("obs", "chan")
        NONE_SPEC = P(None, "chan")

        def build(devs):
            return Mesh(devs, ("obs", "chan"))   # definitions, not uses
    """)},
    "suppress_line": {"parallel/fixture.py": _src("""
        from jax.sharding import PartitionSpec as P

        SPEC = P("obs", "epoch")  # psrlint: disable=PSR106
        OTHER = P("obs", "time")
    """)},
    "suppress_def": {"host/fixture.py": _src("""
        _STATE = None
        _OTHER = None

        def set_state(v):  # psrlint: disable=PSR105
            global _STATE
            _STATE = v

        def set_other(v):
            global _OTHER
            _OTHER = v
    """)},
    "ratchet": {"host/fixture.py": _src("""
        _A = None
        _B = None

        def f(v):
            global _A
            _A = v

        def g(v):
            global _B
            _B = v
    """)},
    # package-relative paths: a sub-path or a single file lints with the
    # rel paths of a whole-package scan (the "root" entry names the path)
    "subpath": {"pkg/__init__.py": "",
                "pkg/models/__init__.py": "",
                "pkg/models/state.py": _src("""
                    _X = 0

                    def bump():
                        global _X
                        _X = 1
                """),
                "pkg/io/__init__.py": "",
                "pkg/io/ephem.py": _src("""
                    _K = None

                    def load(k):
                        global _K
                        _K = k
                """),
                "root": ["pkg/models", "pkg/io/ephem.py", "pkg"]},
}
RATCHET_BASELINES = [2, 1, 0]
TOML_CASES = [
    ('[tool.other]\nx = 1\n[tool.psrlint]\n'
     'include = ["*.py", "b.py"]\nbaseline = "b.txt"\n[tool.next]\n'
     'include = ["nope"]\n'),
    ('[tool.psrlint]\ninclude = [\n  "*.py",\n  "b.py",\n]\n'
     'exclude = ["x/*"]\n'),
]


def _write_case(root, files):
    for rel, text in files.items():
        if rel == "root":
            continue
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return [os.path.join(root, r) for r in files.get("root", [""])]


def _lint_cases(analysis, core, base):
    """Findings (and the ratchet's and the TOML reader's answers) of one
    linter package over every parity fixture, as JSON-able lists."""
    out = {}
    for name, files in PARITY.items():
        root = os.path.join(base, name)
        roots = _write_case(root, files)
        cfg = analysis.LintConfig(**{k: tuple(v) for k, v in FIX.items()})
        out[name] = [[list(f.sort_key()) for f in analysis.run_lint(r, cfg)]
                     for r in roots]
        if name == "ratchet":
            found = analysis.run_lint(root, cfg)
            key = ("PSR105", "host/fixture.py")
            out["ratchet_regressions"] = [
                len(analysis.baseline_regressions(found, {key: n} if n
                                                  else {}))
                for n in RATCHET_BASELINES]
    out["toml"] = [core._parse_toml_section(text, "tool.psrlint")
                   for text in TOML_CASES]
    return out


def _child(out):
    shims()
    import psrsigsim_tpu.analysis as analysis
    from psrsigsim_tpu.analysis import core

    res = _lint_cases(analysis, core, os.path.join(out, "cases"))
    with open(os.path.join(out, "ref.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_psrlint")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=child_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ref.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    import psrsigsim_torch.analysis as analysis
    from psrsigsim_torch.analysis import core

    # through JSON, as the reference's answers come: tuples become lists
    return json.loads(json.dumps(_lint_cases(
        analysis, core, str(tmp_path_factory.mktemp("port_cases")))))


def lint_src(tmp_path, src, name="ops/fixture.py", config=None):
    from psrsigsim_torch.analysis import LintConfig, run_lint

    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_src(src))
    cfg = config or LintConfig(**{k: tuple(v) for k, v in FIX.items()})
    return run_lint(str(tmp_path), config=cfg)


def rules_of(findings):
    return {f.rule for f in findings}


def rules_in(case):
    return {f[3] for root in case for f in root}


class TestTraceSafetyRule:
    def test_positive_branch_on_tensor(self, tmp_path):
        findings = lint_src(tmp_path, """
            import torch

            @torch.compile
            def f(x):
                y = torch.sum(x)
                if y > 0:
                    return y
                return -y
        """, name="host/fixture.py")
        [f] = [f for f in findings if f.rule == "PSR101"]
        assert f.line == 7

    def test_positive_transitive_derivation(self, tmp_path):
        # the tensor flows through intermediate assignments whatever the
        # AST walk order: b is a tensor because a is
        findings = lint_src(tmp_path, """
            import torch

            def f(x):
                a = torch.zeros(3, device=x.device) + x
                b = a + 1
                if b[0] > 0:
                    return b
                ok = b.all() and a.any()
                return a if ok else b
        """)
        assert [f.line for f in findings if f.rule == "PSR101"] == [7, 9, 10]

    def test_positive_coercion_and_host_transfer(self, tmp_path):
        findings = lint_src(tmp_path, """
            import torch

            def f(x: torch.Tensor):
                m = float(torch.max(x))
                n = x.sum().item()
                h = x.cpu()
                return m + n + h.numpy()[0] + len(x.tolist())
        """)
        assert [f.line for f in findings if f.rule == "PSR101"] == [
            5, 6, 7, 8]

    def test_negative_metadata_none_and_host_values(self, tmp_path):
        findings = lint_src(tmp_path, """
            import torch

            def f(x: torch.Tensor, mask=None):
                y = torch.as_tensor(x)
                if y.shape[-1] == 2 and y.device.type == "cuda":  # metadata
                    y = y * 2.0
                if mask is None:                   # identity check
                    mask = torch.ones_like(y)
                if isinstance(x, int):             # type dispatch
                    return y
                if y.numel() > 4:                  # host metadata call
                    y = y[:4]
                scale = float(torch.tensor(2.0))   # a host tensor
                return y * mask * scale
        """)
        assert "PSR101" not in rules_of(findings)

    def test_negative_unreachable_function(self, tmp_path):
        # a plain host helper (no staging site, no assume_jitted scope)
        # may wait for the card
        findings = lint_src(tmp_path, """
            import torch

            def host_helper(x):
                y = torch.sum(x)
                if y > 0:
                    return y.item()
                return -y
        """, name="host/fixture.py")
        assert "PSR101" not in rules_of(findings)


class TestHostNumpyRule:
    def test_positive_np_on_tensor_in_op(self, tmp_path):
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            def f(x: torch.Tensor):
                return np.fft.rfft(x)

            def g(x):
                y = torch.exp(x)
                return np.sum(y)
        """)
        assert [f.line for f in findings if f.rule == "PSR102"] == [6, 10]

    def test_negative_concrete_guard_and_allowlist(self, tmp_path):
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            def _is_concrete(x):
                return True

            def f(x: torch.Tensor, dm):
                nd = np.ndim(x)                 # allowlisted metadata
                if _is_concrete(x):
                    return np.fft.rfft(x)       # host branch by contract
                if not isinstance(dm, torch.Tensor):
                    dm = torch.as_tensor(np.float32(dm))   # host branch
                ramp = np.arange(8, dtype=np.float32)      # host values
                return x + nd + dm + torch.from_numpy(ramp)
        """)
        assert "PSR102" not in rules_of(findings)

    def test_negative_outside_device_modules(self, tmp_path):
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            def f(x: torch.Tensor):
                return np.fft.rfft(x)
        """, name="io/fixture.py")
        assert "PSR102" not in rules_of(findings)


class TestRngReuseRule:
    def test_positive_key_reused_by_two_sinks(self, tmp_path):
        findings = lint_src(tmp_path, """
            from psrsigsim_torch.ops.stats import chi2_sample, normal_sample

            def f(key):
                a = normal_sample(key, (3,))
                b = chi2_sample(key, 4.0, (3,))
                return a + b
        """)
        [f] = [f for f in findings if f.rule == "PSR103"]
        assert f.line == 6

    def test_positive_loop_invariant_key(self, tmp_path):
        # the same key drawn every iteration draws identical numbers
        findings = lint_src(tmp_path, """
            from psrsigsim_torch.utils import rng

            def f(key):
                out = []
                for _ in range(4):
                    out.append(rng.random_bits(key, 2))
                return out
        """)
        assert "PSR103" in rules_of(findings)

    def test_negative_split_and_fold_in(self, tmp_path):
        findings = lint_src(tmp_path, """
            from psrsigsim_torch.ops.stats import normal_sample
            from psrsigsim_torch.utils.rng import fold_in, random_bits, split

            def f(key):
                k = split(key)
                a = normal_sample(k[0], (3,))
                b = random_bits(k[1], 3)
                return a + b

            def g(root):
                # repeated DERIVATION from one root is the stage_key idiom
                ka = fold_in(root, 0)
                kb = fold_in(root, 1)
                return normal_sample(ka, ()) + normal_sample(kb, ())
        """)
        assert "PSR103" not in rules_of(findings)

    def test_negative_exclusive_branches(self, tmp_path):
        # one sink per control-flow path is fine (ops/stats.py routing)
        findings = lint_src(tmp_path, """
            from psrsigsim_torch.ops.stats import chi2_sample, normal_sample

            def f(key, small):
                if small:
                    return normal_sample(key, (2,))
                return chi2_sample(key, 4.0, (2,))
        """)
        assert "PSR103" not in rules_of(findings)


class TestDtypeRule:
    def test_positive_float64_and_implicit_dtype(self, tmp_path):
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            def f(x, host):
                y = torch.as_tensor(x, dtype=torch.float64)
                z = torch.from_numpy(np.linspace(0.0, 1.0, 5))
                w = torch.tensor(host, device="cuda")
                v = torch.zeros(3, dtype=float)
                return y + z + w.double() + v
        """)
        hits = [f for f in findings if f.rule == "PSR104"]
        assert sorted({f.line for f in hits}) == [6, 7, 8, 9, 10]

    def test_negative_explicit_f32(self, tmp_path):
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            _F32 = torch.float32

            def f(x, host, n):
                y = torch.as_tensor(x, dtype=torch.float32)
                z = torch.from_numpy(np.linspace(0.0, 1.0, 5)).float()
                w = torch.as_tensor(np.asarray(host, np.float32))
                v = torch.tensor([n, 2], device="cuda")
                u = torch.as_tensor(host).to(_F32)
                h = np.zeros(3, dtype=float)       # host float64 is fine
                return y + z + w + v + u + torch.from_numpy(h).float()
        """)
        assert "PSR104" not in rules_of(findings)


class TestGlobalStateRule:
    def test_positive_ephemeris_bug_pattern(self, ref, port):
        # the shape of the simulate.py / io/ephem.py bug: a process-global
        # switch rebound from an API entry point
        assert "PSR105" in rules_in(port["psr105_pos"])
        assert port["psr105_pos"] == ref["psr105_pos"]

    def test_negative_read_only_global(self, ref, port):
        assert "PSR105" not in rules_in(port["psr105_neg"])
        assert port["psr105_neg"] == ref["psr105_neg"]


class TestShardingAxesRule:
    def test_positive_phantom_axis(self, tmp_path, ref, port):
        assert port["psr106_pos"] == ref["psr106_pos"]
        assert rules_in(port["psr106_pos"]) == {"PSR106"}
        # the port's own lookups: ``mesh.shape[...]`` and ``axis_names``
        findings = lint_src(tmp_path, """
            def width(mesh, sub_mesh):
                n = mesh.shape["obs"] * sub_mesh.shape["epoch"]
                if "time" in mesh.axis_names:
                    return n
                return n * mesh.shape["chan"]
        """, name="parallel/fixture.py")
        msgs = [f.message for f in findings if f.rule == "PSR106"]
        assert len(msgs) == 2
        assert "'epoch'" in msgs[0] and "'time'" in msgs[1]

    def test_negative_known_axes(self, ref, port):
        assert port["psr106_neg"] == ref["psr106_neg"]
        assert "PSR106" not in rules_in(port["psr106_neg"])


class TestSuppressionAndBaseline:
    def test_line_suppression(self, tmp_path, ref, port):
        assert port["suppress_line"] == ref["suppress_line"]
        [[hit]] = port["suppress_line"]
        assert hit[3] == "PSR106" and hit[1] == 5
        findings = lint_src(tmp_path, """
            import torch

            def f(x):
                return torch.as_tensor(x, dtype=torch.float64)  # psrlint: disable=PSR104
        """)
        assert "PSR104" not in rules_of(findings)

    def test_def_line_suppression_covers_body(self, tmp_path, ref, port):
        assert port["suppress_def"] == ref["suppress_def"]
        [[hit]] = port["suppress_def"]
        assert hit[3] == "PSR105" and hit[1] == 9
        findings = lint_src(tmp_path, """
            import numpy as np
            import torch

            def host_fn(x: torch.Tensor):  # psrlint: disable=PSR102
                a = np.fft.rfft(x)
                return np.fft.irfft(a)
        """)
        assert "PSR102" not in rules_of(findings)

    def test_baseline_is_a_ratchet(self, ref, port):
        # two findings in one (rule, file) bucket: covered at 2, the whole
        # bucket regressed below
        [found] = port["ratchet"]
        assert [f[3] for f in found] == ["PSR105", "PSR105"]
        assert port["ratchet_regressions"] == [0, 2, 2]
        assert port["ratchet"] == ref["ratchet"]
        assert port["ratchet_regressions"] == ref["ratchet_regressions"]

    def test_toml_section_parser(self, ref, port):
        assert port["toml"][0] == {"include": ["*.py", "b.py"],
                                   "baseline": "b.txt"}
        assert port["toml"][0] == ref["toml"][0]

    def test_toml_parser_multiline_arrays(self, ref, port):
        # toml formatters spread arrays across lines; mis-parsing one as
        # a scalar once disabled the whole gate (include == "[")
        assert port["toml"][1] == {"include": ["*.py", "b.py"],
                                   "exclude": ["x/*"]}
        assert port["toml"][1] == ref["toml"][1]

    def test_subpath_scan_keeps_package_relative_paths(self, ref, port):
        # pointing the linter at a SUB-path produces the rel paths (and
        # so the rule scoping and baseline keys) of a whole-package scan
        assert port["subpath"] == ref["subpath"]
        sub, one, full = port["subpath"]
        assert {f[0] for f in sub} == {"models/state.py"}
        assert {f[0] for f in one} == {"io/ephem.py"}
        assert sorted(sub + one) == sorted(full)
        from psrsigsim_torch.analysis import run_lint

        models = run_lint(os.path.join(PKG_DIR, "models"))
        whole = [f for f in run_lint(PKG_DIR)
                 if f.path.startswith("models/")]
        assert [f.sort_key() for f in models] == [f.sort_key() for f in whole]


class TestPackageGate:
    """The actual CI gate, collected by the ordinary tier-1 run."""

    def test_package_lints_clean_against_baseline(self):
        from psrsigsim_torch.analysis import (baseline_regressions,
                                              load_baseline, run_lint)

        findings = run_lint(PKG_DIR)
        regressions = baseline_regressions(findings, load_baseline(BASELINE))
        assert regressions == [], (
            "psrlint regressions (fix, suppress inline with a reason, or "
            "consciously ratchet via python -m psrsigsim_torch.analysis "
            "--write-baseline):\n"
            + "\n".join(f.format() for f in regressions))

    def test_gate_identical_with_and_without_the_repo_pyproject(
            self, tmp_path):
        # the repo's pyproject.toml holds the JAX package's [tool.psrlint]:
        # the port's gate must give the same findings in this checkout, in
        # a copy of the package with no pyproject above it, and under a
        # pyproject whose [tool.psrlint] would exclude everything
        from psrsigsim_torch.analysis import LintConfig, load_config, run_lint

        assert os.path.isfile(os.path.join(ROOT, "pyproject.toml"))
        here = [f.sort_key() for f in run_lint(PKG_DIR,
                                               config=load_config(PKG_DIR))]
        assert here == [f.sort_key()
                        for f in run_lint(PKG_DIR, config=LintConfig())]
        copy = tmp_path / "psrsigsim_torch"
        shutil.copytree(PKG_DIR, copy, ignore=shutil.ignore_patterns(
            "__pycache__", "*.so", "*.cu", "*.cuh", "*.npy", "*.par"))
        assert [f.sort_key() for f in run_lint(str(copy))] == here
        (tmp_path / "pyproject.toml").write_text(
            '[tool.psrlint]\nexclude = ["*"]\n')
        assert [f.sort_key() for f in run_lint(str(copy))] == here

    def test_every_rule_and_baseline_entry_documented(self):
        from psrsigsim_torch.analysis import RULES, load_baseline

        with open(os.path.join(ROOT, "docs", "torch",
                               "static_analysis.md")) as f:
            text = f.read()
        for rule in RULES:
            assert rule in text, f"{rule} missing from the port's catalog"
        for rule, rel in load_baseline(BASELINE):
            assert f"| {rule} | `{rel}` |" in text, (
                f"baseline entry {rule} {rel} has no reason in "
                "docs/torch/static_analysis.md")

    def test_cli_entry_point(self, capsys, monkeypatch):
        import torch

        from psrsigsim_torch.analysis import RULES
        from psrsigsim_torch.analysis.__main__ import main

        assert main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in RULES:
            assert rule in out
        assert main([PKG_DIR, "-q"]) == 0
        # the probe runs on the host only when asked: its default is the
        # card, which raises where there is none
        assert main([PKG_DIR, "-q", "--trace-check", "--device", "cpu"]) == 0
        assert "trace-check on cpu" in capsys.readouterr().out
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([PKG_DIR, "-q", "--trace-check"])

    def test_overlapping_paths_lint_once(self):
        # `psrlint pkg pkg/models` must not double-count models/* findings
        # into phantom baseline regressions
        from psrsigsim_torch.analysis.__main__ import main

        assert main([PKG_DIR, os.path.join(PKG_DIR, "models"), "-q"]) == 0

    def test_single_file_honors_exclude_globs(self):
        # analysis/* and tools/* are excluded; pointing the linter at one
        # of their files directly must not lint it through the side door
        from psrsigsim_torch.analysis import load_config, run_lint

        for rel in (("analysis", "checkers.py"), ("tools", "k3_study.py")):
            target = os.path.join(PKG_DIR, *rel)
            assert run_lint(target, config=load_config(target)) == []

    def test_subpath_write_baseline_preserves_out_of_scope(self, tmp_path):
        # --write-baseline on a sub-path must not discard ratchet entries
        # for files it did not lint
        from psrsigsim_torch.analysis import load_baseline
        from psrsigsim_torch.analysis.__main__ import main

        bl = tmp_path / "bl.txt"
        assert main([PKG_DIR, "--baseline", str(bl),
                     "--write-baseline"]) == 0
        full = load_baseline(str(bl))
        assert full == load_baseline(BASELINE)
        assert main([os.path.join(PKG_DIR, "models"), "--baseline", str(bl),
                     "--write-baseline"]) == 0
        assert load_baseline(str(bl)) == full
        # and the full gate still passes against the rewritten file
        assert main([PKG_DIR, "--baseline", str(bl), "-q"]) == 0


class TestTraceProbe:
    def test_probe_covers_every_public_op(self):
        from psrsigsim_torch import ops
        from psrsigsim_torch.analysis import EXEMPT, probe_specs
        from psrsigsim_torch.analysis.trace_check import HOST_RESULTS, SYNCS

        specs = probe_specs("cpu")
        uncovered = [n for n in ops.__all__
                     if n not in specs and n not in EXEMPT]
        assert uncovered == [], (
            f"public ops with no probe and no exemption: {uncovered}")
        # the tables must not rot: every entry names a live public symbol
        # (or a program probe), and nothing is both probed and exempt
        assert [n for n in EXEMPT if n not in ops.__all__] == []
        assert [n for n in specs if n not in ops.__all__] == []
        assert not set(EXEMPT) & set(specs)
        assert [n for n in SYNCS if n not in specs and n not in (
            "serve_width_bucket", "dataset_record")] == []
        # a probe declared to return host tensors waits for the card by
        # construction, so it must say why in SYNCS
        assert HOST_RESULTS <= set(SYNCS) and HOST_RESULTS <= set(specs)

    def test_all_ops_probe_clean(self):
        from psrsigsim_torch import ops
        from psrsigsim_torch.analysis import run_trace_check

        results = run_trace_check(device="cpu")
        assert [r.name for r in results] == list(ops.__all__)
        assert all(r.status in ("ok", "exempt", "sync") for r in results)

    def test_probe_table_defaults_to_the_card(self, monkeypatch):
        # like every entry point of the port, the probe table is built on
        # the card unless the caller asks for the host
        import torch

        from psrsigsim_torch.analysis import probe_specs

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_specs()

    def test_probe_rejects_uncovered_symbol(self):
        from psrsigsim_torch.analysis import run_trace_check

        with pytest.raises(AssertionError, match="no probe"):
            run_trace_check(["definitely_not_an_op"], device="cpu")

    def test_serve_bucket_programs_probe_clean(self):
        """The serving layer's width-bucketed batch programs run on the
        device and return their declared shape at every probed bucket
        width (on the card, without waiting for it)."""
        from psrsigsim_torch.analysis.trace_check import run_serve_trace_check

        results = run_serve_trace_check(widths=(1, 8), device="cpu")
        assert [r.name for r in results] == ["serve_width_bucket[w=1]",
                                             "serve_width_bucket[w=8]"]
        assert all(r.status in ("ok", "sync") for r in results)

    def test_dataset_record_program_probes_clean(self):
        """The dataset factory's labeled-record chunk (prior draws on the
        "dataset" stage + SEARCH scenario hooks + registry truth labels)
        runs on the device with every field as ``field_layout`` declares
        it."""
        from psrsigsim_torch.analysis.trace_check import (
            run_dataset_trace_check)

        results = run_dataset_trace_check(device="cpu")
        assert [r.name for r in results] == ["dataset_record"]
        assert results[0].status in ("ok", "sync")

    def test_ensemble_main_path_probes_clean(self):
        """The main path's steady call, ``FoldEnsemble.run_quantized``, on
        the ensemble's device at its own geometry: int16 codes, float32
        scale and offset of the declared shapes."""
        from test_torch_pipeline import _geometry

        from psrsigsim_torch.analysis.trace_check import (
            run_ensemble_trace_check)
        from psrsigsim_torch.parallel import FoldEnsemble

        ens = FoldEnsemble(*_geometry("psrsigsim_torch", "readme16"),
                           device="cpu")
        results = run_ensemble_trace_check(ens, 3)
        assert [r.name for r in results] == ["ensemble_run_quantized"]
        assert results[0].status in ("ok", "sync")


def test_reference_parity_cases(ref, port):
    """Every parity fixture (PSR100's unparsable file among them) gives
    the reference's findings: path, line, column and rule."""
    assert port["psr100"] == ref["psr100"]
    assert rules_in(port["psr100"]) == {"PSR100"}
    assert set(port) == set(ref)
    for name in port:
        assert port[name] == ref[name], name


if __name__ == "__main__":
    _child(sys.argv[1])
