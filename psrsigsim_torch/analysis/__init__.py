"""psrlint on the port: static + dynamic correctness gates for the card
(counterpart: psrsigsim_tpu/analysis/).

The tier-1 CPU suite proves numerics; it cannot prove that the hot path
never makes the host wait for the card — Python branching on device
tensors, ``.item()``/``.cpu()`` round-trips, host ``np.`` calls on
tensors, reused threefry keys, float64 leaks, process-global state and
phantom mesh axes all pass CPU tests and then stall or corrupt the real
workload on the card.  This package gates those classes in CI:

* :func:`run_lint` / ``python -m psrsigsim_torch.analysis`` — AST checkers
  with the JAX package's rule IDs (``PSR100``-``PSR106``) re-cast for
  tensors, inline suppression (``# psrlint: disable=RULE``), and a
  per-(rule, file) count-ratchet baseline (``analysis/baseline.txt``).
* :func:`run_trace_check` — runs every public ``ops`` symbol on canonical
  small shapes on a device and checks each result's shape, dtype and
  device; on the card under ``torch.cuda.set_sync_debug_mode("error")``,
  so a host round-trip the linter missed raises.

See docs/torch/static_analysis.md for the rule catalog and workflow.
"""

from .core import (Finding, LintConfig, RULES, baseline_regressions,
                   load_baseline, load_config, run_lint, write_baseline)
from .trace_check import EXEMPT, probe_specs, run_trace_check

__all__ = [
    "Finding",
    "LintConfig",
    "RULES",
    "run_lint",
    "load_config",
    "load_baseline",
    "write_baseline",
    "baseline_regressions",
    "run_trace_check",
    "probe_specs",
    "EXEMPT",
]
