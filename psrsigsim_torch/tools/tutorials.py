"""Run the port's executable tutorials (docs/torch/tutorial_*.md).

A tutorial's ```python blocks run in order, in one namespace, with
``DEVICE`` seeded into it before block 0 and from a working directory the
caller gives.  A block that raises, or that emits a numeric
RuntimeWarning (overflow, invalid value, divide by zero), fails the
tutorial.  tests/test_torch_docs.py runs every tutorial through
:func:`run_tutorial` on the CPU and chip_smoke.py phase 23 on the card,
so the two gates cannot drift apart.
"""

import os
import re
import warnings

__all__ = ["blocks", "number", "run_tutorial"]

_BLOCK_RE = re.compile(r"```python\n(.*?)```", re.DOTALL)
_NUM_RE = re.compile(r"tutorial_(\d+)_")
_NUMERIC = ("overflow", "invalid value", "divide by zero")


def blocks(path):
    """The source of each ```python block of the markdown file at ``path``."""
    with open(path) as f:
        return _BLOCK_RE.findall(f.read())


def number(path):
    """A tutorial's number, from its file name."""
    return int(_NUM_RE.search(os.path.basename(path)).group(1))


def run_tutorial(path, device, workdir):
    """Run every block of the tutorial at ``path`` with ``DEVICE = device``,
    from ``workdir`` (the caller's directory is restored afterwards);
    returns the number of blocks.  Raises AssertionError naming the block
    that failed or warned."""
    name = os.path.basename(path)
    srcs = blocks(path)
    if not srcs:
        raise AssertionError(f"{name} has no python blocks")
    ns = {"__file__": os.path.abspath(path), "__name__": "__tutorial__",
          "DEVICE": device}
    here = os.getcwd()
    os.chdir(workdir)
    try:
        for i, src in enumerate(srcs):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    exec(compile(src, f"{name}[block {i}]", "exec"), ns)
                except Exception as err:
                    raise AssertionError(
                        f"{name} block {i} failed: {err}\n{src}") from err
            # numeric RuntimeWarnings in a parity path can mask a real
            # divergence (the scipy PCHIP overflow used to fire here); the
            # benign intermediates are silenced at source (ops/interp.py),
            # so any numeric warning that still surfaces is a regression
            numeric = [str(w.message) for w in caught
                       if issubclass(w.category, RuntimeWarning)
                       and any(s in str(w.message) for s in _NUMERIC)]
            if numeric:
                raise AssertionError(f"{name} block {i} emitted numeric "
                                     f"RuntimeWarning(s): {numeric}")
    finally:
        os.chdir(here)
    return len(srcs)
