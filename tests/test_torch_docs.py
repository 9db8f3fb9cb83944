"""Docs-as-tests for the port: execute every ```python block of
docs/torch/tutorial_*.md (counterpart: tests/test_docs.py).

Each tutorial runs in order, in one namespace per file, from a scratch
directory, with ``DEVICE = "cpu"`` seeded into the namespace before block
0: the port's entry points default to the card and raise without one, so
a block that forgets ``device=DEVICE`` fails here.  The runner, with its
numeric-RuntimeWarning gate, is ``psrsigsim_torch/tools/tutorials.py``;
``chip_smoke.py`` phase 23 runs the same blocks through it with
``DEVICE = "cuda"`` on the card.

Beyond running them, the tutorials are held to their JAX twins: one port
tutorial for each reference tutorial (paired by number), each with at
least as many ``python`` blocks and ``assert`` statements as its twin (a
tutorial may not get easier by losing checks), and no block importing
``jax`` or ``psrsigsim_tpu`` (an ``ast`` walk of each block: this worker
may hold jax from another test file, so running them proves nothing).
"""

import ast
import glob
import os

import pytest

from psrsigsim_torch.tools.tutorials import blocks as _blocks
from psrsigsim_torch.tools.tutorials import number as _number
from psrsigsim_torch.tools.tutorials import run_tutorial

DOCS_DIR = os.path.join(os.path.dirname(__file__), "..", "docs")
TUTORIALS = sorted(glob.glob(os.path.join(DOCS_DIR, "torch",
                                          "tutorial_*.md")))
REFERENCE = sorted(glob.glob(os.path.join(DOCS_DIR, "tutorial_*.md")))


def _asserts(blocks):
    return sum(isinstance(node, ast.Assert)
               for src in blocks for node in ast.walk(ast.parse(src)))


def _pairs():
    ref = {_number(p): p for p in REFERENCE}
    return [(p, ref.get(_number(p))) for p in TUTORIALS]


def test_one_port_tutorial_per_reference_tutorial():
    assert len(REFERENCE) == 12
    assert len(TUTORIALS) == len(REFERENCE) == 12
    assert sorted(_number(p) for p in TUTORIALS) == \
        sorted(_number(p) for p in REFERENCE)


@pytest.mark.parametrize("path, ref", _pairs(),
                         ids=[os.path.basename(p) for p in TUTORIALS])
def test_tutorial_keeps_its_twins_checks(path, ref):
    """At least the reference twin's blocks and asserts, counted from the
    reference file's text."""
    assert ref is not None, f"{path} has no reference twin"
    mine, theirs = _blocks(path), _blocks(ref)
    assert len(mine) >= len(theirs), (len(mine), len(theirs))
    assert _asserts(mine) >= _asserts(theirs), (_asserts(mine),
                                                _asserts(theirs))


@pytest.mark.parametrize(
    "path", TUTORIALS, ids=[os.path.basename(p) for p in TUTORIALS]
)
def test_tutorial_imports_neither_jax_nor_the_jax_package(path):
    for i, src in enumerate(_blocks(path)):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib",
                                                 "psrsigsim_tpu"), (
                    f"{os.path.basename(path)} block {i} imports {mod}")


@pytest.mark.parametrize(
    "path", TUTORIALS, ids=[os.path.basename(p) for p in TUTORIALS]
)
def test_tutorial_executes(path, tmp_path):
    # from a scratch dir so tutorials may write files / chdir freely
    assert run_tutorial(path, "cpu", str(tmp_path)) == len(_blocks(path))
