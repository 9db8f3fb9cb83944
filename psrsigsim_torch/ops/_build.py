"""nvcc builds of the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled with the same flags into a shared
library with a plain C interface, ``build/<name>-<hash>.so``, loaded with
ctypes.  The hash covers the flags, the source and the shared headers
(``csrc/*.cuh``), so an edit rebuilds and an unchanged tree reuses the
library.  Nothing is compiled at import; :func:`library` builds at first
use, :func:`build_all` starts one nvcc per kernel at once and waits for
all.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build_all", "library", "count_launch"]

KERNELS = ("rng_field", "fold_quantize", "packed_digest", "gamma_field",
           "scenario_draws", "envelope_shift")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_PKG_DIR = Path(__file__).resolve().parents[1]
_CSRC = _PKG_DIR / "csrc"
# the checkout's build/ (ignored by git); an installed package, with no
# checkout around it, builds beside its own sources instead
_BUILD_DIR = (_PKG_DIR.parent / "build"
              if (_PKG_DIR.parent / "pyproject.toml").exists()
              else _PKG_DIR / "build")

_LIBS = {}
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper):
    """Add one to ``wrapper.launches``, the kernel's launch count, under a
    lock: the serving layer launches from its batcher thread while another
    thread may reset or read the counts."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name):
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; the port has {KERNELS}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name, so):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.stem}-{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return cmd, tmp, proc


def _finish(name, so, started):
    cmd, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}: "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return log


def _load(name, so, log):
    lib = ctypes.CDLL(str(so))
    lib.build_log = log
    _LIBS[name] = lib
    return lib


def build_all(names=KERNELS):
    """Build every kernel in ``names`` that is not built yet, one nvcc
    each, all started together; returns ``{name: library}``.  After a fresh
    compile ``lib.build_log`` holds nvcc's output (ptxas registers and
    spills), else it is empty."""
    pending = {}
    for name in names:
        if name in _LIBS:
            continue
        so = _target(name)
        pending[name] = (so, None if so.exists() else _start(name, so))
    errors = []
    for name, (so, started) in pending.items():
        try:
            log = "" if started is None else _finish(name, so, started)
        except RuntimeError as err:  # finish the others, then report all
            errors.append(str(err))
            continue
        _load(name, so, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _LIBS[name] for name in names}


def library(name):
    """The ctypes library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all((name,))[name]
