"""psrsigsim_torch — the PyTorch/CUDA port of psrsigsim_tpu.

The same pulsar-signal simulator, written in PyTorch for one NVIDIA H100:
the reference's object-oriented flow (``Pulsar.make_pulses`` →
``ISM().disperse`` → ``Telescope.observe``, with the signal's data a tensor
on its device) and the ``Simulation`` façade; and for ensembles,
configuration objects (signal, pulsar, telescope) stage a fold-mode
geometry that plain tensor functions with an explicit ``device`` run.  The JAX package ``psrsigsim_tpu`` stays
beside it as the reference; module paths mirror it so each counterpart is
easy to find.  The port imports neither jax nor the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The random-field sampler is a hand-written CUDA kernel
(``csrc/rng_field.cu``, bound in :mod:`psrsigsim_torch.ops.rng_hw`);
port-specific stream changes are listed in ``DIVERGENCES.md`` beside this
file.
"""

from . import utils  # noqa: F401

__version__ = "0.1.0"

__all__ = ["utils", "__version__"]


def __getattr__(name):
    # lazy submodule access keeps `import psrsigsim_torch` light (torch and
    # the card load only with the submodules that need them)
    import importlib

    if name in ("signal", "pulsar", "models", "ops", "ism", "telescope",
                "simulate", "io", "parallel", "data", "runtime", "mc"):
        try:
            return importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as err:
            # keep hasattr()/getattr(default) semantics intact
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}"
            ) from err
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
