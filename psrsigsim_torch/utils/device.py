"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(``device="cpu"``, as the CPU tests do).  There is no quiet fallback: with
no card and no explicit device, they raise.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_device"]


def _init_host_vector_math():
    """Set up the host's vector math library before any parallel use.

    On the CPU, ATen evaluates float ``cos``/``sin``/``exp``/... through
    MKL's vector math (VML) in 2048-element blocks spread over the intra-op
    threads.  VML sets up its dispatch on the first call in the process,
    and two threads making that first call at once race it: one of them
    then evaluates its block in a low-accuracy path (``cos`` off by up to
    1.5e-4, ~2500 ulps, over the first block only).  The Fourier shift's
    ramp is such a call, so a fresh process that shifted a batch of more
    than 2048 bins first wrote another observation 0 now and then.  One
    call on one element is serial; made here, on import of the module every
    computing module of the port loads, it runs before any parallel one."""
    torch.sin(torch.zeros(1))


_init_host_vector_math()


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the CUDA card; it raises when there is none, instead of
    running on the CPU behind the caller's back.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(t, device):
    """``t`` on ``device``.  A host tensor bound for the card goes through
    pinned memory without blocking, so the copy queues behind the work
    already on the stream instead of waiting for it."""
    device = torch.device(device)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
