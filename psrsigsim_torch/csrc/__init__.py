"""CUDA C++ sources of the port's hand-written kernels, compiled with nvcc
on first use (see :mod:`psrsigsim_torch.ops._build`)."""
