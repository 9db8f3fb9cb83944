"""CUDA C++ sources of the port's hand-written kernels, compiled with nvcc
on first use (see :func:`psrsigsim_torch.ops.rng_hw.build`)."""
