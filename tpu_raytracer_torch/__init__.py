"""tpu_raytracer_torch: the ReSTIR path tracer of `tpu_raytracer`, ported
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `tpu_raytracer` stays the reference; this package imports
neither it nor `jax`. Plain tensor code is eager PyTorch; the CUDA
kernels in `csrc/` (K1-K6, the triangle traversals, and K7, the row
gather of the shading's table fetches) are built with nvcc on first use
and bound through ctypes. A CPU tensor takes
each kernel's plain PyTorch version instead, so the package runs (slowly)
on a machine without a GPU; a CUDA tensor always takes the kernel.
"""

__version__ = "0.1.0"
