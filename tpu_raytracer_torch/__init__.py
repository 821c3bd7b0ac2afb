"""tpu_raytracer_torch: the ReSTIR path tracer of `tpu_raytracer`, ported
to PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `tpu_raytracer` stays the reference; this package imports
neither it nor `jax`. Plain tensor code is eager PyTorch; the CUDA
kernels in `csrc/` are built with nvcc on first use and bound through
ctypes:
  K1, K2   closest- and any-hit sweep over 128-triangle chunks (trace.cu)
  K3       the streamed sweep of dense scenes (trace_stream.cu)
  K4       the instanced sweep (trace_inst.cu)
  K5       the vpu mode's sweep (trace_vpu.cu)
  K6       the tensor-core test of the mxu modes (trace_mxu.cu)
  K7       the row gather of the shading's table fetches (gather.cu)
  K8       the BVH walk past a scene's brute_max (trace_bvh.cu)
  K9       the path tracer's shading, a launch per depth (path_trace.cu)
  K10      the post pass, one launch a frame or band (post.cu)
  K11      ReSTIR's spatial reuse, 7 launches a frame or band around its
           tap any-hit calls and the replay (spatial.cu)
A CPU tensor takes each kernel's plain PyTorch version instead, so the
package runs (slowly) on a machine without a GPU; a CUDA tensor always
takes the kernel.
"""

__version__ = "0.1.0"
