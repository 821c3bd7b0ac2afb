"""rtbench: the benchmark of the PyTorch / CUDA port (`tpu_raytracer_torch`)."""
