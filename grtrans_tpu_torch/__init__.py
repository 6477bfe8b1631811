"""PyTorch + CUDA port of grtrans_tpu for NVIDIA Hopper GPUs.

The module layout mirrors `grtrans_tpu` so each function has an obvious
counterpart.  Everything on the render path runs in float64 on the
device the caller names (`orchestrator.grtrans_run(cfg, model,
device=...)`); nothing here chooses a device on its own.

Importing the package starts nothing: no JAX, no CUDA context, no kernel
build.  Hand-written CUDA kernels (`csrc/`) are compiled with `nvcc` on
first use into `grtrans_tpu_torch/_build/`.
"""
