"""PyTorch + CUDA port of grtrans_tpu for NVIDIA Hopper GPUs.

The module layout mirrors `grtrans_tpu` so each function has an obvious
counterpart, and each sub-package exports the names `grtrans_tpu`'s does.
The render path runs in float64, or with `prec="mixed"` in grtrans_tpu's
mixed precision, on the device the caller names
(`orchestrator.grtrans_run(cfg, model, device=...)`); nothing here
chooses a device on its own.

Importing the package starts nothing: no JAX, no CUDA context, no kernel
build.  Hand-written CUDA kernels (`csrc/`) are compiled with `nvcc` on
first use into `grtrans_tpu_torch/_build/`.
"""
