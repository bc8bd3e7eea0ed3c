"""dstack-tpu's workload package ported to PyTorch and CUDA for NVIDIA Hopper.

`dstack_tpu.workloads` (JAX, TPU) stays the reference; this package
mirrors its module names one for one under `dstack_tpu_torch.workloads`.
It imports torch, numpy and the standard library only — never jax or
anything of `dstack_tpu` — and every entry point runs on the CUDA device
unless the caller passes `device="cpu"`.
"""
