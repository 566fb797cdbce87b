"""The port's kernels: CUDA sources under ``csrc/``, built by ``_build``,
each wrapped beside its plain PyTorch version."""
