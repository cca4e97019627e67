"""Hand-written Hopper kernels of the port.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a``, built at first
use by :mod:`repro_torch.kernels.build`) and ``<name>.py`` (the wrapper,
its plain PyTorch version, a launch counter and the tests' oracles).
"""
