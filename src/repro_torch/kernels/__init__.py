"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a`` with a plain
C interface, built at first use by :mod:`repro_torch.kernels.build`),
``ops.py`` (the checked wrapper with its launch count) and ``ref.py`` (the
plain PyTorch version, which CPU tensors take).

Ported so far: flash attention (the reference's
``repro/kernels/flash_attention``).  The WKV and selective-scan kernels
come with the rwkv6 and hymba families.
"""
