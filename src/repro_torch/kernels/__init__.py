"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a`` with a plain
C interface, built at first use by :mod:`repro_torch.kernels.build`),
``ops.py`` (the checked wrapper with its launch count) and ``ref.py`` (the
plain PyTorch version, which CPU tensors take).

All three of the reference's kernels are ported: flash attention
(``repro/kernels/flash_attention``, head dims 64 and 128, with a CUDA
backward under autograd for training), the RWKV6 WKV recurrence
(``repro/kernels/rwkv6_wkv``) and the Mamba selective scan
(``repro/kernels/ssm_scan``).  The last two also ship a CUDA backward
(``csrc/<name>_backward.cu``) under autograd.
"""
