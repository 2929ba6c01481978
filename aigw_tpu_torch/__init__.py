"""aigw-tpu's serving stack on PyTorch and CUDA (one NVIDIA H100).

The JAX package ``aigw_tpu`` is the reference; this package mirrors its
layout module for module (``models/``, ``ops/``, ``tpuserve/``) and
holds the hand-written Hopper kernels under ``csrc/``. It imports
``torch`` and never ``jax`` or ``aigw_tpu``.

Every entry point takes an explicit ``device``: ``"cuda"`` by default,
``"cpu"`` only on request (the parity tests). On a CPU tensor each
kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the kernel or raises.
"""
