"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of ``aigw_tpu/ops/pallas``)."""
