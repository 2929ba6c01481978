"""Mesh, shardings and the pipeline (counterpart of
``aigw_tpu/parallel/``).

The reference's intra-model collectives are XLA ops GSPMD emits over an
ICI mesh of one process; the port's are ``torch.distributed``
collectives (NCCL on CUDA, gloo on the CPU) that each rank's model
issues over its own shard, one process per device. The gateway and the
replica still meet over HTTP.
"""

from aigw_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
from aigw_tpu_torch.parallel.sharding import (
    analytical_ici_bytes_per_token,
    kv_cache_spec,
    llama_param_specs,
    mixtral_param_specs,
    shard_params,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "analytical_ici_bytes_per_token",
    "kv_cache_spec",
    "llama_param_specs",
    "make_mesh",
    "mixtral_param_specs",
    "shard_params",
]
