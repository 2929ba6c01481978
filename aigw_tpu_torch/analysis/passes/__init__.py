"""The aigw-check pass set — one module per invariant.

The reference's ``jit-registry`` checks ``jax.jit`` / ``pjit`` /
``shard_map`` constructions, which the port has none of; its
counterpart here is ``capture-registry``, over the port's compiled
programs: CUDA graph captures.
"""

from aigw_tpu_torch.analysis.passes import (
    async_blocking,
    capture_registry,
    determinism,
    gauge_drift,
    thread_discipline,
)

ALL_PASSES = (
    capture_registry,
    thread_discipline,
    async_blocking,
    determinism,
    gauge_drift,
)

RULES = tuple(m.RULE for m in ALL_PASSES)
