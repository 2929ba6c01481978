"""aigw-check for the port: in-tree static analysis for the serving
stack's correctness rules (the counterpart of ``aigw_tpu/analysis``).

Import-light on purpose: the engine imports
``aigw_tpu_torch.analysis.registry`` (the ``@engine_thread_only``
sanitizer) on its construction path, so this package root must not pull
in the pass machinery or obs/metrics. Reach the framework explicitly:

    from aigw_tpu_torch.analysis.core import run_checks
    from aigw_tpu_torch.analysis import manifest

The gate is ``python tools/torch_staticcheck.py``.
"""

from aigw_tpu_torch.analysis.registry import (  # noqa: F401
    DEFAULT_CONFIG,
    AnalysisConfig,
    EngineThreadViolation,
    ThreadDomain,
    engine_thread_only,
)
