"""device_idle_pct.serve: the device (H100) in the serving cells
(``_idle.py``). Moves ``tpot_p95_ms``."""

from _idle import read  # noqa: F401
