"""mfu_pct.serve: the model step (``models/llama.py``) in the serving
cells (``_mfu.py``). Moves ``tpot_p95_ms``."""

from _mfu import read  # noqa: F401
