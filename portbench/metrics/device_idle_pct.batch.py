"""device_idle_pct.batch: the device (H100) in the batch cell
(``_idle.py``). Moves ``output_tok_s``."""

from _idle import read  # noqa: F401
