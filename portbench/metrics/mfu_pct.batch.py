"""mfu_pct.batch: the model step (``models/mixtral.py``) in the batch
cell (``_mfu.py``): a token's operations count its two routed experts,
not the padded ``[E, C, D]`` work the program does. Moves
``output_tok_s``."""

from _mfu import read  # noqa: F401
