"""Helpers of the port shared across its packages (counterpart of ``aigw_tpu/utils``)."""
