"""API schema helpers of the port (counterpart of ``aigw_tpu/schemas``)."""
