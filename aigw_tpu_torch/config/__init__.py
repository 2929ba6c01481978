"""Gateway configuration of the port (counterpart of ``aigw_tpu/config``)."""
