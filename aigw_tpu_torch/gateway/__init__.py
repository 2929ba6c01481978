"""The gateway data plane of the port (counterpart of ``aigw_tpu/gateway``)."""
