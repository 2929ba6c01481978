"""Serving telemetry of the port (counterpart of ``aigw_tpu/obs/``)."""
