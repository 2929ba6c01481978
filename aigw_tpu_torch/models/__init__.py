"""Model families of the port (counterpart of ``aigw_tpu/models``)."""
