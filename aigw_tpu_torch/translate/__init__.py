"""Request-format helpers the replica needs (the port's own copies)."""
