"""Dense decoder-only transformer of the port (PyTorch)."""
