"""Host utilities of the port (NumPy only)."""
