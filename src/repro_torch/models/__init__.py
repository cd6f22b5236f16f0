"""Model code of the port (the dense decoder so far)."""
