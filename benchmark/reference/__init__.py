"""The plain references: float32 PyTorch and NumPy, written apart from the
port. Nothing here imports the port (``srbh_tpu_torch``) or JAX."""
