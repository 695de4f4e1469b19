"""The plain reference: float32 PyTorch, numpy and scipy, importing nothing
of the system under test or of JAX."""
