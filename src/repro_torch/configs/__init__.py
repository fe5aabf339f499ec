"""Model configurations (copied from the JAX package)."""
