"""Configuration of the port (the JAX package's dataclasses and flags)."""
