"""The port's jax-free copies of the JAX package's ``verify/`` protocol IR:
so far the hierarchical ring's phase program (``opstream``)."""
