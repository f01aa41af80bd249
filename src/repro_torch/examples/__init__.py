"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
ported from the JAX package's ``examples/``, which stays the JAX one's."""
