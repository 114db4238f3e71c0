"""LM models of the port: the dense transformer (granite-3-2b serving)."""
