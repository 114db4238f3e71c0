"""Atomic, validated checkpoints in the JAX package's on-disk format."""
