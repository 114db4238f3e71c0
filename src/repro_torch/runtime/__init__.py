"""The LM training loop."""
