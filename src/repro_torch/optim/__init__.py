"""AdamW with float32 master weights."""
