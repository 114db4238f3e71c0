"""Parameter specs and their materialization (single device)."""
