"""Training data: the deterministic synthetic LM pipeline."""
