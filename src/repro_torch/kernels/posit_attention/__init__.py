"""Decode-step attention over a posit-coded KV cache."""
