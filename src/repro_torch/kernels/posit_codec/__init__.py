"""Elementwise posit codec: decode (codes -> f32/bf16) and encode (f32 -> codes)."""
