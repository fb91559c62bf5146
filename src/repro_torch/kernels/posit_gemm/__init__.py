"""Fused posit GEMM: O = encode(act(decode(A) @ decode(B) + bias) + residual)."""
