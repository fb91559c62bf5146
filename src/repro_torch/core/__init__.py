"""Formats, pcsr policies, the plain-torch codec and the GEMM front door."""
