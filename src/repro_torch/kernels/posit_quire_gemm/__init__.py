"""Exact posit GEMM: O = round_once(sum_k decode(A)[i,k] * decode(B)[k,j])."""
