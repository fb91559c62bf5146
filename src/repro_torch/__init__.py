"""PyTorch/CUDA port of the posit transprecision system (``repro``).

Layering mirrors the reference package: ``core`` (formats, pcsr, codec,
GEMM front door) -> ``kernels/<name>`` (hand-written Hopper kernel + plain
torch version) -> ``models`` -> ``launch``. Entry points run on the CUDA
device unless called with ``device="cpu"``.
"""
