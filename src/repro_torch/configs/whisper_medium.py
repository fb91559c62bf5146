"""Whisper-medium: encoder-decoder, the conv frontend stubbed to precomputed
frame embeddings (B, 1500, d) [arXiv:2212.04356].

The decoder's architectural limit is 448 positions (``models/encdec.py``
``MAX_TGT``); positions wrap past it.
"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="whisper-medium", family="whisper",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
    enc_layers=24, enc_frames=1500, max_target_positions=448,
    supports_long_context=False,
)
