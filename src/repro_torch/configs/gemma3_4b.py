"""Gemma-3-4B: 5:1 local:global sliding-window, 128k ctx, head_dim 256,
vocab 262144 [hf:google/gemma-3 family]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="gemma3-4b", family="gemma3",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240, vocab=262144,
    head_dim=256, window=1024, local_ratio=5,
    rope_base=10_000.0, global_rope_base=1_000_000.0,
    tie_embeddings=True,  # gemma ties the 262k-vocab embedding
    supports_long_context=True,  # 5/6 layers sliding-window (sub-quadratic);
                                 # global layers are linear per decode step
)
