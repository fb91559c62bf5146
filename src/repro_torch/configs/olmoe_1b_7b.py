"""OLMoE-1B-7B: 64-expert top-8 MoE, 1B active / 7B total [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8,
    supports_long_context=False,  # full attention -> long_500k skipped
)
