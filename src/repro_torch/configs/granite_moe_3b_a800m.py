"""Granite-3.0 MoE 3B-a800m: 40-expert top-8, fine-grained d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    supports_long_context=False,  # full attention -> long_500k skipped
)
