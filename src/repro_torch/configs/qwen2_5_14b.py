"""Qwen2.5-14B: GQA dense with QKV bias [hf:Qwen/Qwen2.5 family; hf]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=13824, vocab=152064,
    qkv_bias=True, rope_base=1_000_000.0,
)
