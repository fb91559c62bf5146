"""Yi-34B: llama-arch GQA dense [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    rope_base=5_000_000.0,
)
