"""ModelCfg: the static architecture descriptor (the reference's fields).

``reduced()`` derives the CPU smoke-test configuration exactly as the
reference does, so both packages build the same reduced model.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str              # dense | moe | gemma3 | zamba | xlstm | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # gemma3 (sliding-window local : global pattern)
    window: int = 0
    local_ratio: int = 0
    global_rope_base: float = 1_000_000.0
    # ssm / zamba
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    shared_attn_every: int = 0
    # whisper
    enc_layers: int = 0
    enc_frames: int = 0
    max_target_positions: int = 0
    # vlm
    n_patches: int = 0
    # xlstm
    slstm_every: int = 0
    xlstm_chunk: int = 256
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ModelCfg":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.family != "zamba" else 7),
            d_model=128,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32 if self.head_dim else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 16) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=min(self.enc_frames, 24) if self.enc_frames else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            xlstm_chunk=16,
            shared_attn_every=min(self.shared_attn_every, 3) if self.shared_attn_every else 0,
        )
