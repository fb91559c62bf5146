"""Deterministic synthetic LM data pipeline.

Every batch is a pure function of (seed, step), drawn from an
explicit ``torch.Generator`` on the pipeline's device, so any step's batch
can be made again anywhere. The token stream has the reference's structure:
a Zipf unigram table fixed by the seed, and with probability 0.5 the next
token follows the realized previous one at a fixed shift (a bigram chain),
so losses fall during training. Its draws are torch's, not jax.random's:
the two packages' streams differ for one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class SyntheticLMPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        # the fixed "language model" defining the synthetic distribution
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._unigram = torch.tensor(unigram, dtype=torch.float32, device=self.dev)
        self._shift = int(rng.integers(1, max(self.vocab - 1, 2)))

    def _generator(self, step: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.seed, step]).generate_state(
            2, np.uint32)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(seed[0]) << 31 | int(seed[1]) >> 1)
        return gen

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step``: tokens and labels, (B, S) int32 on
        the pipeline's device; labels are the next tokens (the last position
        wraps to the first, as in the reference)."""
        gen = self._generator(step)
        B, S = self.global_batch, self.seq_len
        u = torch.multinomial(self._unigram, B * S, replacement=True,
                              generator=gen).reshape(B, S)
        follow = torch.rand((B, S), generator=gen, device=self.dev) < 0.5
        cols, prev = [], u[:, 0]
        for i in range(S):
            prev = torch.where(follow[:, i], (prev + self._shift) % self.vocab, u[:, i])
            cols.append(prev)
        tokens = torch.stack(cols, dim=1).to(torch.int32)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        return {"tokens": tokens, "labels": labels}
