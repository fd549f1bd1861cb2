"""Deterministic synthetic token pipeline (a copy of ``repro.data.pipeline``:
numpy only, so its batches equal the reference's bit for bit).

Every batch is a pure function of (seed, step, shard) — no files, no state.
That determinism is what the fault-tolerance tests lean on: a restarted
worker reproduces exactly the batches it would have seen, so checkpoint
-restart equality can be asserted bit-for-bit.

The token stream is Zipfian with a Markov flavour (token t+1 depends on t),
so cross-entropy actually decreases during the e2e training examples —
a pure-uniform stream would pin the loss at log(V).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


class SyntheticTokens:
    """Sharded, deterministic, restartable token source."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"{num_shards} shards"
            )
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed Zipf unigram table + a deterministic "grammar" permutation
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self._probs = probs / probs.sum()
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.permutation(cfg.vocab_size)  # t -> likely successor

    def batch(self, step: int) -> dict:
        """{'tokens': (local_batch, S) int32, 'labels': same} for ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        B, S = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._probs)
        # Markov mixing: with p=0.5 the next token is succ(prev) — learnable
        follow = rng.random((B, S)) < 0.5
        seq = base.copy()
        for t in range(1, S + 1):
            seq[:, t] = np.where(follow[:, t - 1], self._succ[seq[:, t - 1]],
                                 base[:, t])
        return {
            "tokens": seq[:, :S].astype(np.int32),
            "labels": seq[:, 1 : S + 1].astype(np.int32),
        }

    def frontend_stub(self, step: int, kind: str, d_model: int, n: int) -> np.ndarray:
        """Precomputed modality embeddings (VLM patches / audio frames)."""
        rng = np.random.default_rng(
            (self.cfg.seed * 9_176_941 + step) * 131 + self.shard + hash(kind) % 1000
        )
        return rng.standard_normal((self.local_batch, n, d_model)).astype(np.float32)


def batch_for_model(source: SyntheticTokens, cfg, step: int) -> dict:
    """Model-aware batch: adds stub frontend tensors per family."""
    b = source.batch(step)
    if cfg.vlm is not None:
        b["patch_embeds"] = source.frontend_stub(
            step, "vlm", cfg.d_model, cfg.vlm.num_patches
        )
    if cfg.encdec is not None:
        b["frames"] = source.frontend_stub(
            step, "audio", cfg.d_model, cfg.encdec.encoder_frames
        )
    return b


def as_tensors(batch: dict, device) -> dict:
    """A batch of numpy arrays as torch tensors on ``device``."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
