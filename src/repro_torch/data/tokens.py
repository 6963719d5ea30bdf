"""Synthetic LM token pipeline: deterministic, host-sharded, restart-safe.

Each batch is a pure function of (seed, step), so a restarted job regenerates
exactly the batches it would have seen (checkpoint/restart consistency), and
each host in a multi-host job generates only its shard by indexing with its
process rank — the same contract a real distributed loader provides.

The token stream is a Zipfian-ish unigram mix with short-range structure
(Markov blending) so cross-entropy actually decreases during the example
training runs instead of flat-lining at ln(V).  A copy of the JAX package's
pipeline: the same ``np.random.Generator`` stream per step, so its batches
are equal element for element.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                 n_shards: int = 1, shard: int = 0, family: str = "lm", extra: dict | None = None):
        assert batch % n_shards == 0
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        self.family = family
        self.extra = extra or {}
        # fixed unigram distribution (Zipf) + per-token successor table
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._successor = rng.integers(0, vocab_size, size=vocab_size)

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + step) * self.n_shards + self.shard)

    def batch_at(self, step: int) -> dict:
        rng = self._rng_for(step)
        b = self.batch // self.n_shards
        s = self.seq
        iid = rng.choice(self.vocab, size=(b, s), p=self._unigram)
        toks = iid.copy()
        # 50% of positions copy a deterministic successor of the *realized*
        # previous token -> learnable first-order structure
        follow = rng.random((b, s)) < 0.5
        for t in range(1, s):
            toks[:, t] = np.where(follow[:, t], self._successor[toks[:, t - 1]], iid[:, t])
        out = {}
        if self.family == "audio":
            fd = self.extra["frontend_dim"]
            out["frames"] = rng.normal(size=(b, s, fd)).astype(np.float32)
            out["labels"] = toks.astype(np.int32)
            return out
        if self.family == "vlm":
            p = self.extra["vision_patches"]
            fd = self.extra["frontend_dim"]
            out["patches"] = rng.normal(size=(b, p, fd)).astype(np.float32)
            toks = toks[:, : s - p]
        out["tokens"] = toks.astype(np.int32)
        out["labels"] = np.roll(toks, -1, axis=1).astype(np.int32)
        out["labels"][:, -1] = -1  # no target for the final position
        return out


def pipeline_for(cfg, batch: int, seq: int, *, seed: int = 0, n_shards: int = 1, shard: int = 0):
    family = cfg.family if cfg.family in ("audio", "vlm") else "lm"
    extra = {"frontend_dim": cfg.frontend_dim, "vision_patches": cfg.vision_patches}
    return TokenPipeline(
        cfg.vocab_size, batch, seq, seed=seed, n_shards=n_shards, shard=shard,
        family=family, extra=extra,
    )
