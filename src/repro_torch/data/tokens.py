"""Synthetic language-model token pipeline (for the assigned architectures).

Offline container -> no corpus; we synthesise token streams with enough
structure to make loss curves meaningful (Zipfian unigram + Markov bigram
mixture), partitioned per FL client with client-specific bigram tables so
the federation is genuinely non-IID at the sequence level.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class ZipfMarkovStream:
    """Per-client token source: mixture of a shared Zipf unigram and a
    client-specific sparse bigram transition."""

    def __init__(self, vocab: int, seed: int, bigram_strength: float = 0.5,
                 n_hot: int = 8):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.bigram_strength = bigram_strength
        # sparse per-state successor sets (memory-light for 200k vocabs)
        self.n_hot = n_hot
        self.succ_seed = int(self.rng.integers(0, 2**31))

    def _successors(self, tok: np.ndarray) -> np.ndarray:
        # hash-derived deterministic successor set per token
        h = (tok.astype(np.int64) * 2654435761 + self.succ_seed) % (2**31)
        return (h[:, None] * np.arange(1, self.n_hot + 1)) % self.vocab

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int64)
        out[:, 0] = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(1, seq):
            succ = self._successors(out[:, t - 1])
            use_bigram = self.rng.random(batch) < self.bigram_strength
            pick = succ[np.arange(batch), self.rng.integers(0, self.n_hot, batch)]
            uni = self.rng.choice(self.vocab, size=batch, p=self.unigram)
            out[:, t] = np.where(use_bigram, pick, uni)
        return out.astype(np.int32)


def lm_round_batches(
    vocab: int,
    n_clients: int,
    local_steps: int,
    batch: int,
    seq: int,
    seed: int,
    round_idx: int = 0,
) -> Dict[str, np.ndarray]:
    """[n_clients, local_steps, batch, seq] token/label arrays for a round."""
    toks = np.empty((n_clients, local_steps, batch, seq + 1), np.int32)
    for ci in range(n_clients):
        stream = ZipfMarkovStream(vocab, seed * 1000 + ci)
        toks[ci] = stream.sample(local_steps * batch, seq + 1).reshape(
            local_steps, batch, seq + 1
        )
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}


def lm_eval_batch(vocab: int, batch: int, seq: int, seed: int) -> Dict[str, np.ndarray]:
    stream = ZipfMarkovStream(vocab, seed)
    t = stream.sample(batch, seq + 1)
    return {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
