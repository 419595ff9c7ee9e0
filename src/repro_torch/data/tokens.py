"""Deterministic LM token pipeline (numpy; the port's own copy of
``repro.data.tokens``, token for token the same batches).

No corpus ships with the repository, so the pipeline synthesises a corpus with a
Zipfian unigram distribution + Markov bigram structure (so the loss has
learnable signal and a well-defined floor). Deterministic in
(seed, step, shard) — a restarted/elastically-resized job regenerates the
exact same global batch for a given step, which is what makes the
checkpoint-restart tests bit-reproducible.

Multi-host note: each process materialises only its addressable slice of
the global batch (`host_slice`); the global batch is defined by (seed,
step) alone, not by the number of hosts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_markov_states: int = 256      # bigram structure strength


class SyntheticTokens:
    """step → (global_batch, seq_len) int32 tokens, deterministically."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        V, K = cfg.vocab, min(cfg.n_markov_states, cfg.vocab)
        # Zipf unigram over the vocab
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / (1.0 / ranks).sum()
        # Markov state machine: state → biased token subset
        self._state_shift = base.integers(0, V, size=K)
        self._K = K

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        u = rng.random(size=(B, S))
        # inverse-CDF sample of the Zipf unigram
        cdf = np.cumsum(self._unigram)
        toks = np.searchsorted(cdf, u).astype(np.int64)
        # bigram structure: token t+1 is shifted by a state keyed on token t
        state = toks[:, :-1] % self._K
        mix = rng.random(size=(B, S - 1)) < 0.5
        toks[:, 1:] = np.where(
            mix, (toks[:, 1:] + self._state_shift[state]) % V, toks[:, 1:])
        return toks.astype(np.int32)

    def host_slice(self, step: int, proc_index: int,
                   proc_count: int) -> np.ndarray:
        """Per-host shard of the global batch (contiguous rows)."""
        g = self.batch(step)
        B = g.shape[0]
        assert B % proc_count == 0, (B, proc_count)
        per = B // proc_count
        return g[proc_index * per:(proc_index + 1) * per]

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
