"""Data pipeline: synthetic LM token streams (and frontend-embedding
streams for the vlm/audio archs) with background prefetch.

The generator is deterministic-per-seed Zipf-mixture text-like data —
enough structure for a ~100M model to show a real loss curve in the
end-to-end example.  `PrefetchIterator` overlaps host-side batch
synthesis with device compute (one producer thread, bounded queue).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..models.config import ModelConfig


class TokenStream:
    """Markov-ish Zipf token stream: P(next | cur) mixes a per-state
    permutation with a global Zipf marginal — compressible structure."""

    def __init__(self, vocab_size: int, seed: int = 0, order_mix: float = 0.6):
        self.v = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.marginal = (1.0 / ranks ** 1.1)
        self.marginal /= self.marginal.sum()
        self.shift = self.rng.integers(1, vocab_size)
        self.mix = order_mix

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int64)
        cur = self.rng.choice(self.v, size=batch, p=self.marginal)
        for t in range(seq):
            out[:, t] = cur
            nxt_markov = (cur * 31 + self.shift) % self.v
            nxt_rand = self.rng.choice(self.v, size=batch, p=self.marginal)
            take = self.rng.random(batch) < self.mix
            cur = np.where(take, nxt_markov, nxt_rand)
        return out


def make_batch_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                        host_share=None):
    """Yields {tokens|embeds, labels} numpy batches forever.  host_share:
    optional callable returning this host's batch size (straggler
    mitigation hook)."""
    stream = TokenStream(cfg.vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        b = batch if host_share is None else int(host_share())
        toks = stream.sample(b, seq).astype(np.int32)
        if cfg.frontend is not None:
            embeds = rng.normal(0, 1, (b, seq, cfg.d_model)).astype(np.float32)
            yield {"embeds": embeds, "labels": toks}
        else:
            yield {"tokens": toks, "labels": toks}


class PrefetchIterator:
    """Background-thread prefetch with a bounded queue (depth=2 default:
    one batch in flight, one ready)."""

    def __init__(self, it, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
