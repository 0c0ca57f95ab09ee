"""Deterministic synthetic data pipeline with background prefetch. The
port's own copy of ``repro/data/pipeline.py`` (numpy only), so that
``repro_torch`` imports nothing of ``repro``; ``batch_at`` gives the
reference's batches bit for bit.

Batches are a pure function of (seed, step, shard) — a restarted or
re-elected host reproduces exactly the batches it owes, which is what
makes checkpoint-restart and elastic reassignment exact (no data-order
drift). Prefetch runs in a daemon thread with a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticTokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1,
                 prefetch: int = 2, structured: bool = True):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        self.structured = structured
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self.prefetch = prefetch

    # -- pure batch function ------------------------------------------------
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard,
                                    self.n_shards]))
        b = self.batch // self.n_shards
        if self.structured:
            # Markov-ish stream: learnable bigram structure so training
            # loss actually decreases in the examples
            base = rng.integers(0, self.vocab, (b, 1), dtype=np.int32)
            drift = rng.integers(0, 7, (b, self.seq), dtype=np.int32)
            toks = (base + np.cumsum(drift, axis=1)) % self.vocab
            toks = np.concatenate([base, toks], axis=1).astype(np.int32)
        else:
            toks = rng.integers(0, self.vocab, (b, self.seq + 1),
                                dtype=np.int32)
        return dict(tokens=toks)

    # -- prefetch -----------------------------------------------------------
    def _worker(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            item = (step, self.batch_at(step))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        self._q = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()
        th = threading.Thread(target=self._worker, args=(start_step,),
                              daemon=True)
        th.start()
        try:
            while True:
                _, b = self._q.get()
                yield b
        finally:
            self._stop.set()

    def stop(self):
        self._stop.set()
