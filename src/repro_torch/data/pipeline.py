"""Deterministic data pipeline (numpy only).

Counterpart of ``repro/data/pipeline.py``, a copy of it: the port imports
nothing of the JAX package.  The stream is a pure function of
``(seed, step, host)``, so every batch equals the reference's bit for bit.

Offline container ⇒ synthetic token streams, but built like production:
  * deterministic per-(host, step) sharding — every host materializes only
    its slice of the global batch (what multi-host input pipelines do);
  * restart-safe: the stream is a pure function of (seed, step), so resuming
    from step k after a failure replays the exact same data;
  * double-buffered prefetch thread to overlap host→device transfer.

The synthetic LM distribution is a Zipfian-unigram + Markov-ish mixture so
losses move meaningfully during the example training runs (unlike uniform
noise, whose CE is flat at log V).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2


class SyntheticLMStream:
    """Deterministic, shardable synthetic LM token stream."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # fixed Zipf unigram table + deterministic bigram shift pattern
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self.unigram = probs / probs.sum()
        self.shift = rng.integers(1, cfg.vocab_size, size=64)

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, labels) for this host at ``step`` — pure function."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * c.num_hosts + c.host_id)
        base = rng.choice(c.vocab_size, p=self.unigram,
                          size=(self.local_batch, c.seq_len + 1))
        # inject learnable structure: token t+1 correlates with token t
        mask = rng.random((self.local_batch, c.seq_len + 1)) < 0.5
        shifted = (base + self.shift[step % 64]) % c.vocab_size
        seq = np.where(mask, shifted, base).astype(np.int32)
        return seq[:, :-1], seq[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread double buffering with seekable random access.

    Sequential use is unchanged: ``next(it)`` yields ``(step, batch)`` in
    order from ``start_step``.  On top of that:

      * ``batch_at(step)`` — a *seekable* accessor: consecutive steps are
        served straight from the prefetch buffer; any other step seeks
        (discarding stale buffered batches via a generation counter) and
        resumes prefetching from there.  This is what lets consumers that
        address data by step — ``repro_torch.stochastic.MinibatchSampler``
        and restart-after-preemption training loops — sit on a prefetched
        stream without giving up determinism.
      * clean shutdown — ``close()`` is idempotent, signals the worker and
        *joins* the thread; the context-manager form scopes it.  ``daemon``
        stays True by default (an unclosed iterator never blocks
        interpreter exit) but can be disabled where dangling daemon
        threads are unwanted (e.g. under test runners that assert on
        thread leaks).
    """

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 depth: int = 2, daemon: bool = True):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._lock = threading.Lock()
        self._gen = 0               # bumped by seek(); stale batches dropped
        self._produce_step = start_step
        self._next_step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=daemon)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                gen, step = self._gen, self._produce_step
                self._produce_step = step + 1
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                with self._lock:
                    if gen != self._gen:    # a seek invalidated this batch
                        break
                try:
                    self.q.put((gen, step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                gen, step, batch = self.q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                continue
            if gen != self._gen:            # drop batches from before a seek
                continue
            self._next_step = step + 1
            return step, batch

    def seek(self, step: int):
        """Restart prefetching at ``step``; buffered batches are discarded.

        The generation counter makes this race-free against the worker: a
        batch produced under an old generation is dropped at the queue (by
        the worker) or at the consumer (by ``__next__``), never served.
        """
        with self._lock:
            self._gen += 1
            self._produce_step = step
            self._next_step = step
        while True:                          # drain stale buffered batches
            try:
                self.q.get_nowait()
            except queue.Empty:
                return

    def batch_at(self, step: int):
        """The batch for ``step`` — buffered when sequential, seek otherwise.

        Equivalent to ``stream.batch_at(step)`` (the stream is a pure
        function of ``(seed, step)``) but served from the prefetch buffer
        whenever ``step`` continues the current run.
        """
        if step != self._next_step:
            self.seek(step)
        got, batch = next(self)
        assert got == step, (got, step)
        return batch

    def close(self):
        """Stop the worker and join it (idempotent)."""
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
