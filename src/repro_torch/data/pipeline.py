"""Deterministic, resumable, sharded data pipeline (a copy of
``repro.data.pipeline``: numpy only, so batch ``i`` is byte-identical in
both packages).

Design constraints at 1000+ nodes:

  * **Stateless resumability**: batch ``i`` is a pure function of
    ``(seed, i)`` -- a restarted (or elastically resized) job resumes from
    the checkpointed step with zero pipeline state to restore, and a
    straggling host can be replaced mid-run without coordination.
  * **Per-host sharding**: each host materializes only its slice of the
    global batch (``host_slice``); the global batch is assembled by the
    runtime's sharding, never on one host.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready so
    host-side generation overlaps device compute.

The dataset here is synthetic (seeded token streams with a repeating-ngram
structure so the LM loss actually decreases); swapping in a real tokenized
corpus only requires another ``__getitem__``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class SyntheticLMDataset:
    """Deterministic synthetic LM tokens: batch i == f(seed, i)."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    ngram: int = 8

    def batch(self, index: int, batch_size: int) -> Dict[str, np.ndarray]:
        # A FIXED n-gram pool (function of seed only) gives the model stable
        # statistics to learn; batch composition varies with the index.
        pool_rng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        pool = pool_rng.integers(1, self.vocab_size,
                                 size=(64, self.ngram), dtype=np.int32)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))
        picks = rng.integers(0, 64, size=(batch_size,
                                          self.seq_len // self.ngram + 2))
        toks = pool[picks].reshape(batch_size, -1)[:, : self.seq_len + 1]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class DataPipeline:
    """Per-host sharded, prefetching iterator over a dataset."""

    def __init__(
        self,
        dataset: SyntheticLMDataset,
        global_batch: int,
        host_index: int = 0,
        host_count: int = 1,
        start_step: int = 0,
        prefetch: int = 2,
        extra_builder=None,          # fn(host_batch) -> dict (vlm/enc_dec stubs)
    ) -> None:
        assert global_batch % host_count == 0, (global_batch, host_count)
        self.dataset = dataset
        self.global_batch = global_batch
        self.host_batch = global_batch // host_count
        self.host_index = host_index
        self.host_count = host_count
        self.step = start_step
        self.extra_builder = extra_builder
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        full = self.dataset.batch(step, self.global_batch)
        lo = self.host_index * self.host_batch
        hi = lo + self.host_batch
        host = {k: v[lo:hi] for k, v in full.items()}
        if self.extra_builder is not None:
            host = self.extra_builder(host)
        return host

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def peek_step(self, step: int) -> Dict[str, np.ndarray]:
        """Random access (used by tests + straggler replacement)."""
        return self._make(step)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
