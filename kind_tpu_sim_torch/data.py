"""Input pipeline: packed LM batches, prefetched to the device.

Counterpart of ``kind_tpu_sim/data.py``. The host prepares batch N+1
while the device runs batch N:

* **Document stream -> packed sequences.** ``synthetic_documents`` and
  ``pack`` are the reference's, numpy only, so the token streams are
  identical to it: documents concatenated with an EOS separator and
  sliced into exact (batch, seq) windows, no padding.
* **Device placement.** Each batch is copied from pinned host memory
  with ``.to(device, non_blocking=True)``, which returns before the
  copy ends, as ``jax.device_put`` does. Placement over a mesh is not
  ported yet.
* **Double-buffered prefetch.** ``Prefetcher`` stages up to ``depth``
  batches ahead on a background thread.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from kind_tpu_sim_torch.device import resolve


def synthetic_documents(seed: int, vocab_size: int,
                        min_len: int = 8, max_len: int = 64,
                        ) -> Iterator[list]:
    """Endless stream of variable-length 'documents' (ramps mod vocab,
    like ``transformer.sample_batch`` rows: learnable structure, no real
    data needed in the repository)."""
    rng = np.random.RandomState(seed)
    while True:
        n = int(rng.randint(min_len, max_len + 1))
        start = int(rng.randint(0, vocab_size))
        yield [(start + i) % vocab_size for i in range(n)]


def pack(documents: Iterable[list], batch: int, seq: int,
         eos_id: int = 0) -> Iterator[np.ndarray]:
    """Pack a document stream into dense (batch, seq) int32 arrays.

    Documents are concatenated with ``eos_id`` separators and sliced
    into exact windows, wasting no position on padding (a partial tail
    document continues in the next batch)."""
    buf: list = []
    docs = iter(documents)
    want = batch * seq
    while True:
        while len(buf) < want:
            try:
                doc = next(docs)
            except StopIteration:
                # finite corpus exhausted: drop the partial tail window
                # (an incomplete batch would break the fixed shape) and
                # end cleanly
                return
            buf.extend(doc)
            buf.append(eos_id)
        window, buf = buf[:want], buf[want:]
        yield np.asarray(window, np.int32).reshape(batch, seq)


class Prefetcher:
    """Stage batches onto the device ahead of consumption.

    A daemon thread pulls from ``source``, applies ``place`` (a copy to
    the device) and keeps up to ``depth`` staged batches in a bounded
    queue. Iteration ends when the source does and re-raises an error
    the source raised; ``close()`` (or leaving the ``with`` block) stops
    a still-running stream."""

    _DONE = object()

    def __init__(self, source: Iterator[Any],
                 place: Optional[Callable[[Any], Any]] = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._place = place or (lambda x: x)
        self._source = source
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put; False once close() was called. The
        terminal error and end-of-stream puts go through here too, so a
        close() that arrives while the queue is full is never missed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if not self._put(self._place(item)):
                    return
        except Exception as exc:  # handed to the consumer, raised there
            self._put(exc)
            return
        self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so the producer's blocked put() can observe the stop
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    # A loop that leaves iteration early (early stopping, an exception)
    # must not leak the producer thread or the batches it holds.
    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def input_pipeline(cfg, batch: int, seed: int = 0,
                   steps: Optional[int] = None,
                   device="cuda") -> Prefetcher:
    """The assembled pipeline: synthetic documents -> packed (batch,
    max_seq) int32 windows -> int64 tokens on ``device`` (pinned host
    memory, asynchronous copy to the card) -> double-buffered prefetch.
    ``steps`` bounds the stream (None: endless)."""
    dev = resolve(device)
    batches: Iterator[np.ndarray] = pack(
        synthetic_documents(seed, cfg.vocab_size), batch, cfg.max_seq)
    if steps is not None:
        batches = itertools.islice(batches, steps)

    def place(window: np.ndarray) -> torch.Tensor:
        tokens = torch.from_numpy(window).long()
        if dev.type == "cuda":
            tokens = tokens.pin_memory()
        return tokens.to(dev, non_blocking=True)

    return Prefetcher(batches, place=place)
