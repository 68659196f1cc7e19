"""Serving rounds as CUDA graphs: the port's counterpart of the JAX
package's jitted round programs.

The reference never serves a round operation by operation: ``jax.jit``
compiles each round (the dense chunk scan, the paged tiers' chunks, the
speculative grids, the paged verify scan) into one program per static
shape. Here each round becomes a ``torch.cuda.CUDAGraph``, captured once
per key and replayed at every later round with that key. The key holds
the Python values the round bakes in: the chunk, the table width, the
draft width and windows, and whether any row samples.

An engine calls its round through one attribute, ``_round(key, fn)``:
``fn()`` runs the round and returns its output tensors. The device alone
decides what that attribute is (``round_runner``): ``eager``, which calls
``fn``, for the CPU, and a ``RoundGraphs`` for a card. There is no switch
and no fallback: a capture or replay error raises.

What makes a round capturable:

* every host value a round reads (lengths, active slots, block tables,
  sampling knobs, seed words, prompt lengths) enters through
  ``RoundInputs``: device buffers allocated once and filled with
  ``copy_`` before the round, outside any capture. No round function
  copies from the host (a copy node would re-read a freed pinned buffer
  at every replay);
* a round reads the engine's state (caches, pools, last tokens, seen
  sets, token buffers, totals) and writes its results back into the same
  tensors, so an admission between two replays is seen by the next one;
  its other outputs are the graph's own, rewritten by every replay, and
  the engine queues their copy to the host behind the replay;
* the first round of a key runs eagerly on the runner's side stream (the
  kernels build, the plan caches fill, the split-KV kernel's tickets are
  allocated for that stream), then the graph is captured on that stream
  into the one memory pool all of the engine's graphs share;
* the kernel wrappers count their launches in Python, which runs only
  while a graph is captured: the runner takes back what the capture
  counted and adds it again at every replay.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from kind_tpu_sim_torch.models.decode import _seed_words
from kind_tpu_sim_torch.ops import flash_attention as fa
from kind_tpu_sim_torch.ops import int8_matmul as im
from kind_tpu_sim_torch.ops import paged_attention as pa
from kind_tpu_sim_torch.ops import toolchain as tc


def _wrappers() -> tuple:
    """Every kernel wrapper that counts its launches."""
    return (fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, pa.paged_attention, im.int8_matmul,
            tc.matmul, tc.rms_norm, tc.softmax)


def launch_counts() -> List[Tuple[int, Dict[str, int]]]:
    """Each wrapper's (launches, launches by route), in ``_wrappers``
    order."""
    return [(w.launches, dict(w.launches_by_route)) for w in _wrappers()]


def take_launches(before) -> list:
    """The launches counted since ``launch_counts()`` returned
    ``before``, taken back off the counters. Returns them as
    ``add_launches`` adds them."""
    delta = []
    for w, (n, routes) in zip(_wrappers(), before):
        added = w.launches - n
        by_route = {r: c - routes.get(r, 0)
                    for r, c in w.launches_by_route.items()}
        w.launches = n
        for r, c in by_route.items():
            w.launches_by_route[r] -= c
        if added:
            delta.append((w, added, by_route))
    return delta


def add_launches(delta) -> None:
    """Count once more the launches ``take_launches`` returned."""
    for w, n, by_route in delta:
        w.launches += n
        for r, c in by_route.items():
            w.launches_by_route[r] += c


class RoundInputs:
    """The device buffers through which a round reads the host's
    per-round values, allocated once per engine: ``lengths`` (int32),
    ``active`` (bool), the sampling knobs, seed words and prompt lengths
    (``sampling``) and one block-table buffer per table width
    (``tables``). The fills are queued copies that wait for nothing: on a
    card each goes through pinned memory with ``non_blocking=True``."""

    def __init__(self, slots: int, device: torch.device):
        self.device = device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.lengths = zeros(slots, dtype=torch.int32)
        self.active = zeros(slots, dtype=torch.bool)
        self._sampling = (zeros(slots), zeros(slots, dtype=torch.int32),
                          zeros(slots), zeros(slots), zeros(slots),
                          zeros(slots, 2, dtype=torch.int64),
                          zeros(slots, dtype=torch.int64))
        self._tables: Dict[int, torch.Tensor] = {}

    def fill(self, buf: torch.Tensor, array) -> torch.Tensor:
        """Copy the host ``array`` into ``buf``; returns ``buf``. The
        host values are read now, so the caller may change its array
        while the copy is in flight."""
        host = torch.as_tensor(np.asarray(array)).to(buf.dtype)
        if buf.device.type == "cuda":
            buf.copy_(host.pin_memory(), non_blocking=True)
        else:
            buf.copy_(host)
        return buf

    def tables(self, host: np.ndarray) -> torch.Tensor:
        """The (slots, width) int32 buffer of ``host``'s width, filled
        with it."""
        buf = self._tables.get(host.shape[1])
        if buf is None:
            buf = torch.zeros(host.shape, dtype=torch.int32,
                              device=self.device)
            self._tables[host.shape[1]] = buf
        return self.fill(buf, host)

    def sampling(self, temp, top_k, top_p, min_p, rep_pen, seeds,
                 prompt_len) -> tuple:
        """The per-slot sampling state filled in: (temp, top_k, top_p,
        min_p, rep_pen, seed words (slots, 2), prompt_len), the tuple a
        sampled round reads."""
        hosts = (temp, top_k, top_p, min_p, rep_pen, _seed_words(seeds),
                 prompt_len)
        return tuple(self.fill(buf, h) for buf, h in zip(self._sampling,
                                                         hosts))


def eager(key, fn: Callable[[], Any]):
    """The round run as the Python it is: the CPU's path, and what a
    test on the card rebinds an engine's ``_round`` to, to hold its
    graphs against it."""
    return fn()


class _Graph(NamedTuple):
    graph: Any               # torch.cuda.CUDAGraph
    outputs: tuple           # the graph's output tensors
    launches: list           # take_launches' record of one round
    keep: tuple              # tensors the graph reads that nothing else
    #                          keeps alive


class RoundGraphs:
    """One engine's rounds on a card: a CUDA graph a key, captured the
    first time the key is seen and replayed on the current stream after
    that. All of the engine's graphs share one memory pool (rounds never
    overlap), so the graphs hold one round's peak of memory.
    ``captured``, ``capture_s`` (seconds spent capturing, the eager
    warm-up rounds excluded) and ``replays`` say what it did."""

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: Dict[Any, _Graph] = {}
        self._stream = None
        self._pool = None
        self.capture_s = 0.0
        self.replays = 0

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def __call__(self, key, fn: Callable[[], Any]):
        entry = self._graphs.get(key)
        if entry is None:
            return self._warm_and_capture(key, fn)
        entry.graph.replay()
        add_launches(entry.launches)
        self.replays += 1
        return entry.outputs

    def _warm_and_capture(self, key, fn):
        """Run this round eagerly on the side stream, then capture the
        next ones' graph on it. Returns the eager round's outputs."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outputs = fn()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            # no synchronize around the capture (torch.cuda.graph's
            # context has one): a round's dispatch must not wait. No
            # garbage collection inside it either: a collected engine
            # would destroy its graphs, a CUDA call the capture forbids
            collecting = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=self._pool)
                try:
                    static = fn()
                finally:
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            launches = take_launches(before)
            self.capture_s += time.perf_counter() - t0
        main.wait_stream(side)
        for t in outputs:
            t.record_stream(main)
        # the split-KV kernel's tickets for the side stream: a later call
        # on a stream of that handle that needs more tickets replaces
        # them in the wrappers' table, and the graph keeps the ones it
        # reads
        self._graphs[key] = _Graph(graph, tuple(static), launches,
                                   tuple(pa._TICKETS.values()))
        return outputs


def round_runner(device: torch.device):
    """What an engine on ``device`` runs its rounds through: graphs on a
    card, ``eager`` on the CPU."""
    return RoundGraphs(device) if device.type == "cuda" else eager
