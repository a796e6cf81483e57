"""Data pipeline: synthetic LM streams + the heterogeneous batch loader.

The counterpart of ``repro/data/pipeline.py``, copied verbatim (numpy):
token streams are byte-identical to the reference's.

`SyntheticLM` produces deterministic pseudo-random token batches (seeded per
step) with a learnable structure (a hidden Markov-ish next-token rule) so
losses actually *decrease* during the example runs — pure-noise tokens would
make convergence-time comparisons meaningless.

`HeteroBatchPartitioner` is the HeteroDataLoader of the paper (§4.5): given
the controller's per-node batch sizes it emits, per node, a contiguous index
range of the global batch; for the single-pjit-step realization it emits the
padded (n, b_max) layout plus the per-sample weight vector of
core/aggregation.sample_weights, which makes one weighted-loss step
equivalent to Eq. (9).

`BoundedStream` is the streaming face of the same sources: a bounded-buffer
iterator over step-indexed batches (optionally produced by a background
thread) that the serving request layer consumes for prompt tokens
(:func:`repro_torch.serving.request.prompts_from_stream`) — batch *content* is a
pure function of the step index, so the streaming view is byte-identical to
calling ``batch(step)`` directly, threaded or not.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.aggregation import padded_batch_layout, sample_weights

__all__ = ["SyntheticLM", "HeteroBatchPartitioner", "NodeBatch", "BoundedStream"]


class SyntheticLM:
    """Deterministic synthetic token stream with learnable bigram structure."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0, order: int = 3):
        self.vocab = vocab
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # A fixed permutation defines the "true" next token; corruption adds
        # irreducible entropy.
        self.rule = rng.permutation(vocab)
        self.noise = 0.3

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        for t in range(1, self.seq_len + 1):
            nxt = self.rule[toks[:, t - 1]]
            corrupt = rng.random(batch_size) < self.noise
            nxt = np.where(corrupt, rng.integers(0, self.vocab, batch_size), nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def stream(
        self,
        batch_size: int,
        *,
        start: int = 0,
        steps: Optional[int] = None,
        depth: int = 4,
        threaded: bool = False,
    ) -> "BoundedStream":
        """Streaming view over :meth:`batch`: yields ``batch(start)``,
        ``batch(start + 1)``, ... through a bounded buffer.  Content is
        byte-identical to the step-indexed calls (regression-tested)."""
        return BoundedStream(
            lambda step: self.batch(step, batch_size),
            start=start,
            steps=steps,
            depth=depth,
            threaded=threaded,
        )


class BoundedStream:
    """Bounded-buffer iterator over a step-indexed batch source.

    ``source(step)`` must be a pure function of ``step`` — that is what makes
    the streaming view reproducible and lets the threaded mode exist at all:
    the producer thread only changes *when* batches are computed, never what
    they contain.  ``depth`` bounds the number of precomputed batches held in
    memory (backpressure); ``steps=None`` streams forever.

    Threaded mode prefetches from a daemon producer thread through a
    ``queue.Queue(maxsize=depth)``; ``close()`` (or exhaustion, or the
    context manager) shuts it down.  Unthreaded mode computes lazily on
    ``next()`` — same contents, no concurrency.
    """

    _END = object()

    def __init__(
        self,
        source: Callable[[int], Dict[str, np.ndarray]],
        *,
        start: int = 0,
        steps: Optional[int] = None,
        depth: int = 4,
        threaded: bool = False,
    ):
        if depth < 1:
            raise ValueError("buffer depth must be >= 1")
        if steps is not None and steps < 0:
            raise ValueError("steps must be >= 0")
        self._source = source
        self._step = int(start)
        self._end = None if steps is None else int(start) + int(steps)
        self._closed = False
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self._queue = queue.Queue(maxsize=int(depth))
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up promptly once the stream is closed."""
        while not self._closed:
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        step = self._step
        try:
            while not self._closed and (self._end is None or step < self._end):
                if not self._put(self._source(step)):
                    return
                step += 1
            self._put(self._END)
        except BaseException as exc:  # surface in the consumer, not the thread
            self._put(exc)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._closed:
            raise StopIteration
        if self._queue is not None:
            item = self._queue.get()
            if item is self._END:
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self.close()
                raise item
            return item
        if self._end is not None and self._step >= self._end:
            raise StopIteration
        batch = self._source(self._step)
        self._step += 1
        return batch

    def close(self) -> None:
        """Stop the producer (if any) and drop buffered batches."""
        self._closed = True
        if self._queue is not None:
            # Unblock a producer waiting on a full queue, then drain.
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            if self._thread is not None and self._thread.is_alive():
                self._thread.join(timeout=1.0)

    def __enter__(self) -> "BoundedStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass(frozen=True)
class NodeBatch:
    """One node's share of a global batch."""

    node: int
    start: int              # global-batch row offset
    size: int               # b_i
    tokens: np.ndarray      # (b_i, S)
    labels: np.ndarray
    ratio: float            # r_i = b_i / B


class HeteroBatchPartitioner:
    """Splits a global batch into uneven per-node local batches.

    Two views:
      * `split(batch, sizes)` — list of NodeBatch (per-node runtime view,
        used by the simulator/examples).
      * `padded(batch, sizes)` — (stacked (n, b_max, S) arrays, per-sample
        weights (n, b_max)) — the single-pjit-step view; the weight vector
        makes a weighted-SUM loss equal to Eq. (9).
    """

    @staticmethod
    def split(batch: Dict[str, np.ndarray], sizes: Sequence[int]) -> List[NodeBatch]:
        total = int(sum(sizes))
        if total != batch["tokens"].shape[0]:
            raise ValueError(
                f"partition sizes sum {total} != global batch {batch['tokens'].shape[0]}"
            )
        out, ofs = [], 0
        for i, b in enumerate(sizes):
            out.append(
                NodeBatch(
                    node=i,
                    start=ofs,
                    size=int(b),
                    tokens=batch["tokens"][ofs : ofs + b],
                    labels=batch["labels"][ofs : ofs + b],
                    ratio=b / total,
                )
            )
            ofs += b
        return out

    @staticmethod
    def padded(
        batch: Dict[str, np.ndarray], sizes: Sequence[int]
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        total = int(sum(sizes))
        if total != batch["tokens"].shape[0]:
            raise ValueError("partition sizes do not sum to the global batch")
        b_max, mask = padded_batch_layout(sizes)
        n = len(sizes)
        seq = batch["tokens"].shape[1]
        tok = np.zeros((n, b_max, seq), np.int32)
        lab = np.zeros((n, b_max, seq), np.int32)
        ofs = 0
        for i, b in enumerate(sizes):
            tok[i, :b] = batch["tokens"][ofs : ofs + b]
            lab[i, :b] = batch["labels"][ofs : ofs + b]
            ofs += b
        weights = sample_weights(sizes)  # (n, b_max), rows sum to b_i/B
        return {"tokens": tok, "labels": lab}, weights
