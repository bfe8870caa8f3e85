"""Out-of-core streaming & realtime pipelines.

Counterpart of ``threecrate_tpu.parallel.streaming``, covering
threecrate-algorithms/src/streaming.rs:

* ``StreamingPipeline`` (streaming.rs:74-92): process_chunk/finalize/
  memory accounting over chunked sources, with the ``run_pipeline``
  driver, RunStats and skip_errors (:98-144);
* built-ins: StreamingVoxelFilter (voxel accumulator with O(voxels)
  memory, :197-242), StreamingStatistics (:308), StreamingCollector
  (:382), and StreamingDeviceMap, a user function over fixed-shape
  padded chunks on the card;
* ``RealtimePipeline`` (:440-640): bounded queue + background worker,
  blocking ``send`` (backpressure) vs dropping ``try_send``, counted
  RealtimeMetrics{queued, processed, dropped, depth} and a
  flush-timeout latency bound.

Chunks arrive as host NumPy arrays. The voxel filter's accumulator
lives on ``device`` (the card unless the caller asks for the CPU)
between chunks: int64 voxel keys in sorted order and float64 sums and
counts; each chunk is reduced by a sort and segment sums and merged by
a search of the sorted keys, never by a host loop. The statistics and
the collector stay on the host, as in the JAX package. The realtime side is a host thread and a queue
feeding the same ``process_chunk``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, List, Optional, Protocol

import numpy as np
import torch

from ..core.point_cloud import PointCloud
from ..utils import padding


# ---------------------------------------------------------------------------
# streaming pipeline protocol + driver
# ---------------------------------------------------------------------------

class StreamingPipeline(Protocol):
    """streaming.rs:74-92."""

    def process_chunk(self, chunk: np.ndarray) -> None: ...

    def finalize(self): ...

    def memory_bytes(self) -> int: ...


@dataclasses.dataclass
class RunStats:
    """streaming.rs:98-104."""

    chunks: int = 0
    points: int = 0
    errors: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class RunOptions:
    skip_errors: bool = False


def run_pipeline(source: Iterable[np.ndarray], pipeline: StreamingPipeline,
                 options: RunOptions = RunOptions()):
    """Driver (run_pipeline_with_options, streaming.rs:98-144):
    returns (result, RunStats)."""
    stats = RunStats()
    t0 = time.perf_counter()
    for chunk in source:
        try:
            pipeline.process_chunk(np.asarray(chunk, np.float32))
            stats.chunks += 1
            stats.points += len(chunk)
        except Exception:
            stats.errors += 1
            if not options.skip_errors:
                raise
    result = pipeline.finalize()
    stats.seconds = time.perf_counter() - t0
    return result, stats


# ---------------------------------------------------------------------------
# built-in pipelines
# ---------------------------------------------------------------------------

def _packed(keys: torch.Tensor, lo, span):
    """The (n, 3) int64 rows packed into one int64 in mixed radix, each
    column offset to its minimum ``lo`` over its ``span`` (host ints), so
    that the packed order is the rows' lexicographic order; None when
    the spans' product does not fit."""
    if span[0] * span[1] * span[2] >= 2 ** 62:
        return None
    return ((keys[:, 0] - lo[0]) * span[1] + (keys[:, 1] - lo[1])) * span[2] \
        + (keys[:, 2] - lo[2])


def _lexsort_rows(keys: torch.Tensor, lo, span) -> torch.Tensor:
    """Stable order of the (n, 3) int64 rows of ``keys`` by (x, y, z):
    one stable sort of the packed rows, or, where they do not pack, one
    stable sort a column, the last column first."""
    packed = _packed(keys, lo, span)
    if packed is not None:
        return torch.argsort(packed, stable=True)
    order = torch.argsort(keys[:, 2], stable=True)
    order = order[torch.argsort(keys[order, 1], stable=True)]
    return order[torch.argsort(keys[order, 0], stable=True)]


def _reduce_by_key(keys: torch.Tensor, values: torch.Tensor, lo, span):
    """Sum the rows of ``values`` that share a key row, each run of equal
    keys in its input order: (sorted unique keys, sums)."""
    order = _lexsort_rows(keys, lo, span)
    k = keys[order]
    new = torch.ones(len(k), dtype=torch.bool, device=k.device)
    new[1:] = (k[1:] != k[:-1]).any(1)
    starts = torch.nonzero(new).flatten()
    lengths = torch.diff(starts, append=starts.new_full((1,), len(k)))
    return k[starts], torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0)


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b for (n, 3) int64 rows, lexicographically."""
    less = a[:, 0] < b[:, 0]
    tie = a[:, 0] == b[:, 0]
    less |= tie & (a[:, 1] < b[:, 1])
    tie &= a[:, 1] == b[:, 1]
    return less | (tie & (a[:, 2] < b[:, 2]))


def _lower_bound(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """For each query row, the first index of the lexicographically
    sorted ``rows`` that is not less than it: a binary search of all
    queries at once, one step a bit of ``len(rows)``."""
    n = len(rows)
    lo = torch.zeros(len(queries), dtype=torch.int64, device=rows.device)
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        mid = (lo + hi) // 2
        less = _lex_less(rows[mid.clamp(max=n - 1)], queries) & (lo < hi)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less | (lo >= hi), hi, mid)
    return lo


class StreamingVoxelFilter:
    """Out-of-core voxel downsample (streaming.rs:197-242): running
    (sum, count) per voxel key; memory O(occupied voxels), not O(points).

    The accumulator lives on ``device``: float64 [Σx, Σy, Σz, count]
    rows in the order the voxels first appeared (the JAX package's dict
    order: by chunk, then by key within a chunk), and the int64 voxel
    keys in sorted order with each one's row. A chunk's points are
    summed per voxel in their order (a sort and segment sums), its keys
    looked up in the sorted keys (``searchsorted`` on the keys packed
    into one int64 over the bounds seen so far, or, where they do not
    pack, a binary search of the rows), the sums of the voxels seen
    before added to their rows and the new voxels appended and merged
    into the sorted keys.
    """

    def __init__(self, voxel_size: float, origin=(0.0, 0.0, 0.0),
                 device="cuda"):
        if voxel_size <= 0:
            raise ValueError("voxel_size must be > 0")
        self.voxel = float(voxel_size)
        self.origin = np.asarray(origin, np.float64)
        self.device = torch.device(device)
        self._origin = torch.from_numpy(self.origin).to(self.device)
        # a divisor on the device: CUDA multiplies by the reciprocal of a
        # host scalar, which may floor a point into the next voxel
        self._voxel = torch.tensor(self.voxel, dtype=torch.float64, device=self.device)
        self._keys = torch.zeros((0, 3), dtype=torch.int64, device=self.device)
        self._rows = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self._lo = self._hi = None      # the keys' bounds so far, per column
        # the sums' rows live at the front of a buffer that doubles when full
        self._buffer = torch.zeros((1024, 4), dtype=torch.float64, device=self.device)
        self._sums = self._buffer[:0]

    def process_chunk(self, chunk: np.ndarray) -> None:
        pts = torch.as_tensor(np.asarray(chunk)).to(self.device)
        pts = pts.to(torch.float64).reshape(-1, 3)
        if len(pts) == 0:
            return
        keys = torch.floor((pts - self._origin) / self._voxel).to(torch.int64)
        bounds = torch.cat([keys.amin(0), keys.amax(0)]).tolist()
        lo, hi = bounds[:3], bounds[3:]
        ones = torch.ones((len(pts), 1), dtype=torch.float64, device=self.device)
        keys, sums = _reduce_by_key(keys, torch.cat([pts, ones], 1), lo,
                                    [b - a + 1 for a, b in zip(lo, hi)])
        self._lo = lo if self._lo is None else [min(a, b) for a, b in zip(self._lo, lo)]
        self._hi = hi if self._hi is None else [max(a, b) for a, b in zip(self._hi, hi)]
        span = [b - a + 1 for a, b in zip(self._lo, self._hi)]
        n = len(self._keys)
        state, query = _packed(self._keys, self._lo, span), _packed(keys, self._lo, span)
        pos = torch.searchsorted(state, query) if state is not None \
            else _lower_bound(self._keys, keys)
        seen = (pos < n) & (self._keys[pos.clamp(max=max(n - 1, 0))] == keys).all(1) \
            if n else torch.zeros(len(keys), dtype=torch.bool, device=self.device)
        if n:
            # each seen voxel's sum added to its row (the others add zeros,
            # which changes no sum)
            self._sums.index_add_(0, self._rows[pos.clamp(max=n - 1)],
                                  torch.where(seen[:, None], sums, 0.0))
        k = int((~seen).sum())
        if k == 0:
            return
        # the new keys in key order, and where they land among the old
        # ones: before the first old key not less than each, shifted by
        # the new keys before them; each old key moves up by the new keys
        # placed before it
        new = torch.argsort(seen.to(torch.int8), stable=True)[:k]
        pos_new = pos[new]
        at = pos_new + torch.arange(k, device=self.device)
        old = torch.arange(n, device=self.device)
        old = old + torch.searchsorted(pos_new, old, right=True)
        merged = torch.empty((n + k, 3), dtype=torch.int64, device=self.device)
        merged[at] = keys[new]
        merged[old] = self._keys
        rows = torch.empty(n + k, dtype=torch.int64, device=self.device)
        rows[at] = torch.arange(n, n + k, device=self.device)
        rows[old] = self._rows
        self._keys, self._rows = merged, rows
        if n + k > len(self._buffer):
            grown = torch.zeros((max(2 * len(self._buffer), n + k), 4), dtype=torch.float64,
                                device=self.device)
            grown[:n] = self._sums
            self._buffer = grown
        self._buffer[n:n + k] = sums[new]
        self._sums = self._buffer[:n + k]

    def finalize(self) -> PointCloud:
        n = len(self._sums)
        if n == 0:
            return PointCloud.empty(device=self.device)
        cap = padding.pad_capacity(n)
        pts = torch.zeros((cap, 3), dtype=torch.float32, device=self.device)
        pts[:n] = (self._sums[:, :3] / self._sums[:, 3:]).to(torch.float32)
        mask = torch.arange(cap, device=self.device) < n
        return PointCloud(pts, mask, {})

    def memory_bytes(self) -> int:
        return len(self._sums) * (3 * 8 + 8 + 24)


class StreamingStatistics:
    """Running bbox/mean/count over chunks (streaming.rs:308)."""

    def __init__(self) -> None:
        self.count = 0
        self._sum = np.zeros(3, np.float64)
        self._sq = np.zeros(3, np.float64)
        self._min = np.full(3, np.inf)
        self._max = np.full(3, -np.inf)

    def process_chunk(self, chunk: np.ndarray) -> None:
        self.count += len(chunk)
        self._sum += chunk.sum(0)
        self._sq += (chunk.astype(np.float64) ** 2).sum(0)
        self._min = np.minimum(self._min, chunk.min(0))
        self._max = np.maximum(self._max, chunk.max(0))

    def finalize(self) -> dict:
        n = max(self.count, 1)
        mean = self._sum / n
        var = np.maximum(self._sq / n - mean ** 2, 0.0)
        return {"count": self.count, "mean": mean, "std": np.sqrt(var),
                "min": self._min, "max": self._max}

    def memory_bytes(self) -> int:
        return 14 * 8


class StreamingCollector:
    """Accumulate all chunks (streaming.rs:382) — for tests/debug; the
    result is a cloud on ``device``."""

    def __init__(self, device="cuda") -> None:
        self.device = device
        self._chunks: List[np.ndarray] = []

    def process_chunk(self, chunk: np.ndarray) -> None:
        self._chunks.append(np.asarray(chunk, np.float32))

    def finalize(self) -> PointCloud:
        if not self._chunks:
            return PointCloud.empty(device=self.device)
        return PointCloud.from_numpy(np.concatenate(self._chunks),
                                     device=self.device)

    def memory_bytes(self) -> int:
        return sum(c.nbytes for c in self._chunks)


class StreamingDeviceMap:
    """Run a per-chunk function on fixed-shape padded tensors on
    ``device``: ``fn(points (capacity, 3) float32, mask (capacity,)
    bool)`` returns per-point rows, of which the chunk's own come back
    to the host (the reference's analog is chunked rayon work)."""

    def __init__(self, fn: Callable, chunk_capacity: int = 65536,
                 device="cuda"):
        self.capacity = chunk_capacity
        self.device = device
        self._fn = fn
        self._out: List[np.ndarray] = []

    def process_chunk(self, chunk: np.ndarray) -> None:
        n = len(chunk)
        pts = padding.pad_array(chunk.astype(np.float32), self.capacity)
        mask = padding.make_mask(n, self.capacity)
        out = self._fn(torch.from_numpy(pts).to(self.device),
                       torch.from_numpy(mask).to(self.device))
        self._out.append(out[:n].cpu().numpy())

    def finalize(self) -> np.ndarray:
        return (np.concatenate(self._out) if self._out
                else np.zeros((0, 3), np.float32))

    def memory_bytes(self) -> int:
        return sum(o.nbytes for o in self._out) + self.capacity * 16


# ---------------------------------------------------------------------------
# realtime pipeline (bounded queue + worker thread + metrics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackpressureConfig:
    """streaming.rs:449-463."""

    max_queue_depth: int = 1024
    chunk_size: int = 256
    flush_timeout_s: float = 0.010


@dataclasses.dataclass
class RealtimeMetrics:
    """streaming.rs:467-505 (atomics → a lock'd counter block)."""

    queued: int = 0
    processed: int = 0
    dropped: int = 0

    def depth(self) -> int:
        return self.queued - self.processed


class RealtimePipeline:
    """Bounded-queue realtime ingestion (streaming.rs:440-640).

    ``send`` blocks when the queue is full (backpressure); ``try_send``
    drops and counts. A background worker batches points into
    ``chunk_size`` chunks, flushing partial chunks after
    ``flush_timeout_s`` to bound latency.
    """

    def __init__(self, pipeline: StreamingPipeline,
                 config: BackpressureConfig = BackpressureConfig()):
        self.pipeline = pipeline
        self.config = config
        self.metrics = RealtimeMetrics()
        self._lock = threading.Lock()
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=config.max_queue_depth)
        self._result = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- producer side -----------------------------------------------------
    def send(self, points: np.ndarray) -> None:
        """Blocking send — applies backpressure when the queue is full."""
        self._queue.put(np.asarray(points, np.float32))
        with self._lock:
            self.metrics.queued += 1

    def try_send(self, points: np.ndarray) -> bool:
        """Non-blocking send — drops (and counts) on overflow."""
        try:
            self._queue.put_nowait(np.asarray(points, np.float32))
        except queue.Full:
            with self._lock:
                self.metrics.dropped += 1
            return False
        with self._lock:
            self.metrics.queued += 1
        return True

    def finish(self, timeout: Optional[float] = 30.0):
        """Close the stream, join the worker, return finalize() result."""
        self._queue.put(None)
        self._worker.join(timeout=timeout)
        return self._result

    # -- worker side -------------------------------------------------------
    def _run(self) -> None:
        buf: List[np.ndarray] = []
        buffered = 0
        last_flush = time.perf_counter()

        def flush():
            nonlocal buf, buffered, last_flush
            if buf:
                batch = np.concatenate(buf)
                self.pipeline.process_chunk(batch)
                # `processed` counts messages the PIPELINE has consumed
                # (streaming.rs:470-472 items_processed), so it moves at
                # flush time — messages sitting in the pending flush
                # buffer still count toward depth().
                with self._lock:
                    self.metrics.processed += len(buf)
            buf, buffered = [], 0
            last_flush = time.perf_counter()

        while True:
            timeout = max(self.config.flush_timeout_s -
                          (time.perf_counter() - last_flush), 1e-4)
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                flush()
                continue
            if item is None:
                flush()
                self._result = self.pipeline.finalize()
                return
            buf.append(item)
            buffered += len(item)
            if buffered >= self.config.chunk_size:
                flush()


class RealtimeVoxelFilter(RealtimePipeline):
    """Sensor-rate voxel downsampling (the reference python API's
    RealtimeVoxelFilter class, threecrate-python/src/lib.rs): a
    RealtimePipeline pre-wired with a StreamingVoxelFilter on
    ``device``."""

    def __init__(self, voxel_size: float,
                 config: BackpressureConfig = BackpressureConfig(),
                 origin=(0.0, 0.0, 0.0), device="cuda"):
        super().__init__(StreamingVoxelFilter(voxel_size, origin, device),
                         config)
