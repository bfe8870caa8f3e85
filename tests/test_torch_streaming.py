"""Out-of-core streaming and realtime pipelines: the PyTorch port
(``threecrate_tpu_torch.parallel.streaming``) against the JAX package
on the CPU.

Stated tolerances: none for the voxel filter, whose accumulator lives
on the device as sorted keys with float64 sums: its rows equal the JAX
package's host dict's bit for bit and in its order (first chunk, then
key) at every chunking and scale tested, because a chunk's points are
summed per voxel in their order and then added to the running sum, as
the dict does. The statistics and the collector are the JAX package's
host NumPy code: equal. The realtime pipeline batches by time, so its
voxels are compared with the streaming filter's after sorting by key.
``tests/test_api.py::TestStreaming``'s cases run on the port as they
run on the JAX package there. Inputs come from numpy seeds, at most 16k
points.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import threecrate_tpu as tc  # noqa: E402
from threecrate_tpu.parallel import streaming as js  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch.parallel import streaming  # noqa: E402

CPU = {"device": "cpu"}


def _chunks(pts, size):
    return [pts[i:i + size] for i in range(0, len(pts), size)]


def _voxels(pipe_j, pipe_t, chunks):
    rj, sj = js.run_pipeline(chunks, pipe_j)
    rt, st = streaming.run_pipeline(chunks, pipe_t)
    assert (st.chunks, st.points, st.errors) == (sj.chunks, sj.points, sj.errors)
    assert pipe_t.memory_bytes() == pipe_j.memory_bytes()
    return rj.to_numpy(), rt


# ---------------------------------------------------------------------------
# tests/test_api.py::TestStreaming, on the port
# ---------------------------------------------------------------------------

class TestStreaming:
    def test_voxel_pipeline_matches_batch(self):
        rng = np.random.default_rng(0)
        pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
        chunks = [pts[i:i + 500] for i in range(0, 3000, 500)]
        pipe = streaming.StreamingVoxelFilter(0.5, origin=pts.min(0), **CPU)
        result, stats = streaming.run_pipeline(chunks, pipe)
        assert stats.chunks == 6 and stats.points == 3000
        batch = tt.voxel_grid_filter(tt.PointCloud.from_numpy(pts, **CPU), 0.5)
        assert len(result) == len(batch)
        assert pipe.memory_bytes() > 0
        assert result.device.type == "cpu"

    def test_statistics(self):
        rng = np.random.default_rng(1)
        pts = rng.normal(2.0, 1.0, (4000, 3)).astype(np.float32)
        chunks = [pts[i:i + 1000] for i in range(0, 4000, 1000)]
        result, _ = streaming.run_pipeline(chunks, streaming.StreamingStatistics())
        np.testing.assert_allclose(result["mean"], 2.0, atol=0.1)
        np.testing.assert_allclose(result["std"], 1.0, atol=0.1)
        assert result["count"] == 4000

    def test_skip_errors(self):
        class Bad:
            def process_chunk(self, c):
                raise ValueError("boom")

            def finalize(self):
                return "done"

            def memory_bytes(self):
                return 0
        result, stats = streaming.run_pipeline(
            [np.zeros((5, 3))], Bad(), streaming.RunOptions(skip_errors=True))
        assert stats.errors == 1 and result == "done"
        with pytest.raises(ValueError, match="boom"):
            streaming.run_pipeline([np.zeros((5, 3))], Bad())

    def test_device_map_stage(self):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(1000, 3)).astype(np.float32)
        seen = []

        def fn(p, m):
            seen.append((tuple(p.shape), p.dtype, p.device.type, int(m.sum())))
            return p * 2.0
        stage = streaming.StreamingDeviceMap(fn, chunk_capacity=512, **CPU)
        out, _ = streaming.run_pipeline([pts[:500], pts[500:]], stage)
        np.testing.assert_allclose(out, pts * 2, atol=1e-6)
        assert seen == [((512, 3), torch.float32, "cpu", 500)] * 2
        assert stage.memory_bytes() == out.nbytes + 512 * 16

    def test_realtime_backpressure_and_drops(self):
        rng = np.random.default_rng(3)
        pipe = streaming.StreamingCollector(**CPU)
        cfg = streaming.BackpressureConfig(max_queue_depth=4, chunk_size=64,
                                           flush_timeout_s=0.005)
        rt = streaming.RealtimePipeline(pipe, cfg)
        for _ in range(50):
            rt.send(rng.normal(size=(10, 3)).astype(np.float32))
        result = rt.finish()
        assert len(result) == 500
        assert rt.metrics.processed == 50
        assert rt.metrics.dropped == 0

    def test_realtime_processed_counts_flushed_only(self):
        """`processed` moves when the PIPELINE consumes a flush, not on
        dequeue: messages sitting in the pending flush buffer still count
        toward depth()."""
        class Gate:
            def process_chunk(self, c):
                pass

            def finalize(self):
                return None

            def memory_bytes(self):
                return 0
        cfg = streaming.BackpressureConfig(max_queue_depth=64, chunk_size=10**9,
                                           flush_timeout_s=60.0)
        rt = streaming.RealtimePipeline(Gate(), cfg)
        for _ in range(5):
            rt.send(np.zeros((4, 3), np.float32))
        deadline = time.time() + 5.0
        while rt._queue.qsize() > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert rt.metrics.queued == 5
        assert rt.metrics.processed == 0
        assert rt.metrics.depth() == 5
        rt.finish()
        assert rt.metrics.processed == 5
        assert rt.metrics.depth() == 0

    def test_realtime_try_send_drops(self):
        class Slow:
            def __init__(self):
                self.n = 0

            def process_chunk(self, c):
                time.sleep(0.05)
                self.n += len(c)

            def finalize(self):
                return self.n

            def memory_bytes(self):
                return 0
        cfg = streaming.BackpressureConfig(max_queue_depth=2, chunk_size=1,
                                           flush_timeout_s=0.001)
        rt = streaming.RealtimePipeline(Slow(), cfg)
        dropped = 0
        for _ in range(50):
            if not rt.try_send(np.zeros((1, 3), np.float32)):
                dropped += 1
        assert rt.finish() == 50 - dropped
        assert rt.metrics.dropped == dropped
        assert dropped > 0


# ---------------------------------------------------------------------------
# the device accumulator against the JAX package's dict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("chunk", [1, 7, 4096, None])
def test_voxel_filter_rows_and_order_match_jax(chunk, scale):
    """Rows bit-equal to the JAX package's and in its order, at chunk
    sizes 1, 7, 4,096 and the whole cloud; the voxel and the coordinates
    scale together, the origin sits off the grid."""
    rng = np.random.default_rng(int(scale * 1e3) % 97 + (chunk or 0))
    n = {1: 300, 7: 1000}.get(chunk, 16_000)
    pts = (rng.uniform(-5, 5, (n, 3)) * scale + 3.3 * scale).astype(np.float32)
    origin = np.array([0.1, -0.2, 0.05]) * scale
    j = js.StreamingVoxelFilter(0.5 * scale, origin)
    t = streaming.StreamingVoxelFilter(0.5 * scale, origin, **CPU)
    ref, got = _voxels(j, t, _chunks(pts, chunk or n))
    assert got.device.type == "cpu" and got.points.dtype == torch.float32
    assert 0 < len(ref) < n
    np.testing.assert_array_equal(got.to_numpy(), ref)


def test_voxel_filter_wide_keys_match_jax():
    """Keys whose spans cannot be packed into one int64 (a chunk spread
    over 1e15 voxels an axis) sort column by column: the same rows and
    order as JAX's."""
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-1e15, 1e15, (300, 3)),
                          rng.uniform(0, 2, (300, 3))]).astype(np.float32)
    chunks = _chunks(rng.permutation(pts), 97)
    ref, got = _voxels(js.StreamingVoxelFilter(0.5), streaming.StreamingVoxelFilter(0.5, **CPU),
                       chunks)
    np.testing.assert_array_equal(got.to_numpy(), ref)
    keys = torch.floor(torch.from_numpy(pts).double() / 0.5).long()
    span = (keys.amax(0) - keys.amin(0) + 1).double()
    assert float(span.prod()) > 2.0 ** 62


def test_voxel_filter_chunk_of_seen_voxels_matches_jax():
    """A chunk whose voxels were all seen before adds to their sums and
    leaves the order alone; so does a chunk that repeats earlier points."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 4, (3000, 3)).astype(np.float32)
    seen = (np.floor(pts[:1500] / 0.5) * 0.5 + 0.25).astype(np.float32)   # their centres
    chunks = [pts[:1500], pts[1500:], seen[::-1].copy(), pts[:1500]]
    j = js.StreamingVoxelFilter(0.5)
    t = streaming.StreamingVoxelFilter(0.5, **CPU)
    ref, got = _voxels(j, t, chunks[:2])
    n_voxels = len(ref)
    for c in chunks[2:]:
        j.process_chunk(c)
        t.process_chunk(c)
    ref, got = j.finalize().to_numpy(), t.finalize()
    assert len(ref) == n_voxels
    np.testing.assert_array_equal(got.to_numpy(), ref)


def test_voxel_filter_empty_stream_and_chunks_match_jax():
    j = js.StreamingVoxelFilter(0.25)
    t = streaming.StreamingVoxelFilter(0.25, **CPU)
    ref, got = _voxels(j, t, [])
    assert len(ref) == 0 and len(got) == 0 and t.memory_bytes() == 0
    empty = np.zeros((0, 3), np.float32)
    pts = np.random.default_rng(6).uniform(0, 2, (500, 3)).astype(np.float32)
    ref, got = _voxels(js.StreamingVoxelFilter(0.25), streaming.StreamingVoxelFilter(0.25, **CPU),
                       [empty, pts, empty, pts[::2]])
    np.testing.assert_array_equal(got.to_numpy(), ref)


def test_voxel_filter_rejects_bad_size_like_jax():
    for size in (0.0, -1.0):
        with pytest.raises(ValueError) as je:
            js.StreamingVoxelFilter(size)
        with pytest.raises(ValueError) as te:
            streaming.StreamingVoxelFilter(size, **CPU)
        assert str(te.value) == str(je.value)


def test_voxel_filter_keys_are_float64_floors():
    """Keys are floor((p − origin)/voxel) in float64: a point a float32
    ulp below a voxel face stays in the voxel below it, as in JAX."""
    face = np.float32(1.5)
    below = np.nextafter(face, np.float32(0))
    pts = np.array([[below, 0.1, 0.1], [face, 0.1, 0.1], [0.2, 0.1, 0.1]], np.float32)
    ref, got = _voxels(js.StreamingVoxelFilter(0.5), streaming.StreamingVoxelFilter(0.5, **CPU),
                       [pts])
    assert len(ref) == 3
    np.testing.assert_array_equal(got.to_numpy(), ref)


def test_statistics_and_collector_match_jax():
    rng = np.random.default_rng(7)
    chunks = _chunks(rng.normal(3.0, 2.0, (5000, 3)).astype(np.float32), 1234)
    rj, _ = js.run_pipeline(chunks, js.StreamingStatistics())
    rt, _ = streaming.run_pipeline(chunks, streaming.StreamingStatistics())
    assert sorted(rt) == sorted(rj)
    for k in rj:
        np.testing.assert_array_equal(rt[k], rj[k])
    cj, _ = js.run_pipeline(chunks, js.StreamingCollector())
    ct, _ = streaming.run_pipeline(chunks, streaming.StreamingCollector(**CPU))
    np.testing.assert_array_equal(ct.to_numpy(), cj.to_numpy())
    assert len(streaming.StreamingCollector(**CPU).finalize()) == 0


def test_device_map_runs_normals_like_jax():
    """The phase the card runs, at a small size: per-chunk normals of a
    padded chunk; the port's rows against the JAX package's (|cos| near
    1: both solve the same 10-neighbour covariances in fp32)."""
    rng = np.random.default_rng(8)
    xy = rng.uniform(-2, 2, (3000, 2))
    pts = np.stack([xy[:, 0], xy[:, 1], 0.3 * np.sin(xy[:, 0])], -1).astype(np.float32)
    chunks = _chunks(pts, 1024)

    def port_fn(p, m):
        return tt.estimate_normals(tt.PointCloud(p, m, {}), k=10).normals

    def jax_fn(p, m):
        return tc.estimate_normals(tc.PointCloud(p, m, {}), k=10).normals
    got, _ = streaming.run_pipeline(chunks, streaming.StreamingDeviceMap(port_fn, 1024, **CPU))
    ref, _ = js.run_pipeline(chunks, js.StreamingDeviceMap(jax_fn, 1024))
    assert got.shape == ref.shape == (3000, 3)
    cos = np.abs((got * ref).sum(1))
    assert cos.min() >= 0.9999


def test_device_map_rejects_a_chunk_over_capacity_like_jax():
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError) as je:
        js.StreamingDeviceMap(lambda p, m: p, 8).process_chunk(pts)
    with pytest.raises(ValueError) as te:
        streaming.StreamingDeviceMap(lambda p, m: p, 8, **CPU).process_chunk(pts)
    assert str(te.value) == str(je.value)


def test_realtime_voxel_filter_matches_the_streaming_filter():
    """Packets by blocking send: nothing dropped, every packet processed,
    and the same voxel keys, counts and centroids as the streaming
    filter on the same points, after sorting by key."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-10, 10, (16_000, 3)).astype(np.float32)
    rt = streaming.RealtimeVoxelFilter(0.5, **CPU)
    for packet in _chunks(pts, 512):
        rt.send(packet)
    got = rt.finish()
    assert rt.metrics.queued == rt.metrics.processed == 32 and rt.metrics.dropped == 0
    ref = streaming.StreamingVoxelFilter(0.5, **CPU)
    streaming.run_pipeline([pts], ref)

    def by_key(f):          # the keys are kept sorted, each with its sums' row
        return f._keys.numpy(), f._sums[f._rows].numpy()
    (k1, s1), (k2, s2) = by_key(rt.pipeline), by_key(ref)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1[:, 3], s2[:, 3])
    np.testing.assert_array_equal((s1[:, :3] / s1[:, 3:]).astype(np.float32),
                                  (s2[:, :3] / s2[:, 3:]).astype(np.float32))
    assert len(got) == len(k2)


def test_root_names_are_the_modules():
    for name in ("BackpressureConfig", "RealtimeMetrics", "RealtimePipeline",
                 "RealtimeVoxelFilter", "RunOptions", "RunStats", "StreamingCollector",
                 "StreamingStatistics", "StreamingVoxelFilter", "run_pipeline"):
        assert getattr(tt, name) is getattr(streaming, name) and name in tt.__all__
        assert getattr(tt.parallel, name) is getattr(streaming, name)
    # every other name is the JAX package's (its mesh and sharded modules)
    # or the port's own single-controller layer (Mesh, Sharded, collectives)
    from threecrate_tpu.parallel import mesh as jmesh, sharded as jsharded
    from threecrate_tpu_torch.parallel import collectives, mesh
    theirs = set(dir(js)) | set(dir(jmesh)) | set(dir(jsharded)) | set(dir(tc.parallel))
    ours = {"collectives", *collectives.__all__, *mesh.__all__}
    assert set(tt.parallel.__all__) <= theirs | ours
