"""TriangleMesh and the data-model leftovers: the PyTorch port
(``threecrate_tpu_torch.core.mesh``, ``core.point_cloud``,
``utils.padding``, ``core.errors.require``, ``ops.linalg.kabsch_from_sums``
and ``ops.neighbors.knn(recall_target=...)``) against the JAX package on
the same seeded inputs, on the CPU.

The mesh is the JAX package's marching-cubes sphere at 24³, passed to
both packages' ``from_numpy``. Stated tolerances:
- counts, masks, faces, ``to_numpy`` and ``attr_to_numpy`` equal; the
  capacities follow each package's padding policy (the port keeps no
  geometric buckets: ``pad_capacity`` is the lane round-up);
- triangles, bounding box and centre equal; face normals, areas and the
  area-weighted vertex normals within 1e-6; a rigid transform within
  1e-5 (the 4x4 products run in other orders);
- the validation errors' types and messages equal;
- padding helpers, masked reductions and the PointCloud leftovers equal;
  ``kabsch_from_sums`` within 1e-5;
- ``knn(recall_target=0.9)`` on 500 points at k = 5: ids equal to JAX's
  and to the port's exact call, squared distances within 1e-6 of JAX's
  (JAX's approximate top-k is exact off the TPU; the port's is always
  exact). The expanded d² = ‖q‖² + ‖p‖² − 2 q·p cancels differently in
  the two packages: measured 4.8e-7 at recall_target 1.0 and 0.9 alike,
  which the square root turns into up to 6.9e-4 on a self pair's zero.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import threecrate_tpu as jt  # noqa: E402
from threecrate_tpu.core import errors as jerrors  # noqa: E402
from threecrate_tpu.core.mesh import TriangleMesh as JMesh  # noqa: E402
from threecrate_tpu.core.transform import Transform as JTransform  # noqa: E402
from threecrate_tpu.ops import linalg as jlinalg  # noqa: E402
from threecrate_tpu.ops import neighbors as jneighbors  # noqa: E402
from threecrate_tpu.utils import padding as jpadding  # noqa: E402

import threecrate_tpu_torch as tt  # noqa: E402
from threecrate_tpu_torch import interop  # noqa: E402
from threecrate_tpu_torch.core import COLORS, INTENSITY, errors as terrors  # noqa: E402
from threecrate_tpu_torch.core.mesh import TriangleMesh as TMesh  # noqa: E402
from threecrate_tpu_torch.ops import linalg as tlinalg  # noqa: E402
from threecrate_tpu_torch.ops import neighbors as tneighbors  # noqa: E402
from threecrate_tpu_torch.utils import padding as tpadding  # noqa: E402

JM = importlib.import_module("threecrate_tpu.reconstruction.marching_cubes")

torch.set_num_threads(2)   # the suite runs several workers per host


@pytest.fixture(scope="module")
def meshes():
    v, f = JM.marching_cubes(JM.create_sphere_volume(24), 0.0).to_numpy()
    rng = np.random.default_rng(0)
    colors = rng.uniform(0, 1, v.shape).astype(np.float32)
    normals = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    return (JMesh.from_numpy(v, f, normals=normals, colors=colors),
            TMesh.from_numpy(v, f, normals=normals, colors=colors, device="cpu"), v, f)


def _rows(a, b, rows):
    """The first ``rows`` rows of JAX's ``a`` and the port's ``b``."""
    return np.asarray(a)[:rows], b[:rows].numpy()


def test_from_numpy_counts_and_round_trip(meshes):
    jm, tm, v, f = meshes
    assert int(tm.vertex_count()) == int(jm.vertex_count()) == len(v)
    assert int(tm.face_count()) == int(jm.face_count()) == len(f)
    assert tm.vertex_count().dtype == torch.int32 and not bool(tm.is_empty())
    assert tm.vertex_capacity == tpadding.round_up(len(v))
    assert tm.face_capacity == tpadding.round_up(len(f))
    for a, b in zip(tm.to_numpy(), jm.to_numpy()):
        np.testing.assert_array_equal(a, b)
    for key in ("normals", "colors"):
        np.testing.assert_array_equal(tm.attr_to_numpy(key), jm.attr_to_numpy(key))
    np.testing.assert_array_equal(tm.normals[:len(v)].numpy(), np.asarray(jm.normals)[:len(v)])
    np.testing.assert_array_equal(tm.colors[:len(v)].numpy(), np.asarray(jm.colors)[:len(v)])
    assert tm.faces.dtype == torch.int32 and tm.vertices.dtype == torch.float32


def test_empty_matches_jax():
    jm, tm = JMesh.empty(), TMesh.empty(device="cpu")
    assert (tm.vertex_capacity, tm.face_capacity) == (jm.vertex_capacity, jm.face_capacity)
    assert int(tm.face_count()) == 0 and bool(tm.is_empty()) and bool(jm.is_empty())
    v, f = tm.to_numpy()
    assert v.shape == (0, 3) and f.shape == (0, 3)
    assert TMesh.empty(7, 9, device="cpu").faces.shape == (9, 3)


@pytest.mark.parametrize("case", ["vertices", "faces", "range", "normals"])
def test_from_numpy_errors_match_jax(case):
    v = np.zeros((4, 3), np.float32)
    f = np.array([[0, 1, 2], [1, 2, 3]], np.int32)
    kw = {}
    if case == "vertices":
        v = np.zeros((4, 2), np.float32)
    elif case == "faces":
        f = np.zeros((2, 4), np.int32)
    elif case == "range":
        f = np.array([[0, 1, 4]], np.int32)
    else:
        kw = {"normals": np.zeros((3, 3), np.float32)}
    with pytest.raises(jerrors.InvalidDataError) as je:
        JMesh.from_numpy(v, f, **kw)
    with pytest.raises(tt.InvalidDataError) as te:
        TMesh.from_numpy(v, f, device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_geometry_matches_jax(meshes):
    jm, tm, v, f = meshes
    nf = len(f)
    np.testing.assert_array_equal(tm.triangles()[:nf].numpy(), np.asarray(jm.triangles())[:nf])
    for norm in (True, False):
        a, b = _rows(jm.face_normals(norm), tm.face_normals(norm), tm.face_capacity)
        np.testing.assert_allclose(b[:nf], a[:nf], rtol=0, atol=1e-6)
        assert not b[nf:].any()
    a, b = _rows(jm.face_areas(), tm.face_areas(), nf)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    jn = jm.compute_vertex_normals().attr_to_numpy("normals")
    tn = tm.compute_vertex_normals().attr_to_numpy("normals")
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-6)
    for a, b in zip(tm.bounding_box(), jm.bounding_box()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.center().numpy(), np.asarray(jm.center()))


def test_functional_updates_match_jax(meshes):
    jm, tm, v, f = meshes
    n = np.random.default_rng(1).normal(size=(tm.vertex_capacity, 3)).astype(np.float32)
    out = tm.set_normals(n).set_colors(np.abs(n))
    assert torch.equal(out.normals, torch.from_numpy(n))
    assert torch.equal(out.colors, torch.from_numpy(np.abs(n)))
    with pytest.raises(tt.InvalidDataError, match="normals shape"):
        tm.set_normals(n[:-1])
    with pytest.raises(tt.InvalidDataError, match="colors shape"):
        tm.set_colors(n[:, :2])
    moved = tm.with_vertices(tm.vertices + 1.0)
    assert torch.equal(moved.faces, tm.faces) and moved.attrs is tm.attrs
    assert set(tm.with_attr("uv", tm.vertices[:, :2]).attrs) == {"normals", "colors", "uv"}
    cloud = tm.as_point_cloud()
    assert isinstance(cloud, tt.PointCloud) and len(cloud) == len(v)
    np.testing.assert_array_equal(cloud.to_numpy(), jm.as_point_cloud().to_numpy())
    m = np.asarray(JTransform.from_euler_xyz(jnp.asarray([0.3, -0.2, 0.1]),
                                             jnp.asarray([1.0, 2.0, 3.0])).matrix)
    jt_ = jm.transform(JTransform(jnp.asarray(m)))
    tt_ = tm.transform(tt.Transform(torch.from_numpy(m.copy())))
    np.testing.assert_allclose(tt_.to_numpy()[0], jt_.to_numpy()[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt_.attr_to_numpy("normals"), jt_.attr_to_numpy("normals"),
                               rtol=0, atol=1e-5)


def test_padding_helpers_match_jax():
    for n in (0, 1, 127, 128, 129, 1000):
        assert tpadding.pad_capacity(n) == jpadding.pad_capacity(n, geometric=False)
        assert tpadding.pad_capacity(n, 64, geometric=True) == jpadding.pad_capacity(
            n, 64, geometric=False)
        assert tpadding.pad_capacity(n) >= n
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(tpadding.pad_array(x, 6, fill=-1.0),
                                  jpadding.pad_array(x, 6, fill=-1.0))
    np.testing.assert_array_equal(tpadding.make_mask(3, 5), jpadding.make_mask(3, 5))
    with pytest.raises(ValueError, match="exceeds capacity"):
        tpadding.pad_array(x, 2)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.uniform(size=50) < 0.6
    for fn in ("masked_min", "masked_max", "masked_mean"):
        for arr in (pts, pts[:, 0]):
            got = getattr(tpadding, fn)(torch.from_numpy(arr), torch.from_numpy(mask))
            ref = getattr(jpadding, fn)(jnp.asarray(arr), jnp.asarray(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    for a, b in zip(tpadding.bounding_box(torch.from_numpy(pts), torch.from_numpy(mask)),
                    jpadding.bounding_box(jnp.asarray(pts), jnp.asarray(mask))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    col = rng.uniform(size=(300, 3)).astype(np.float32)
    inten = rng.uniform(size=300).astype(np.float32)
    return (jt.PointCloud.from_numpy(pts, colors=col, intensity=inten),
            tt.PointCloud.from_numpy(pts, colors=col, intensity=inten, device="cpu"),
            pts, col)


def test_point_cloud_leftovers_match_jax(clouds):
    jc, tc, pts, col = clouds
    assert (COLORS, INTENSITY) == ("colors", "intensity")
    assert int(tc.size()) == int(jc.size()) == 300 and tc.size().dtype == torch.int32
    assert not bool(tc.is_empty()) and tc.has(COLORS) and not tc.has("normals")
    np.testing.assert_array_equal(tc.colors[:300].numpy(), col)
    np.testing.assert_array_equal(tc.attr_to_numpy(INTENSITY), jc.attr_to_numpy(INTENSITY))
    np.testing.assert_array_equal(tc.center().numpy(), np.asarray(jc.center()))
    np.testing.assert_allclose(tc.centroid().numpy(), np.asarray(jc.centroid()), rtol=0,
                               atol=1e-6)
    empty = tt.PointCloud.empty(device="cpu")
    assert empty.capacity == jt.PointCloud.empty().capacity and bool(empty.is_empty())
    src = torch.from_numpy(pts)
    wrapped = tt.PointCloud.from_points(src, colors=torch.from_numpy(col))
    assert wrapped.points.data_ptr() == src.data_ptr() and len(wrapped) == 300
    assert wrapped.mask.all() and wrapped.has(COLORS)
    assert torch.equal(tc.with_colors(tc.points).colors, tc.points)
    assert torch.equal(tc.with_points(tc.points * 2).points, tc.points * 2)


def test_extend_and_pack_match_jax(clouds):
    jc, tc, pts, col = clouds
    keep = np.random.default_rng(4).uniform(size=jc.capacity) < 0.5
    jsel = jc.select(jnp.asarray(keep))
    tsel = tc.select(torch.from_numpy(keep))
    jo = jt.PointCloud.from_numpy(pts[:40] + 5, normals=pts[:40])
    to = tt.PointCloud.from_numpy(pts[:40] + 5, normals=pts[:40], device="cpu")
    for je, te in ((jsel.extend(jo), tsel.extend(to)), (jsel + jo, tsel + to)):
        assert te.capacity == je.capacity and set(te.attrs) == set(je.attrs)
        np.testing.assert_array_equal(te.mask.numpy(), np.asarray(je.mask))
        np.testing.assert_array_equal(te.to_numpy(), je.to_numpy())
        for k in te.attrs:
            np.testing.assert_array_equal(te.attrs[k].numpy(), np.asarray(je.attrs[k]))
    jp, tp = jsel.pack(), tsel.pack()
    np.testing.assert_array_equal(tp.points.numpy(), np.asarray(jp.points))
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_array_equal(tp.colors.numpy(), np.asarray(jp.colors))


def test_require_matches_jax():
    terrors.require(True, "never")
    with pytest.raises(tt.InvalidDataError, match="bad input"):
        terrors.require(False, "bad input")
    with pytest.raises(tt.AlgorithmError, match="diverged"):
        terrors.require(False, "diverged", tt.AlgorithmError)
    assert tt.core.require is terrors.require


def test_kabsch_from_sums_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.normal(size=(200, 3)).astype(np.float32)
    m = np.asarray(JTransform.from_euler_xyz(jnp.asarray([0.2, 0.1, -0.3]),
                                             jnp.asarray([0.5, -1.0, 2.0])).matrix)
    t = s @ m[:3, :3].T + m[:3, 3]
    w = rng.uniform(0.5, 1.0, 200).astype(np.float32)
    sums = (w.sum(), (s * w[:, None]).sum(0), (t * w[:, None]).sum(0),
            np.einsum("ni,nj,n->ij", s, t, w))
    ref = np.asarray(jlinalg.kabsch_from_sums(*(jnp.asarray(x) for x in sums)))
    got = tlinalg.kabsch_from_sums(*(torch.as_tensor(np.asarray(x, np.float32))
                                     for x in sums))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), m, rtol=0, atol=1e-4)


def test_knn_recall_target_matches_jax():
    pts = np.random.default_rng(6).uniform(-1, 1, (500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    ref = jneighbors.knn(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), None, 5,
                         recall_target=0.9)
    got = tneighbors.knn(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(pts),
                         None, 5, recall_target=0.9)
    assert got.indices.shape == (500, 5)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(got.distances.numpy() ** 2, np.asarray(ref.distances) ** 2,
                               rtol=0, atol=1e-6)
    exact = tt.knn(torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(pts), None, 5)
    assert torch.equal(exact.indices, got.indices)


def test_interop_carries_meshes_grids_and_configs(meshes):
    """A JAX mesh read as numpy arrays becomes a port mesh of the same
    capacities whose vertex normals equal JAX's within 1e-6, and goes
    back unchanged; a JAX grid's soup is the port's bit for bit; a
    PoissonConfig keeps every field."""
    jm = meshes[0]
    fields = (jm.vertices, jm.faces, jm.vertex_mask, jm.face_mask)
    tm = interop.mesh_from_numpy(*(np.asarray(x) for x in fields),
                                 {k: np.asarray(v) for k, v in jm.attrs.items()}, device="cpu")
    assert (tm.vertex_capacity, tm.face_capacity) == (jm.vertex_capacity, jm.face_capacity)
    np.testing.assert_allclose(tm.compute_vertex_normals().normals.numpy(),
                               np.asarray(jm.compute_vertex_normals().normals), rtol=0,
                               atol=1e-6)
    back = interop.mesh_to_numpy(tm)
    for a, b in zip(back[:4], fields):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert set(back[4]) == {"normals", "colors"}
    jg = JM.create_sphere_volume(20)
    tg = interop.grid_from_numpy(np.asarray(jg.values), np.asarray(jg.origin),
                                 np.asarray(jg.spacing), device="cpu")
    ts = importlib.import_module("threecrate_tpu_torch.reconstruction.marching_cubes"
                                 ).extract_soup_cubes(tg, 0.0)
    np.testing.assert_array_equal(ts.vertices.numpy(),
                                  np.asarray(JM.extract_soup_cubes(jg, jnp.float32(0.0)).vertices))
    jp = importlib.import_module("threecrate_tpu.reconstruction.poisson")
    cfg = jp.PoissonConfig(depth=7, solver="cg", density_trim=False, mg_cycles=4)
    assert vars(interop.poisson_config_from(cfg)) == vars(cfg)
