"""Mesh simplification: the PyTorch port
(``threecrate_tpu_torch.simplification``) against the JAX package on the
same meshes, on the CPU.

Every simplifier is a host NumPy copy of the JAX one, so the stated
tolerance is bit equality: both are fed the same host arrays (the JAX
mesh's ``to_numpy()``) and must return the same vertices and faces.
Inputs, made from numpy seeds: a noisy UV sphere (closed, 1,024 faces,
the strict greedy queues), the same sphere at 48 rings (closed, 9,216
faces, above ``QuadricErrorSimplifier.batched_threshold``, the batched
rounds) and a noisy 20 x 20 height-field grid (open, 722 faces: the
boundary quadrics and guards).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from threecrate_tpu import TriangleMesh as JMesh  # noqa: E402
from threecrate_tpu import simplification as jsimp  # noqa: E402
from threecrate_tpu.core.errors import InvalidDataError as JInvalid  # noqa: E402
from threecrate_tpu.simplification import quadric as jq  # noqa: E402

from threecrate_tpu_torch import TriangleMesh as TMesh  # noqa: E402
from threecrate_tpu_torch import simplification as tsimp  # noqa: E402
from threecrate_tpu_torch.core.errors import InvalidDataError as TInvalid  # noqa: E402
from threecrate_tpu_torch.simplification import quadric as tq  # noqa: E402

torch.set_num_threads(2)   # the suite runs several workers per host


def _sphere(n_sub, noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    thetas = np.linspace(0.25, np.pi - 0.25, n_sub)
    phis = np.linspace(0, 2 * np.pi, n_sub * 2, endpoint=False)
    v = np.stack([np.outer(np.sin(thetas), np.cos(phis)).ravel(),
                  np.outer(np.sin(thetas), np.sin(phis)).ravel(),
                  np.repeat(np.cos(thetas), len(phis))], -1)
    m = len(phis)
    f = []
    for i in range(n_sub - 1):
        for j in range(m):
            a, b = i * m + j, i * m + (j + 1) % m
            c, d = (i + 1) * m + j, (i + 1) * m + (j + 1) % m
            f += [[a, b, c], [b, d, c]]
    # close both caps with a fan to a pole
    top, bot = len(v), len(v) + 1
    last = (n_sub - 1) * m
    f += [[top, (j + 1) % m, j] for j in range(m)]
    f += [[bot, last + j, last + (j + 1) % m] for j in range(m)]
    v = np.concatenate([v, [[0, 0, 1], [0, 0, -1]]])
    v = v + noise * rng.normal(size=v.shape)
    return v.astype(np.float32), np.asarray(f, np.int32)


def _grid(n=20, noise=0.03, seed=1):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    z = 0.1 * np.sin(4 * xs) * np.cos(3 * ys) + noise * rng.normal(size=xs.shape)
    v = np.stack([xs.ravel(), ys.ravel(), z.ravel()], -1).astype(np.float32)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j, i * n + j + 1
            c, d = (i + 1) * n + j, (i + 1) * n + j + 1
            f += [[a, b, c], [b, d, c]]
    return v, np.asarray(f, np.int32)


MESHES = {"sphere": _sphere(16), "grid": _grid(), "sphere48": _sphere(48, seed=2)}


def _pair(name):
    """The JAX mesh, and the port's CPU mesh built from its host arrays."""
    jm = JMesh.from_numpy(*MESHES[name])
    return jm, TMesh.from_numpy(*jm.to_numpy(), device="cpu")


def _same(jmesh, tmesh):
    jv, jf = jmesh.to_numpy()
    tv, tf = tmesh.to_numpy()
    assert tmesh.device.type == "cpu"
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_fixture_sizes():
    assert [len(MESHES[k][1]) for k in ("sphere", "grid", "sphere48")] == [1024, 722, 9216]
    assert len(MESHES["sphere48"][1]) > tsimp.QuadricErrorSimplifier.batched_threshold


@pytest.mark.parametrize("name", ["sphere", "grid"])
def test_quadrics_edges_and_costs_match_jax(name):
    v, f = MESHES[name]
    v = v.astype(np.float64)
    je, jb = jq.edges_and_boundary(f)
    te, tb = tq.edges_and_boundary(f)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tb, jb)
    assert (len(tb) > 0) == (name == "grid")
    jqd = jq.vertex_quadrics(v, f, jb, 1000.0)
    tqd = tq.vertex_quadrics(v, f, tb, 1000.0)
    np.testing.assert_array_equal(tqd, jqd)
    for optimal in (True, False):
        qs = jqd[je[:, 0]] + jqd[je[:, 1]]
        jc, jp = jq.collapse_cost(qs, v[je[:, 0]], v[je[:, 1]], optimal)
        tc, tp = tq.collapse_cost(qs, v[te[:, 0]], v[te[:, 1]], optimal)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tp, jp)


QEM_CONFIGS = {
    "default": {},
    "feature_angle": {"feature_angle_deg": 30.0},
    "midpoints": {"use_optimal_position": False},
    "free_boundary": {"preserve_boundary": False},
}


@pytest.mark.parametrize("name", ["sphere", "grid"])
@pytest.mark.parametrize("cfg", list(QEM_CONFIGS))
def test_qem_strict_matches_jax(name, cfg):
    jm, tm = _pair(name)
    target = int(jm.face_count()) // 4
    jout, _ = jq.qem_simplify(jm, target, jq.QuadricErrorConfig(**QEM_CONFIGS[cfg]))
    tout, _ = tq.qem_simplify(tm, target, tq.QuadricErrorConfig(**QEM_CONFIGS[cfg]))
    _same(jout, tout)
    assert int(tout.face_count()) <= target + 8


@pytest.mark.parametrize("name", ["sphere48", "grid"])
def test_qem_batched_matches_jax(name):
    jm, tm = _pair(name)
    target = int(jm.face_count()) // 10
    _same(jq.qem_simplify_batched(jm, target), tq.qem_simplify_batched(tm, target))


@pytest.mark.parametrize("name", ["sphere", "sphere48"])
def test_quadric_simplifier_dispatch_and_ratio_match_jax(name):
    """Strict below ``batched_threshold`` faces, batched above it."""
    jm, tm = _pair(name)
    _same(jsimp.QuadricErrorSimplifier().simplify(jm, 300),
          tsimp.QuadricErrorSimplifier().simplify(tm, 300))
    _same(jsimp.QuadricErrorSimplifier().simplify_ratio(jm, 0.3),
          tsimp.QuadricErrorSimplifier().simplify_ratio(tm, 0.3))


def test_qem_split_records_match_jax():
    jm, tm = _pair("sphere")
    _, jr = jq.qem_simplify(jm, 500, record_splits=True)
    _, tr = tq.qem_simplify(tm, 500, record_splits=True)
    assert len(tr) == len(jr) > 0
    for a, b in zip(jr, tr):
        assert a.keys() == b.keys()
        assert (a["kept"], a["removed"], a["remapped"]) == (b["kept"], b["removed"],
                                                             b["remapped"])
        for key in ("new_pos", "kept_old_pos", "removed_pos"):
            np.testing.assert_array_equal(b[key], a[key])
        assert [fi for fi, _ in a["removed_faces"]] == [fi for fi, _ in b["removed_faces"]]


EDGE_CONFIGS = {
    "default": {},
    "no_link_check": {"check_link_condition": False},
    "midpoint": {"collapse_to_midpoint": True},
    "flips_allowed": {"prevent_normal_flips": False},
}


@pytest.mark.parametrize("name", ["sphere", "grid"])
@pytest.mark.parametrize("cfg", list(EDGE_CONFIGS))
def test_edge_collapse_matches_jax(name, cfg):
    jm, tm = _pair(name)
    target = int(jm.face_count()) // 3
    jout = jsimp.EdgeCollapseSimplifier(jsimp.EdgeCollapseConfig(**EDGE_CONFIGS[cfg])
                                        ).simplify(jm, target)
    tout = tsimp.EdgeCollapseSimplifier(tsimp.EdgeCollapseConfig(**EDGE_CONFIGS[cfg])
                                        ).simplify(tm, target)
    _same(jout, tout)
    if cfg == "default":
        _same(jsimp.EdgeCollapseSimplifier().simplify_ratio(jm, 0.5),
              tsimp.EdgeCollapseSimplifier().simplify_ratio(tm, 0.5))


@pytest.mark.parametrize("mode", ["UNIFORM_GRID", "ADAPTIVE"])
@pytest.mark.parametrize("strategy", ["CENTROID", "VALENCE_WEIGHTED", "MIN_QUADRIC"])
@pytest.mark.parametrize("name", ["sphere", "grid"])
def test_cluster_simplify_matches_jax(mode, strategy, name):
    jm, tm = _pair(name)
    jcfg = jsimp.ClusteringConfig(mode=jsimp.ClusteringMode[mode],
                                  representative=jsimp.RepresentativeStrategy[strategy])
    tcfg = tsimp.ClusteringConfig(mode=tsimp.ClusteringMode[mode],
                                  representative=tsimp.RepresentativeStrategy[strategy])
    _same(jsimp.cluster_simplify(jm, jcfg), tsimp.cluster_simplify(tm, tcfg))
    fixed = {"cell_size": 0.15, "target_ratio": 0.5}
    _same(jsimp.cluster_simplify(jm, dataclasses.replace(jcfg, **fixed)),
          tsimp.cluster_simplify(tm, dataclasses.replace(tcfg, **fixed)))


@pytest.mark.parametrize("name", ["sphere", "sphere48"])
def test_clustering_simplifier_matches_jax(name):
    jm, tm = _pair(name)
    target = int(jm.face_count()) // 8
    _same(jsimp.ClusteringSimplifier().simplify(jm, target),
          tsimp.ClusteringSimplifier().simplify(tm, target))


@pytest.fixture(scope="module")
def progressive_pair():
    jm, tm = _pair("sphere")
    return (jsimp.ProgressiveMesh.from_mesh(jm, 200),
            tsimp.ProgressiveMesh.from_mesh(tm, 200))


def test_progressive_mesh_matches_jax(progressive_pair):
    jp, tp = progressive_pair
    for key in ("base_vertices", "base_faces", "base_face_alive"):
        np.testing.assert_array_equal(getattr(tp, key), getattr(jp, key))
    assert (tp.full_vertex_count, tp.full_face_count) == (jp.full_vertex_count,
                                                          jp.full_face_count)
    assert len(tp.splits) == len(jp.splits) > 0
    for n in (0, len(jp.splits) // 3, None):
        _same(jp.mesh_at(n), tp.mesh_at(n, device="cpu"))
    levels = tp.lod_levels(4, device="cpu")
    for a, b in zip(jp.lod_levels(4), levels):
        _same(a, b)
    _same(jp.full_mesh(), tp.full_mesh(device="cpu"))
    _same(jp.base_mesh(), tp.base_mesh(device="cpu"))
    # the full mesh is the input, vertex for vertex
    v, f = MESHES["sphere"]
    np.testing.assert_array_equal(tp.full_mesh(device="cpu").to_numpy()[0], v)


def test_progressive_files_load_in_both_packages(progressive_pair, tmp_path):
    """The port writes the JAX package's ``.npz`` format: each package
    loads the other's file to the same LODs; a foreign file is refused
    with JAX's error."""
    jp, tp = progressive_pair
    tp.save(tmp_path / "t.npz")
    jp.save(tmp_path / "j.npz")
    from_t = jsimp.ProgressiveMesh.load(tmp_path / "t.npz")
    from_j = tsimp.ProgressiveMesh.load(tmp_path / "j.npz")
    for n in (0, 7, None):
        _same(from_t.mesh_at(n), from_j.mesh_at(n, device="cpu"))
    np.savez(tmp_path / "bad.npz", magic=np.frombuffer(b"XXXX", np.uint8))
    with pytest.raises(JInvalid) as je:
        jsimp.ProgressiveMesh.load(tmp_path / "bad.npz")
    with pytest.raises(TInvalid) as te:
        tsimp.ProgressiveMesh.load(tmp_path / "bad.npz")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("method", ["quadric", "edge_collapse", "clustering"])
def test_simplify_mesh_matches_jax(method):
    jm, tm = _pair("sphere")
    _same(jsimp.simplify_mesh(jm, 250, method), tsimp.simplify_mesh(tm, 250, method))


def test_errors_match_jax():
    with pytest.raises(ValueError) as je:
        jsimp.simplify_mesh(JMesh.from_numpy(*MESHES["sphere"]), 10, "nope")
    with pytest.raises(ValueError) as te:
        tsimp.simplify_mesh(TMesh.from_numpy(*MESHES["sphere"], device="cpu"), 10, "nope")
    assert str(te.value) == str(je.value)
    empty = TMesh.empty(device="cpu")
    for fn in (lambda m: tq.qem_simplify(m, 4), lambda m: tq.qem_simplify_batched(m, 4),
               lambda m: tsimp.EdgeCollapseSimplifier().simplify(m, 4),
               lambda m: tsimp.cluster_simplify(m)):
        with pytest.raises(TInvalid, match="cannot simplify an empty mesh"):
            fn(empty)
