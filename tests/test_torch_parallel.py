"""Port parity of the distributed back end (os1_tpu_torch.parallel) on the
CPU, against the JAX package on its 8-device virtual mesh
(tests/conftest.py), with the inputs of tests/test_parallel.py
(``build_problem``, ``build_pose_graph``).

The port's mesh is a single-process one: eight positions on the CPU stand
where the JAX package's tests put eight virtual devices (``Mesh`` entries may
repeat). Tolerances are the reference's own: 5e-4 on poses and 5e-3 on
points for the BA (tests/test_parallel.py:80-83, :118-119), 2e-3 on the
pose graph and its drift cut to a quarter (:169-175); the sharded database's
ids exactly, its scores within 1e-5.

- ``psum`` reduces the innermost axis first and returns one shared tensor
  per distinct device; reruns of every mesh solve are bit-identical.
- The resumable protocol (5 iterations, reclassify, 5 more) on the 1-D and
  the 2x4 mesh against the port's single-device protocol and the JAX
  package's ``MeshBABackend`` / ``two_level_backend``; ``distributed_ba``
  against the JAX package's, with its convergence; a point count the mesh
  does not divide (padded, then trimmed) against single-device.
- ``distributed_pose_graph`` against the JAX package's and the port's
  ``optimize_pose_graph``, with an edge count the mesh divides and one it
  does not; a shard of padded edges adds exactly nothing.
- ``DistKeyFrameDatabase``, built from the JAX one's arrays through
  ``convert.dist_database_from_numpy``, against the JAX package's and the
  port's host ``KeyFrameDatabase``; erase and ``min_score``.
- The loop closer's correction (the essential graph) and its global BA on
  the hand-built looped map of tests/test_loop_closing.py, both through the
  mesh, against the JAX loop closer through its mesh.
- ``TestMeshPipeline`` of tests/test_parallel.py on the port: the 40-frame
  orbit through ``System(distributed=True, mesh=...)``, its ATE within the
  reference's bound of the single-device run's, with local BA routed
  through the mesh.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from os1_tpu_torch import convert  # noqa: E402
from os1_tpu_torch.optim import ba_core as tba  # noqa: E402
from os1_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    MeshBABackend,
    distributed_ba,
    distributed_pose_graph,
    psum,
    two_level_backend,
)
from os1_tpu_torch.parallel import backend as tbackend  # noqa: E402
from os1_tpu_torch.pipeline import loop_closing as tlc  # noqa: E402
from test_parallel import build_pose_graph, build_problem  # noqa: E402
from test_torch_loop import J, _programs, _same_map, looped_map, pair  # noqa: E402,F401

CPU = torch.device("cpu")
PT_FIELDS = ("points", "point_valid", "obs_cam", "obs_uv", "obs_sigma2", "obs_valid")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jdevs():
    devs = np.asarray(jax.devices())
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return devs[:8]


def cpu_mesh(shape=(8,), axes=("points",)):
    return Mesh(np.full(shape, CPU, dtype=object), axes)


def _port_problem(prob):
    p = tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in prob))
    return p._replace(obs_cam=p.obs_cam.long())


def _take_points(prob, n):
    return prob._replace(**{k: getattr(prob, k)[:n] for k in PT_FIELDS})


def _protocol(shard, begin, iterate, reclassify, result, prob):
    sp = shard(prob)
    state = iterate(sp, begin(sp), 5)
    state = iterate(sp, reclassify(sp, state), 5)
    return result(sp, state)


def _single(prob):
    return _protocol(lambda p: p, tba.ba_begin, tba.ba_iterate, tba.ba_reclassify,
                     tba.ba_result, prob)


def _on_mesh(be, prob):
    return _protocol(be.shard, be.begin, be.iterate, be.reclassify, be.result, prob)


# ------------------------------------------------------------------ psum --

def test_psum_reduces_the_inner_axis_first_and_shares_per_device():
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32)) for _ in range(8)]
    out = psum(parts, cpu_mesh((2, 4), ("dcn", "ici")))
    rows = [((parts[r * 4] + parts[r * 4 + 1]) + parts[r * 4 + 2]) + parts[r * 4 + 3]
            for r in range(2)]
    assert torch.equal(out[0], rows[0] + rows[1])
    assert all(o is out[0] for o in out)  # one device: one tensor, no copies
    flat = psum(parts, cpu_mesh())
    seq = parts[0]
    for p in parts[1:]:
        seq = seq + p
    assert torch.equal(flat[0], seq)
    with pytest.raises(ValueError):
        psum(parts[:7], cpu_mesh())


def test_mesh_shape_and_errors():
    m = cpu_mesh((2, 4), ("dcn", "ici"))
    assert m.shape == {"dcn": 2, "ici": 4} and m.size == 8 and m.axis_names == ("dcn", "ici")
    assert m.distinct_devices == [CPU]
    with pytest.raises(ValueError):
        Mesh(np.full((2, 4), CPU, dtype=object), ("points",))
    with pytest.raises(ValueError):
        two_level_backend(3, [CPU] * 8)
    assert tbackend.default_mesh_backend("cpu") is None


# -------------------------------------------------------------------- BA --

@pytest.mark.parametrize("layout", ["1d", "2x4"])
def test_resumable_protocol_matches_single_device_and_jax(layout):
    from os1_tpu.parallel.backend import MeshBABackend as JBackend
    from os1_tpu.parallel.backend import two_level_backend as jtwo_level

    prob, _, _ = build_problem(np.random.default_rng(0))
    tp = _port_problem(prob)
    if layout == "1d":
        be, jbe = MeshBABackend(cpu_mesh()), JBackend(JMesh(_jdevs(), ("points",)))
    else:
        be, jbe = two_level_backend(2, [CPU] * 8), jtwo_level(2, _jdevs())
        assert be.mesh.devices.shape == (2, 4) == jbe.mesh.devices.shape
    res = _on_mesh(be, tp)
    ref = _single(tp)
    jres = jax.device_get(_protocol(jbe.shard, jbe.begin, jbe.iterate, jbe.reclassify,
                                    jbe.result, prob))
    for other in ((ref.cam_T.numpy(), ref.points.numpy(), ref.obs_inlier.numpy()),
                  (jres.cam_T, jres.points, jres.obs_inlier)):
        np.testing.assert_allclose(res.cam_T.numpy(), other[0], atol=5e-4)
        np.testing.assert_allclose(res.points.numpy(), other[1], atol=5e-3)
        np.testing.assert_array_equal(res.obs_inlier.numpy(), other[2])
    assert res.points.shape == tp.points.shape and res.obs_inlier.shape == tp.obs_valid.shape


def test_distributed_ba_matches_jax_and_converges():
    from os1_tpu.parallel import distributed_ba as jdist_ba

    prob, poses, pts = build_problem(np.random.default_rng(0))
    cam_T, points, cost = distributed_ba(_port_problem(prob), cpu_mesh(), iters=10)
    assert np.abs(cam_T.numpy()[2:] - poses[2:]).max() < 5e-3
    assert np.abs(points.numpy() - pts).max() < 3e-2
    jcam, jpts, jcost = jdist_ba(prob, JMesh(_jdevs(), ("points",)), iters=10)
    np.testing.assert_allclose(cam_T.numpy(), np.asarray(jcam), atol=5e-4)
    np.testing.assert_allclose(points.numpy(), np.asarray(jpts), atol=5e-3)
    np.testing.assert_allclose(float(cost), float(jcost), atol=1e-6)  # both converged to ~5e-7


def test_point_count_the_mesh_does_not_divide():
    prob, _, _ = build_problem(np.random.default_rng(0))
    tp = _take_points(_port_problem(prob), 509)
    be = MeshBABackend(cpu_mesh())
    sp = be.shard(tp)
    assert [s.points.shape[0] for s in sp.shards] == [64] * 8
    assert not sp.shards[-1].point_valid[-3:].any() and not sp.shards[-1].obs_valid[-3:].any()
    res = _on_mesh(be, tp)
    ref = _single(tp)
    assert res.points.shape == (509, 3) and res.obs_inlier.shape == (509, 4)
    np.testing.assert_allclose(res.cam_T.numpy(), ref.cam_T.numpy(), atol=5e-4)
    np.testing.assert_allclose(res.points.numpy(), ref.points.numpy(), atol=5e-3)
    np.testing.assert_array_equal(res.obs_inlier.numpy(), ref.obs_inlier.numpy())


def test_mesh_reruns_are_bit_identical():
    prob, _, _ = build_problem(np.random.default_rng(1))
    tp = _take_points(_port_problem(prob), 500)
    for be in (MeshBABackend(cpu_mesh()), two_level_backend(2, [CPU] * 8)):
        a, b = _on_mesh(be, tp), _on_mesh(be, tp)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ------------------------------------------------------------ pose graph --

@pytest.mark.parametrize("K", [24, 22])
def test_distributed_pose_graph_matches_jax_and_single_device(K):
    from os1_tpu.parallel import distributed_pose_graph as jdist_pg
    from os1_tpu_torch.optim.pose_graph import optimize_pose_graph

    gt, drift, ei, ej, eS = build_pose_graph(K)
    assert (len(ei) % 8 == 0) == (K == 24)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(drift), torch.ones(K, dtype=torch.bool), t(np.arange(K) == 0), t(ei).long(),
            t(ej).long(), t(eS.astype(np.float32)))
    valid = torch.ones(len(ei), dtype=torch.bool)
    mesh = cpu_mesh(axes=("edges",))
    dist = distributed_pose_graph(*args, valid, mesh=mesh, iters=15).numpy()
    single = optimize_pose_graph(*args, iters=15).numpy()
    jargs = (jnp.asarray(drift), jnp.ones(K, bool), jnp.asarray(np.arange(K) == 0),
             jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(eS.astype(np.float32)),
             jnp.ones(len(ei), bool))
    jdist = np.asarray(jdist_pg(*jargs, mesh=JMesh(_jdevs(), ("edges",)), iters=15))
    np.testing.assert_allclose(dist, single, atol=2e-3)
    np.testing.assert_allclose(dist, jdist, atol=2e-3)
    end_before = np.abs(drift[K - 1] - gt[K - 1]).max()
    end_after = np.abs(dist[K - 1] - gt[K - 1]).max()
    assert end_after < 0.25 * end_before, (end_before, end_after)
    again = distributed_pose_graph(*args, valid, mesh=mesh, iters=15).numpy()
    assert np.array_equal(again, dist)


def test_padded_edges_add_nothing():
    import torch.nn.functional as F

    from os1_tpu_torch.optim.pose_graph import normal_equations
    from os1_tpu_torch.parallel.dist_pose_graph import _shard_cost, shard_edges

    gt, drift, ei, ej, eS = build_pose_graph(22)
    S = torch.from_numpy(drift)
    shards = shard_edges(torch.from_numpy(ei).long(), torch.from_numpy(ej).long(),
                         torch.from_numpy(eS.astype(np.float32)),
                         torch.ones(len(ei), dtype=torch.bool), cpu_mesh(axes=("edges",)))
    assert shards[-1][3].tolist() == [True, False, False]  # 22 edges padded to 24
    i, j, m, v = (a[1:] for a in shards[-1])
    assert torch.equal(m, torch.eye(4).expand(2, 4, 4)) and not i.any() and not j.any()
    Ei, Ej = F.one_hot(i, 22).float(), F.one_hot(j, 22).float()
    H, b = normal_equations(S, i, j, m, Ei, Ej, v)
    assert not H.any() and not b.any()
    assert float(_shard_cost(S, i, j, m, v)) == 0.0


# -------------------------------------------------------------- database --

@pytest.fixture(scope="module")
def databases():
    """40 keyframes that share descriptors in overlapping groups, in the
    JAX package's host and sharded databases and the port's host one."""
    from os1_tpu.parallel import DistKeyFrameDatabase as JDist
    from os1_tpu.vocab import database as jdb
    from os1_tpu.vocab import dbow2 as jdbow2
    from os1_tpu_torch.vocab import database, dbow2

    path = dbow2.DATA_DIR + "/default_vocab.bin"
    jhost = jdb.KeyFrameDatabase(jdbow2.load_binary(path), 64)
    jdist = JDist(JMesh(_jdevs(), ("kfs",)), max_keyframes=64)
    host = database.KeyFrameDatabase(dbow2.load_binary(path), 64)
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 2**32, (3000, 8), dtype=np.uint64).astype(np.uint32)
    bows = []
    for k in range(40):
        idx = np.concatenate([np.arange(60 * k, 60 * k + 300) % 3000, rng.integers(0, 3000, 40)])
        _, _, b = jhost.compute_bow(pool[idx], np.ones(len(idx), bool))
        jhost.add(k, b)
        jdist.add(k, b)
        host.add(k, database.SparseBow(words=b.words, weights=b.weights))
        bows.append(b)
    return dict(jhost=jhost, jdist=jdist, host=host, bows=bows)


def test_dist_database_matches_jax_and_host(databases):
    d = databases
    dist = convert.dist_database_from_numpy(d["jdist"], cpu_mesh(axes=("kfs",)))
    for probe in (0, 7, 23, 39):
        ids, scores = dist.query(d["bows"][probe], exclude=np.array([probe]))
        jids, jscores = d["jdist"].query(d["bows"][probe], exclude=np.array([probe]))
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, atol=1e-5)
        assert len(ids) >= 3 and probe not in ids
        host = np.array([d["host"].score_kf(d["bows"][probe], int(i)) for i in ids])
        np.testing.assert_allclose(scores, host, atol=1e-5)
        h_ids, _ = d["host"].query(d["bows"][probe], exclude=np.array([probe]))
        assert int(ids[0]) == int(h_ids[0])
        assert np.all(np.diff(scores) <= 0)


def test_dist_database_erase_and_min_score(databases):
    d = databases
    dist = convert.dist_database_from_numpy(d["jdist"], cpu_mesh(axes=("kfs",)))
    bow = d["bows"][3]
    ids, scores = dist.query(bow, min_score=0.05)
    jids, jscores = d["jdist"].query(bow, min_score=0.05)
    np.testing.assert_array_equal(ids, jids)
    assert 3 in ids and (scores > 0.05).all()
    dist.erase(3)
    assert 3 not in dist.query(bow)[0]
    dist.add(3, bow)
    assert 3 in dist.query(bow)[0]
    dist.clear()
    assert dist.query(bow)[0].size == 0


# ----------------------------------------------------- the loop closer --

def test_correction_and_global_ba_on_the_mesh_match_jax(pair, monkeypatch):
    """The essential graph of ``correct`` and the chunked global BA, both
    through the mesh, on the same map as the JAX loop closer through its."""
    from os1_tpu.parallel.backend import MeshBABackend as JBackend

    jl, tl, kf, cand, (hj, f1j, f2j, okj), _ = _programs(pair)
    jl.mesh_backend = JBackend(JMesh(_jdevs(), ("points",)))
    tl.mesh_backend = MeshBABackend(cpu_mesh())
    calls = dict(graph=0, chunks=0)

    def counted_graph(*a, **kw):
        assert kw["mesh"].size == 8 and kw["mesh"].axis_names == ("edges",)
        calls["graph"] += 1
        return distributed_pose_graph(*a, **kw)

    monkeypatch.setattr(tlc, "distributed_pose_graph", counted_graph)
    iterate = tl.mesh_backend.iterate

    def counted_iterate(sp, state, n):
        calls["chunks"] += 1
        return iterate(sp, state, n)

    tl.mesh_backend.iterate = counted_iterate
    S_cl = hj[4:20].reshape(4, 4).astype(np.float32)
    pairs = np.stack([f1j[okj], f2j[okj]], axis=1)
    jl.correct(kf, cand, S_cl, pairs)
    tl.correct(kf, cand, S_cl, pairs.astype(np.int64))
    assert calls["graph"] == 1 and tl.loop_edges == jl.loop_edges
    _same_map(jl.store, tl.store, 1e-3)
    jl._run_gba()
    for _ in tl._gba_steps():
        pass
    assert calls["chunks"] == tlc.GBA_ITERS // tlc.GBA_CHUNK
    _same_map(jl.store, tl.store, 1e-3)


# ------------------------------------------------------------- pipeline --

class TestMeshPipeline:
    """tests/test_parallel.py's ``TestMeshPipeline`` on the port: the whole
    synthetic sequence, with local BA routed through the mesh, tracks as
    well as the single-device run (within the reference's bound)."""

    def test_full_pipeline_mesh_matches_single(self):
        from os1_tpu_torch.features.orb import OrbConfig
        from os1_tpu_torch.geometry.camera import Camera
        from os1_tpu_torch.io import synthetic
        from os1_tpu_torch.map.store import MapConfig
        from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState

        H, W = 240, 320
        K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
        poses = synthetic.orbit_trajectory(40, advance=0.08)
        frames = synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)

        def run(distributed, mesh=None):
            cfg = SlamConfig(
                camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H),
                orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
            sys_ = System(cfg=cfg, distributed=distributed, mesh=mesh, device="cpu")
            calls = []
            if sys_.mesh_backend is not None:
                shard = sys_.mesh_backend.shard
                sys_.mesh_backend.shard = lambda p: calls.append(1) or shard(p)
            est, gt = [], []
            for i, f in enumerate(frames):
                state, Tcw = sys_.track_monocular(f, timestamp=i / 30.0)
                if state == TrackingState.OK and Tcw is not None:
                    est.append(Tcw)
                    gt.append(poses[i])
            assert len(est) > 25
            return synthetic.ate_rmse(est, gt), len(calls)

        ate_mesh, mesh_bas = run(distributed=True, mesh=cpu_mesh())
        ate_single, single_bas = run(distributed=False)
        assert mesh_bas > 0 and single_bas == 0
        assert ate_mesh < max(2.0 * ate_single, ate_single + 0.01), (ate_mesh, ate_single)
