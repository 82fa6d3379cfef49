"""Port parity of relocalization: the batched PnP RANSAC
(os1_tpu_torch.solvers.pnp), the all-candidates program and the relocalizer
(os1_tpu_torch.pipeline.relocalization), against the JAX package.

The draws are the JAX package's: a sampler hands the port the indices
``lax.top_k`` takes from ``jax.random.gumbel(key, (256, N))`` over the valid
correspondences, with the same key chain.

- PnP, on the exact, outlier and too-few-points cases of the JAX package's
  own PnP tests: success, inlier masks and inlier counts exact; Tcw within
  atol 1e-3 of the JAX pose (measured 2e-5 exact, 2e-4 with outliers: each
  package's float32 12x12 ``eigh`` of the weighted DLT is ~1e-5 from the
  float64 eigenvector, and the scale fix amplifies it), both within the JAX
  tests' bounds of the true pose. On the too-few case the pose is not a
  result (success is False) and is not compared. A batch of lanes equals its
  lanes solved one at a time.
- PnP on a wall: 200 coplanar points (a tilted plane, 80 outliers), where
  the DLT's 12 unknowns are not determined. The port adds a plane-pose
  hypothesis a sample (the homography of the sample's plane) and recovers
  the pose within 1e-2 of the truth; the JAX package's PnP, on the same
  draws, does not (the deviation that lets the photo room relocalize).
- The candidates program on a map built by the JAX package (sync mapping over
  24 frames of the JAX pipeline tests' orbit), for a frame of the sequence
  against its five newest keyframes: the 5-lane match (n_match) and PnP
  success exact against the JAX program, with the port's own PnP on the JAX
  draws. The PnP poses themselves are not comparable on this scene: the
  synthetic world is planes, a coplanar 6-point sample leaves the DLT a
  near-degenerate null space, and which vector a float32 ``eigh`` returns
  there is rounding noise (measured: a median 0.4 between the two packages'
  hypothesis poses; the JAX program's own vmapped lanes differ from the same
  lanes solved one by one, n_good 17 against 95 on lane 0). So the polish is
  held with the JAX PnP handed to the port: n_good and the bindings exact,
  Tcw within atol 1e-4 of the JAX lanes solved one by one.
- The relocalizer's acceptance walk and guided projection rounds on that map,
  the JAX program's head and bindings handed to the port: the same verdict,
  the same matched keyframe, the same bindings and a pose within atol 1e-4.
- One candidate and four spare lanes: the spare lanes repeat it with other
  PnP draws and its best lane decides (the JAX package reads only the
  first).
- The blackout sequence of the JAX pipeline tests on the port on the CPU, in
  the shipped mode (pipelined, cooperative mapping): LOST on black frames,
  OK again within ten replayed frames, at the pose the first pass recorded
  for that frame (within 0.05 rad and 0.2 units, the JAX relocalization
  test's bounds).
- Marked ``cuda``: the 5-lane masks-only fused match (A shared) equals its
  plain version on the card.
"""
import numpy as np
import pytest
import torch

from os1_tpu_torch.ops import pallas_hamming as ph

H, W = 240, 320
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1.0]])
INTR = np.array([400.0, 400.0, 320.0, 240.0], np.float32)


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    return jax, jnp


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the float results do not depend on the host's
    core count, and parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """Sampler replaying the JAX draws. ``split=True``: a relocalizer's key
    chain (split the key per call, then one subkey per lane); else one fixed
    key for one unbatched solve."""

    def __init__(self, key, split=False):
        self.key, self.split = key, split

    def __call__(self, valid, iters, k):
        import jax
        import jax.numpy as jnp

        v = jnp.asarray(valid.cpu().numpy())
        key = self.key
        if self.split:
            self.key, key = jax.random.split(self.key)
        keys = jax.random.split(key, v.shape[0]) if v.ndim == 2 else key[None]
        vv = v if v.ndim == 2 else v[None]
        out = []
        for kk, vi in zip(keys, vv):
            g = jnp.where(vi[None, :], jax.random.gumbel(kk, (iters, vi.shape[0])), -jnp.inf)
            out.append(np.asarray(jax.lax.top_k(g, k)[1]))
        idx = np.stack(out).astype(np.int64)
        return torch.from_numpy(idx if v.ndim == 2 else idx[0])


class JaxPnP:
    """``solve_pnp`` replaced by the JAX package's, lane by lane, on a
    relocalizer's key chain (``split=True``) or one fixed subkey."""

    def __init__(self, key, split=False):
        self.key, self.split = key, split

    def __call__(self, points, uv, sigma2, valid, intr, sampler, min_inliers=10):
        import jax
        import jax.numpy as jnp
        from os1_tpu.solvers.pnp import solve_pnp as jsolve

        from os1_tpu_torch.solvers.pnp import PnPResult

        key = self.key
        if self.split:
            self.key, key = jax.random.split(self.key)
        keys = jax.random.split(key, valid.shape[0])
        j = jnp.asarray
        res = [jsolve(j(points[i].numpy()), j(uv.numpy()), j(sigma2.numpy()),
                      j(valid[i].numpy()), j(intr.numpy()), keys[i]) for i in range(len(keys))]
        return PnPResult(*(torch.from_numpy(np.stack([np.asarray(getattr(r, f)) for r in res]))
                           for f in PnPResult._fields))


# ------------------------------------------------------------------ PnP --

def _pnp_case(case):
    from test_relocalization import make_pnp_case

    rng = np.random.default_rng(0)
    for name in ("exact", "outliers", "few"):
        n, out = {"exact": (200, 0), "outliers": (200, 80), "few": (20, 0)}[name]
        pts, uv, T = make_pnp_case(rng, n, out)
        if name == case:
            valid = np.ones(n, bool)
            if case == "few":
                valid[5:] = False
            return pts, uv, T, valid, {"exact": 0, "outliers": 1, "few": 2}[case]


@pytest.mark.parametrize("case", ["exact", "outliers", "few"])
def test_pnp_matches_jax(jax_mods, case):
    jax, jnp = jax_mods
    from os1_tpu.solvers.pnp import solve_pnp as jsolve

    from os1_tpu_torch.solvers.pnp import solve_pnp

    pts, uv, T, valid, seed = _pnp_case(case)
    key = jax.random.PRNGKey(seed)
    n = len(pts)
    r = jsolve(jnp.asarray(pts), jnp.asarray(uv), jnp.ones(n), jnp.asarray(valid),
               jnp.asarray(INTR), key)
    t = solve_pnp(torch.from_numpy(pts), torch.from_numpy(uv), torch.ones(n),
                  torch.from_numpy(valid), torch.from_numpy(INTR), JaxDraws(key))
    assert bool(t.success) == bool(r.success) == (case != "few")
    assert np.array_equal(t.inliers.numpy(), np.asarray(r.inliers))
    assert int(t.n_inliers) == int(r.n_inliers)
    if case != "few":
        np.testing.assert_allclose(t.Tcw.numpy(), np.asarray(r.Tcw), atol=1e-3)
        assert np.abs(t.Tcw.numpy() - T).max() < (5e-3 if case == "exact" else 1e-2)


def _wall_case(rng, n=200, outliers=80):
    """Points on one tilted plane 5-7 units ahead, seen from a pose near
    the identity, with ``outliers`` correspondences replaced by noise."""
    from os1_tpu_torch.geometry import se3

    ab = rng.uniform(-2, 2, size=(n, 2))
    normal = np.array([0.2, -0.1, 1.0]) / np.linalg.norm([0.2, -0.1, 1.0])
    e1 = np.cross(normal, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    pts = (np.array([0.3, -0.2, 6.0]) + ab[:, :1] * e1 + ab[:, 1:] * e2).astype(np.float32)
    xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.1, 3)])
    T = se3.exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 320, 400 * pc[:, 1] / pc[:, 2] + 240],
                  -1).astype(np.float32)
    bad = rng.choice(n, outliers, replace=False)
    uv[bad] = rng.uniform([0, 0], [640, 480], size=(outliers, 2))
    return pts, uv, T


def test_pnp_on_a_plane(jax_mods):
    jax, jnp = jax_mods
    from os1_tpu.solvers.pnp import solve_pnp as jsolve

    from os1_tpu_torch.solvers.pnp import solve_pnp

    pts, uv, T = _wall_case(np.random.default_rng(3))
    n = len(pts)
    key = jax.random.PRNGKey(5)
    args = (torch.from_numpy(pts), torch.from_numpy(uv), torch.ones(n),
            torch.ones(n, dtype=torch.bool), torch.from_numpy(INTR))
    t = solve_pnp(*args, JaxDraws(key))
    assert bool(t.success) and int(t.n_inliers) >= 110
    assert np.abs(t.Tcw.numpy() - T).max() < 1e-2
    r = jsolve(jnp.asarray(pts), jnp.asarray(uv), jnp.ones(n), jnp.ones(n, bool),
               jnp.asarray(INTR), key)
    assert not (bool(r.success) and np.abs(np.asarray(r.Tcw) - T).max() < 1e-2)


def test_pnp_lanes_equal_single_solves():
    from os1_tpu_torch.solvers.initializer import GumbelSampler
    from os1_tpu_torch.solvers.pnp import solve_pnp

    pts, uv, _, _, _ = _pnp_case("outliers")
    n = len(pts)
    rng = np.random.default_rng(5)
    valid = torch.from_numpy(rng.random((3, n)) < np.array([[1.0], [0.7], [0.02]]))
    P = torch.from_numpy(pts).expand(3, n, 3)
    idx = GumbelSampler(seed=7, device="cpu")(valid, 256, 6)
    lanes = solve_pnp(P, torch.from_numpy(uv), torch.ones(n), valid, torch.from_numpy(INTR),
                      lambda v, i, k: idx)
    for b in range(3):
        one = solve_pnp(P[b], torch.from_numpy(uv), torch.ones(n), valid[b],
                        torch.from_numpy(INTR), lambda v, i, k, b=b: idx[b])
        assert bool(one.success) == bool(lanes.success[b])
        assert torch.equal(one.inliers, lanes.inliers[b])
        np.testing.assert_allclose(one.Tcw.numpy(), lanes.Tcw[b].numpy(), atol=1e-5)
    assert lanes.success.tolist() == [True, True, False]


# ---------------------------------------------- the candidates program --

@pytest.fixture(scope="module")
def jax_map(jax_mods):
    """A map built by the JAX package (sync mapping, 24 frames) and a later
    frame of the sequence, as JAX frame data."""
    from os1_tpu.features.orb import OrbConfig as JOrb
    from os1_tpu.geometry.camera import Camera as JCamera
    from os1_tpu.io import synthetic
    from os1_tpu.map.store import MapConfig as JMap
    from os1_tpu.pipeline import SlamConfig as JSlam
    from os1_tpu.pipeline import System as JSystem

    cam = JCamera.make(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], width=W, height=H)
    cfg = JSlam(camera=cam, orb=JOrb(height=H, width=W, n_features=512, n_levels=4),
                map=JMap(max_keyframes=64, max_points=8192, n_features=512))
    jsys = JSystem(cfg=cfg, distributed=False, enable_loop_closing=False)
    scene = synthetic.default_scene(seed=3)
    poses = synthetic.orbit_trajectory(40, advance=0.08)
    frames = synthetic.render_sequence(scene, poses[:24], K, H, W)
    for i, f in enumerate(frames):
        jsys.track_monocular(f, timestamp=i / 30.0)
    jframe = jsys.tracker._build(jax_mods[1].asarray(frames[12]), cfg.camera)
    return jsys, jframe


def _port_side(jsys, jframe):
    from os1_tpu_torch import convert
    from os1_tpu_torch.map.mirror import DeviceMirror
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig

    cfg = SlamConfig(camera=convert.camera_from_numpy(jsys.cfg.camera, device="cpu"),
                     orb=convert.orb_config_from_fields(jsys.cfg.orb),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    store = convert.store_from_numpy(jsys.store)
    f = jframe.feats
    frame = convert.frame_from_numpy(*(np.asarray(a) for a in (
        f.xy, f.response, f.angle, f.octave, f.desc, f.valid, jframe.xy_un, jframe.sigma2)),
        device="cpu")
    return cfg, store, DeviceMirror(store, "cpu"), frame


def test_reloc_candidates_program_matches_jax(jax_mods, jax_map, monkeypatch):
    jax, jnp = jax_mods
    from os1_tpu.pipeline.relocalization import _reloc_candidates_program

    from os1_tpu_torch.pipeline import relocalization as reloc
    from os1_tpu_torch.pipeline.relocalization import RELOC_C, _reloc_candidates

    jsys, jframe = jax_map
    cfg, store, mir, frame = _port_side(jsys, jframe)
    live = np.nonzero(jsys.store.kf_valid)[0]
    assert len(live) >= RELOC_C
    cand_idx = live[-RELOC_C:].astype(np.int32)  # five distinct keyframes, one a lane
    _, sub = jax.random.split(jax.random.PRNGKey(42))
    jm = jsys.mirror
    jhead, jbind = _reloc_candidates_program(
        jframe.feats.desc, jframe.feats.valid, jframe.feats.angle, jframe.xy_un, jframe.sigma2,
        jnp.asarray(cand_idx), jm.kf_desc, jm.kf_angle, jm.kf_obs_point, jm.pt_xyz, jm.pt_valid,
        jnp.asarray(jsys.cfg.intr), sub)
    args = (frame.feats.desc, frame.feats.valid, frame.feats.angle, frame.xy_un, frame.sigma2,
            torch.from_numpy(cand_idx.astype(np.int64)), mir.kf_desc, mir.kf_angle,
            mir.kf_obs_point, mir.pt_xyz, mir.pt_valid, torch.as_tensor(cfg.intr))
    jhead, jbind = np.asarray(jhead), np.asarray(jbind)
    own, _ = _reloc_candidates(*args, JaxDraws(sub))
    assert np.array_equal(own[:, :2].numpy(), jhead[:, :2])
    monkeypatch.setattr(reloc, "solve_pnp", JaxPnP(sub))
    head, bind = _reloc_candidates(*args, None)
    head = head.numpy()
    assert np.array_equal(head[:, :2], jhead[:, :2])
    # The JAX lanes one by one: match, PnP, polish, bindings.
    from os1_tpu.matching import core as jcore
    from os1_tpu.optim import optimize_pose as joptimize
    from os1_tpu.solvers.pnp import solve_pnp as jsolve

    keys = jax.random.split(sub, RELOC_C)
    intr = jnp.asarray(jsys.cfg.intr)
    for i, kf in enumerate(cand_idx):
        obs = jm.kf_obs_point[kf]
        hp = (obs >= 0) & jm.pt_valid[jnp.clip(obs, 0, None)]
        res = jcore.match_with_gate(jframe.feats.desc, jm.kf_desc[kf],
                                    jframe.feats.valid[:, None] & hp[None, :], max_dist=50,
                                    ratio=0.75)
        res = jcore.rotation_consistency(jframe.feats.angle, jm.kf_angle[kf],
                                         jcore.mutual_best(res, obs.shape[0]))
        idx = jnp.clip(res.idx, 0, None)
        pts = jm.pt_xyz[jnp.clip(obs, 0, None)][idx]
        pnp = jsolve(pts, jframe.xy_un, jframe.sigma2, res.ok, intr, keys[i])
        opt = joptimize(pnp.Tcw, pts, jframe.xy_un, jframe.sigma2, pnp.inliers, intr)
        assert head[i, 2] == int(opt.n_inliers) >= 10
        assert np.array_equal(bind[i].numpy(),
                              np.asarray(jnp.where(opt.inlier & res.ok, obs[idx], -1)))
        np.testing.assert_allclose(head[i, 4:], np.asarray(opt.Tcw).reshape(-1), atol=1e-4)


def test_relocalizer_matches_jax(jax_mods, jax_map, monkeypatch):
    import os1_tpu.pipeline.relocalization as jreloc

    from os1_tpu_torch.pipeline import relocalization as reloc
    from os1_tpu_torch.pipeline.relocalization import Relocalizer
    from os1_tpu_torch.vocab.database import KeyFrameDatabase

    jsys, jframe = jax_map
    cfg, store, mir, frame = _port_side(jsys, jframe)
    db = KeyFrameDatabase(jsys.db.vocab, store.cfg.max_keyframes)
    for k in np.nonzero(store.kf_valid)[0]:
        db.add(int(k), db.compute_bow(store.kf_desc[k], store.kf_feat_valid[k])[2])
    seen = []
    program = jreloc._reloc_candidates_program

    def spy(*a):
        out = program(*a)
        seen.append((np.asarray(a[5]), *(np.asarray(x) for x in out)))
        return out

    monkeypatch.setattr(jreloc, "_reloc_candidates_program", spy)
    jrel = jreloc.Relocalizer(cfg=jsys.cfg, store=jsys.store, db=jsys.db, mirror=jsys.mirror)
    jok, jT, jb = jrel(jframe)
    assert len(seen) == 1

    def handed(*a):
        assert np.array_equal(a[5].numpy(), seen[0][0])  # the same candidates
        return torch.from_numpy(seen[0][1]), torch.from_numpy(seen[0][2].astype(np.int64))

    monkeypatch.setattr(reloc, "_reloc_candidates", handed)
    rel = Relocalizer(cfg=cfg, store=store, db=db, mirror=mir)
    ok, T, b = rel(frame)
    assert ok and jok and rel.last_reloc_kf == jrel.last_reloc_kf
    assert np.array_equal(b, np.asarray(jb))
    np.testing.assert_allclose(T, np.asarray(jT), atol=1e-4)


# ---------------------------------------------------- blackout, end to end --

def test_first_candidate_takes_its_best_lane(monkeypatch):
    """Lane 0 fails PnP, lane 2 (the same keyframe, other draws) passes with
    60 inliers: the relocalizer accepts lane 2's pose and bindings."""
    from types import SimpleNamespace

    from os1_tpu_torch.pipeline import relocalization as reloc

    n, kf = 64, 3
    store = SimpleNamespace(kf_obs_point=np.full((8, n), -1, np.int64),
                            pt_valid=np.ones(128, bool))
    store.kf_obs_point[kf, :40] = np.arange(40)
    head = np.zeros((reloc.RELOC_C, 20), np.float32)
    head[:, 0] = 40  # matches
    head[:, 2] = 5  # polished inliers
    head[2, 1:3] = (1.0, 60.0)  # lane 2: PnP succeeded, 60 inliers
    head[2, 4:] = np.eye(4, dtype=np.float32).reshape(-1) * 2
    bind = np.full((reloc.RELOC_C, n), -1, np.int64)
    bind[2, :60] = np.arange(60)
    seen = {}

    def fake_program(*args):
        seen["cand_idx"] = args[5].numpy()
        return torch.from_numpy(head), torch.from_numpy(bind)

    monkeypatch.setattr(reloc, "_reloc_candidates", fake_program)
    mirror = SimpleNamespace(device=torch.device("cpu"), kf_desc=None, kf_angle=None,
                             kf_obs_point=None, pt_xyz=None, pt_valid=None)
    cfg = SimpleNamespace(intr=np.array([400.0, 400.0, 320.0, 240.0], np.float32))
    r = reloc.Relocalizer(cfg=cfg, store=store, db=None, mirror=mirror, sampler=lambda *a: None)
    r._candidates = lambda frame: [kf]
    frame = SimpleNamespace(feats=SimpleNamespace(desc=None, valid=None, angle=None),
                            xy_un=None, sigma2=None)
    ok, T, b = r(frame)
    assert list(seen["cand_idx"]) == [kf] * reloc.RELOC_C
    assert ok and r.last_reloc_kf == kf
    assert np.array_equal(T, np.eye(4, dtype=np.float32) * 2)
    assert np.array_equal(b, bind[2])


def test_blackout_then_relocalize():
    from os1_tpu_torch.features.orb import OrbConfig
    from os1_tpu_torch.geometry.camera import Camera
    from os1_tpu_torch.io import synthetic
    from os1_tpu_torch.map.store import MapConfig
    from os1_tpu_torch.pipeline import SlamConfig, System, TrackingState

    cfg = SlamConfig(camera=Camera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width=W, height=H,
                                        device="cpu"),
                     orb=OrbConfig(height=H, width=W, n_features=512, n_levels=4),
                     map=MapConfig(max_keyframes=64, max_points=8192, n_features=512))
    sys_ = System(cfg, enable_loop_closing=False, pipelined=True, coop_mapping=True,
                  device="cpu")
    poses = synthetic.orbit_trajectory(40, advance=0.08)
    frames = synthetic.render_sequence(synthetic.default_scene(seed=3), poses, K, H, W)
    for i, f in enumerate(frames):
        sys_.track_monocular(f, timestamp=i / 30.0)
    sys_.flush()
    assert sys_.state == TrackingState.OK and sys_.store.n_keyframes() > 5
    first = {fid: T for _, fid, T in sys_.frame_trajectory()}
    black = np.zeros((H, W), np.float32)
    for j in range(5):
        sys_.track_monocular(black, timestamp=(40 + j) / 30.0)
    assert sys_.state == TrackingState.LOST
    assert sys_.relocalizer.last_n_candidates == 0  # a black frame retrieves nothing
    for i, f in enumerate(frames[30:40]):
        state, Tcw = sys_.track_monocular(f, timestamp=(45 + i) / 30.0)
        if state == TrackingState.OK:
            break
    assert state == TrackingState.OK, "failed to relocalize after the blackout"
    assert sys_.tracker.last_reloc_frame_id == 45 + i
    ref = first[30 + i]
    dR = Tcw[:3, :3] @ ref[:3, :3].T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.05
    assert np.linalg.norm(Tcw[:3, 3] - ref[:3, 3]) < 0.2
    assert sys_.tracker.ref_kf == sys_.relocalizer.last_reloc_kf


# ----------------------------------------------------------------- card --

@pytest.mark.cuda
def test_cuda_reloc_match_equals_plain():
    """Relocalization's shape: 5 lanes, the frame's 1024 descriptors shared,
    the masks-only gate, max_dist 50, ratio 0.75, duplicated columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(11)
    b = rng.integers(0, 2**32, (5, 1024, 8), dtype=np.uint64).astype(np.uint32)
    b[:, 1::3] = b[:, 0::3][:, :341]
    a = b[2, rng.integers(0, 1024, 1024)] ^ (
        (rng.random((1024, 8)) < 0.1).astype(np.uint32) << np.uint32(7))
    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).cuda()  # noqa
    kw = dict(valid_a=t(rng.random((5, 1024)) < 0.95), valid_b=t(rng.random((5, 1024)) < 0.6))
    A, B = t(a)[None], t(b)
    before = ph.gated_match_cuda.launches
    got = ph.gated_match_cuda(A, B, 50, 0.75, **kw)
    torch.cuda.synchronize()
    assert ph.gated_match_cuda.launches == before + 1
    ref = ph.gated_match(A, B, 50, 0.75, **kw)
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(ref.ok.sum()) > 100
