"""The fused gated-match kernel and its plain version (os1_tpu_torch.ops.
pallas_hamming.gated_match / gated_match_cuda) and the matchers on top.

On the CPU: the factored-gate plain path, the dense-gate plain path and the
JAX package's ``match_with_gate``, ``search_by_projection`` and
``fuse_candidates`` agree exactly (tolerance 0: integers and bools) on the
same numpy inputs, with bit 31 set in the descriptors, duplicated rows
(distance ties), points exactly on the window's edge and rows that every
column gates out; a batched call equals its per-entry loop. Marked ``cuda``:
the kernel (every gate form the matchers use) and the table kernel equal
their plain versions exactly on the card at the main path's shapes, each call
counted once. JAX is imported inside the parity tests only, so the ``cuda``
tests also run where JAX is absent.
"""
import numpy as np
import pytest
import torch

from os1_tpu_torch.features.orb import FrameFeatures
from os1_tpu_torch.matching import core, matchers
from os1_tpu_torch.ops import hamming as th
from os1_tpu_torch.ops import pallas_hamming as ph

FACTORED = ("valid_a", "valid_b", "uv", "radius", "xy", "octave_a", "octave_b")


def _problem(rng, nb, n, m, shared_a=False):
    """A batch of projection-match problems as numpy arrays: descriptors with
    ties and bit 31, feature positions on the pixel grid, points projected
    near a source feature with a radius of 4-15 px, some exactly on the
    window's edge, some just outside it, some far away (every column gated
    out), octaves 0-7."""
    b = rng.integers(0, 2**32, (nb, m, 8), dtype=np.uint64).astype(np.uint32)
    dup = len(range(1, m, 3))
    b[:, 1::3] = b[:, 0::3][:, :dup]  # duplicate columns: exact distance ties
    src = rng.integers(0, max(m, 1), (nb, n))
    xy = rng.integers(0, 640, (nb, m, 2)).astype(np.float32)
    xy[..., 1] %= 480
    octave_b = rng.integers(0, 8, (nb, m)).astype(np.int32)
    for x in (xy, octave_b):  # each duplicate at its twin's place: ties inside the window
        x[:, 1::3] = x[:, 0::3][:, :dup]
    if m:
        flips = (rng.random((nb, n, 8)) < 0.1).astype(np.uint32) << rng.integers(
            0, 32, (nb, n, 8)).astype(np.uint32)
        a = np.take_along_axis(b, src[..., None], 1) ^ flips
        xy_src = np.take_along_axis(xy, src[..., None], 1)
        oct_src = np.take_along_axis(octave_b, src, 1)
    else:
        a = rng.integers(0, 2**32, (nb, n, 8), dtype=np.uint64).astype(np.uint32)
        xy_src = rng.uniform(0, 480, (nb, n, 2)).astype(np.float32)
        oct_src = rng.integers(0, 8, (nb, n)).astype(np.int32)
    a[..., 0] |= np.uint32(1 << 31)
    radius = rng.integers(4, 16, (nb, n)).astype(np.float32)
    uv = (xy_src + rng.normal(0, 3, (nb, n, 2))).astype(np.float32)
    k = n // 8
    uv[:, :k, 0] = xy_src[:, :k, 0] + radius[:, :k]  # exactly on the edge: inside
    uv[:, k:2 * k, 1] = np.nextafter(xy_src[:, k:2 * k, 1] - radius[:, k:2 * k],
                                     np.float32(-1e9))  # one ulp outside
    uv[:, 2 * k:2 * k + 2] = -1000.0  # far away: every column gated out
    octave_a = np.clip(oct_src + rng.integers(-1, 2, (nb, n)), 0, 7).astype(np.int32)
    if shared_a:
        a = a[:1]
    return dict(a=a, b=b, uv=uv, radius=radius, xy=xy, octave_a=octave_a, octave_b=octave_b,
                valid_a=rng.random((nb, n)) < 0.9, valid_b=rng.random((nb, m)) < 0.9)


def _dense_gate(p, lo=-1, hi=1):
    """The projection gate built in numpy from the same float32 values."""
    diff = np.abs(p["uv"][:, :, None, :] - p["xy"][:, None, :, :])
    r = p["radius"][:, :, None]
    dl = p["octave_b"][:, None, :] - p["octave_a"][:, :, None]
    return ((diff[..., 0] <= r) & (diff[..., 1] <= r) & (dl >= lo) & (dl <= hi)
            & p["valid_a"][:, :, None] & p["valid_b"][:, None, :])


def _t(x, device="cpu"):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(device)


def _factored(p, device="cpu"):
    return {k: _t(p[k], device) for k in FACTORED}


def _reference_top2(p, gate, max_dist, ratio):
    """Best, its column, second and ok from the definition, in numpy."""
    x = p["a"][:, :, None, :] ^ p["b"][:, None, :, :]
    d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    d = np.where(gate, d, ph.BIG)
    idx = np.argmin(d, -1)
    best = np.take_along_axis(d, idx[..., None], -1)[..., 0]
    np.put_along_axis(d, idx[..., None], ph.BIG, -1)
    second = d.min(-1)
    ratio_second = np.float32(ratio) * second.astype(np.float32)
    ok = (best <= max_dist) & (best.astype(np.float32) <= ratio_second)
    return idx, best, second, ok


def _assert_same(x, y):
    for f, u, v in zip(ph.Top2._fields, x, y):
        assert u.dtype == v.dtype, f
        assert torch.equal(u.cpu(), v.cpu()), f


@pytest.fixture
def jax_mods():
    pytest.importorskip("jax")
    from os1_tpu.features.orb import FrameFeatures as JFeats
    from os1_tpu.matching import core as jcore
    from os1_tpu.matching import matchers as jmatch

    return JFeats, jcore, jmatch


# ------------------------------------------------------------------ CPU --

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_dist,ratio", [(100, 0.8), (50, 1.0), (256, 0.9)])
def test_factored_equals_dense_equals_jax(jax_mods, seed, max_dist, ratio):
    import jax.numpy as jnp

    _, jcore, _ = jax_mods
    p = _problem(np.random.default_rng(seed), 1, 200, 150)
    gate = _dense_gate(p)
    assert gate[0].any(1).sum() > 50 and (~gate[0].any(1)).sum() > 2
    fact = ph.gated_match(_t(p["a"]), _t(p["b"]), max_dist, ratio, **_factored(p))
    dense = ph.gated_match(_t(p["a"]), _t(p["b"]), max_dist, ratio, _t(gate))
    _assert_same(fact, dense)
    jr = jcore.match_with_gate(jnp.asarray(p["a"][0]), jnp.asarray(p["b"][0]),
                               jnp.asarray(gate[0]), max_dist, ratio)
    np.testing.assert_array_equal(fact.idx[0].numpy(), np.asarray(jr.idx))
    np.testing.assert_array_equal(fact.dist[0].numpy(), np.asarray(jr.dist))
    np.testing.assert_array_equal(fact.ok[0].numpy(), np.asarray(jr.ok))
    idx, best, second, ok = _reference_top2(p, gate, max_dist, ratio)
    np.testing.assert_array_equal(fact.idx.numpy(), idx)
    np.testing.assert_array_equal(fact.dist.numpy(), best)
    np.testing.assert_array_equal(fact.second.numpy(), second)
    np.testing.assert_array_equal(fact.ok.numpy(), ok)
    # Gated-out rows: index 0, BIG, not ok; a tie with the best gives second == best.
    none = ~gate.any(-1)
    assert (fact.idx.numpy()[none] == 0).all() and (fact.dist.numpy()[none] == ph.BIG).all()
    assert not fact.ok.numpy()[none].any()
    assert ((fact.second == fact.dist) & (fact.dist < ph.BIG)).sum() > 5


def test_window_edge_is_inside():
    p = _problem(np.random.default_rng(5), 1, 64, 40)
    gate = _dense_gate(p)
    ref = ph.window_gate(_t(p["uv"]), _t(p["xy"]), _t(p["radius"]), _t(p["valid_a"]),
                         _t(p["valid_b"])).numpy()
    diff = np.abs(p["uv"][:, :, None, :] - p["xy"][:, None, :, :])
    on_edge = (diff[..., 0] == p["radius"][:, :, None]) & ref
    assert on_edge.sum() >= 4  # the edge rows reach their source column
    np.testing.assert_array_equal(ref & gate, gate)


@pytest.mark.parametrize("seed,unique", [(0, True), (1, False), (2, True)])
def test_search_by_projection_matches_jax(jax_mods, seed, unique):
    import jax.numpy as jnp

    JFeats, _, jmatch = jax_mods
    p = _problem(np.random.default_rng(seed), 1, 300, 256)
    q = {k: v[0] for k, v in p.items()}
    f = dict(xy=q["xy"], response=np.zeros(256, np.float32), angle=np.zeros(256, np.float32),
             octave=q["octave_b"], desc=q["b"], valid=q["valid_b"])
    jf = JFeats(**{k: jnp.asarray(v) for k, v in f.items()})
    tf = FrameFeatures(**{k: _t(v) for k, v in f.items()})
    jr = jmatch.search_by_projection(jnp.asarray(q["a"]), jnp.asarray(q["uv"]),
                                     jnp.asarray(q["valid_a"]), jnp.asarray(q["octave_a"]), jf,
                                     jnp.asarray(q["radius"]), unique=unique)
    tr = matchers.search_by_projection(_t(q["a"]), _t(q["uv"]), _t(q["valid_a"]),
                                       _t(q["octave_a"]), tf, _t(q["radius"]), unique=unique)
    assert int(np.asarray(jr.ok).sum()) > 10
    for x, y in zip(tr, jr):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1])
def test_fuse_candidates_batched_matches_jax(jax_mods, seed):
    """Fusion lanes as one batched call against the JAX matcher lane by lane."""
    import jax.numpy as jnp

    JFeats, _, jmatch = jax_mods
    L, n, m = 6, 120, 100
    p = _problem(np.random.default_rng(seed), L, n, m)
    scale = (1.2 ** p["octave_a"]).astype(np.float32)
    f = dict(xy=p["xy"], response=np.zeros((L, m), np.float32),
             angle=np.zeros((L, m), np.float32), octave=p["octave_b"], desc=p["b"],
             valid=p["valid_b"])
    tr = matchers.fuse_candidates(_t(p["a"]), _t(p["uv"]), _t(p["valid_a"]), _t(p["octave_a"]),
                                  FrameFeatures(**{k: _t(v) for k, v in f.items()}), _t(scale))
    n_ok = 0
    for lane in range(L):
        jf = JFeats(**{k: jnp.asarray(v[lane]) for k, v in f.items()})
        jr = jmatch.fuse_candidates(jnp.asarray(p["a"][lane]), jnp.asarray(p["uv"][lane]),
                                    jnp.asarray(p["valid_a"][lane]),
                                    jnp.asarray(p["octave_a"][lane]), jf,
                                    jnp.asarray(scale[lane]))
        for x, y in zip(tr, jr):
            np.testing.assert_array_equal(x[lane].numpy(), np.asarray(y))
        n_ok += int(np.asarray(jr.ok).sum())
    assert n_ok > 20


def test_reference_keyframe_gate_matches_dense(jax_mods):
    """Window and octave band off: the gate is valid_a x valid_b."""
    import jax.numpy as jnp

    _, jcore, _ = jax_mods
    p = _problem(np.random.default_rng(9), 1, 180, 160)
    q = {k: v[0] for k, v in p.items()}
    gate = q["valid_a"][:, None] & q["valid_b"][None, :]
    tr = core.match_projected(_t(q["a"]), _t(q["b"]), _t(q["valid_a"]), _t(q["valid_b"]),
                              max_dist=core.TH_LOW, ratio=0.7)
    jr = jcore.match_with_gate(jnp.asarray(q["a"]), jnp.asarray(q["b"]), jnp.asarray(gate),
                               core.TH_LOW, 0.7)
    assert int(np.asarray(jr.ok).sum()) > 10
    for x, y in zip(tr, jr):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("shared_a", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_batched_equals_loop(shared_a, dense):
    nb, n, m = 5, 90, 70
    p = _problem(np.random.default_rng(11), nb, n, m, shared_a=shared_a)
    gate = _dense_gate(p)
    a, b = _t(p["a"]), _t(p["b"])
    kw = dict(gate=_t(gate)) if dense else _factored(p)
    whole = ph.gated_match(a, b, 100, 0.8, **kw)
    for e in range(nb):
        one = {k: v[e:e + 1] for k, v in kw.items()}
        part = ph.gated_match(a[0 if shared_a else e][None], b[e:e + 1], 100, 0.8, **one)
        _assert_same(part, [x[e:e + 1] for x in whole])
    # The core matcher over leading dimensions, with A shared as [N, 8].
    res = core.match_with_gate(a[0] if shared_a else a, b, _t(gate), 100, 0.8)
    _assert_same(res, whole[:3])


@pytest.mark.parametrize("n,m", [(1, 1), (7, 1), (1, 9), (5, 0)])
def test_small_and_empty_shapes(n, m):
    p = _problem(np.random.default_rng(n * 10 + m), 2, n, m)
    gate = _dense_gate(p)
    res = ph.gated_match(_t(p["a"]), _t(p["b"]), 256, 1.0, **_factored(p))
    _assert_same(res, ph.gated_match(_t(p["a"]), _t(p["b"]), 256, 1.0, _t(gate)))
    if m == 0:  # no column: the all-gated-out row
        assert (res.idx == 0).all() and (res.dist == ph.BIG).all() and not res.ok.any()
    else:
        idx, best, second, ok = _reference_top2(p, gate, 256, 1.0)
        np.testing.assert_array_equal(res.idx.numpy(), idx)
        np.testing.assert_array_equal(res.dist.numpy(), best)
        np.testing.assert_array_equal(res.second.numpy(), second)
        np.testing.assert_array_equal(res.ok.numpy(), ok)
    if m <= 1:
        assert (res.second == ph.BIG).all()


def test_batched_table_broadcasts():
    rng = np.random.default_rng(3)
    a = _t(rng.integers(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32))
    b = _t(rng.integers(0, 2**32, (3, 30, 8), dtype=np.uint64).astype(np.uint32))
    out = core.distance_matrix(a, b)
    assert out.shape == (3, 40, 30)
    for e in range(3):
        assert torch.equal(out[e], th.hamming_matrix(a, b[e]))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper raises on what its kernel does not take; it never falls back
    to the plain chain."""
    a = torch.zeros((1, 4, 8), dtype=torch.int32)
    v = torch.ones((1, 4), dtype=torch.bool)
    before = ph.gated_match_cuda.launches, ph.hamming_matrix_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ph.gated_match_cuda(a, a, 50, 1.0, valid_a=v, valid_b=v)
    with pytest.raises(ValueError, match="CUDA"):
        ph.hamming_matrix_cuda(a, a)
    assert (ph.gated_match_cuda.launches, ph.hamming_matrix_cuda.launches) == before


# ----------------------------------------------------------------- card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(p, dev):
    return dict(a=_t(p["a"], dev), b=_t(p["b"], dev), **_factored(p, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,m,shared_a", [(1, 1024, 1024, False), (1, 4096, 1024, False),
                                             (1, 1000, 777, False), (1, 1, 1, False),
                                             (20, 1024, 1024, False), (10, 1024, 1024, True),
                                             (3, 50, 0, False)])
def test_cuda_gated_match_equals_plain(card, nb, n, m, shared_a):
    p = _problem(np.random.default_rng(n + m + nb), nb, n, m, shared_a=shared_a)
    t = _on(p, card)
    a, b = t.pop("a"), t.pop("b")
    gate = _t(_dense_gate(p), card)
    window = {k: t[k] for k in ("uv", "radius", "xy")}
    forms = [
        (100, 0.8, t),  # the projection searches: window and octave band
        (100, 0.8, dict(gate=gate)),  # triangulation: the dense gate
        # initialization: the window alone, octave 0 folded into the masks
        (50, 0.9, dict(valid_a=t["valid_a"] & (t["octave_a"] == 0),
                       valid_b=t["valid_b"] & (t["octave_b"] == 0), **window)),
        # the reference keyframe: no window, no octave band
        (50, 0.7, dict(valid_a=t["valid_a"], valid_b=t["valid_b"])),
    ]
    for max_dist, ratio, kw in forms:
        before = ph.gated_match_cuda.launches
        got = ph.gated_match_cuda(a, b, max_dist, ratio, **kw)
        torch.cuda.synchronize()
        assert ph.gated_match_cuda.launches == before + 1
        _assert_same(got, ph.gated_match(a, b, max_dist, ratio, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,m", [(0, 1024, 1024), (0, 4096, 1024), (0, 1000, 777), (0, 1, 1),
                                    (20, 1024, 1024), (3, 37, 129)])
def test_cuda_table_equals_plain(card, nb, n, m):
    rng = np.random.default_rng(n + m)
    shape_b = (nb, m, 8) if nb else (m, 8)
    a = _t(rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32), card)
    b = _t(rng.integers(0, 2**32, shape_b, dtype=np.uint64).astype(np.uint32), card)
    before = ph.hamming_matrix_cuda.launches
    out = ph.hamming_matrix_cuda(a, b)
    torch.cuda.synchronize()
    assert ph.hamming_matrix_cuda.launches == before + 1
    assert torch.equal(out, th.hamming_matrix(a, b))


@pytest.mark.cuda
def test_cuda_matchers_launch_once_and_never_fall_back(card):
    """Every matcher is one launch of the fused kernel; a tensor the kernel
    does not take raises instead of reaching the plain chain."""
    p = _problem(np.random.default_rng(4), 6, 256, 200)
    t = _on(p, card)
    feats = FrameFeatures(xy=t["xy"], response=torch.zeros_like(t["radius"][:, :200]),
                          angle=torch.zeros_like(t["radius"][:, :200]), octave=t["octave_b"],
                          desc=t["b"], valid=t["valid_b"])
    before = ph.gated_match_cuda.launches
    fused = matchers.fuse_candidates(t["a"], t["uv"], t["valid_a"], t["octave_a"], feats,
                                     t["radius"] / 3.0)
    assert ph.gated_match_cuda.launches == before + 1
    plain = matchers.fuse_candidates(*(x.cpu() for x in (t["a"], t["uv"], t["valid_a"],
                                                         t["octave_a"])),
                                     FrameFeatures(*(x.cpu() for x in feats)),
                                     (t["radius"] / 3.0).cpu())
    for x, y in zip(fused, plain):
        assert torch.equal(x.cpu(), y)
    with pytest.raises(TypeError):
        core.match_with_gate(t["a"].long(), t["b"], _t(_dense_gate(p), card))
    with pytest.raises(ValueError, match="window"):  # no matcher gates by octave alone
        ph.gated_match_cuda(t["a"], t["b"], 50, 1.0, valid_a=t["valid_a"], valid_b=t["valid_b"],
                            octave_a=t["octave_a"], octave_b=t["octave_b"])
    assert ph.gated_match_cuda.launches == before + 1
