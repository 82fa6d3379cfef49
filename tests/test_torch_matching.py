"""Port parity: the gated matcher core and the front-end matchers
(os1_tpu_torch.matching). Same numpy inputs into both packages; indices,
distances and masks must be equal exactly (tolerance 0), including the
built-in ties: duplicate descriptor rows (distance ties -> lowest index),
shared columns (mutual-best ties -> lowest row) and equal histogram bins
(top-3 ties -> lower bin)."""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.features.orb import FrameFeatures as JFeats  # noqa: E402
from os1_tpu.matching import core as jcore  # noqa: E402
from os1_tpu.matching import matchers as jmatch  # noqa: E402
from os1_tpu_torch.features.orb import FrameFeatures as TFeats  # noqa: E402
from os1_tpu_torch.matching import core as tcore  # noqa: E402
from os1_tpu_torch.matching import matchers as tmatch  # noqa: E402


def _desc_with_ties(rng, n, m, return_src=False):
    """A [n, 8], B [m, 8] uint32 where B repeats rows (distance ties) and A
    rows are noisy copies of B rows (many small distances)."""
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]  # duplicate rows -> exact ties
    src = rng.integers(0, m, n)
    flips = (rng.random((n, 8)) < 0.15).astype(np.uint32) << rng.integers(0, 32, (n, 8)).astype(np.uint32)
    a = b[src] ^ flips
    a[:, 0] |= np.uint32(1 << 31)
    return (a, b, src) if return_src else (a, b)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _eq(jres, tres):
    ok_j = np.asarray(jres.ok)
    np.testing.assert_array_equal(tres.ok.numpy(), ok_j)
    np.testing.assert_array_equal(tres.idx.numpy()[ok_j], np.asarray(jres.idx)[ok_j])
    np.testing.assert_array_equal(tres.dist.numpy(), np.asarray(jres.dist))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ratio,max_dist", [(1.0, 50), (0.8, 100), (0.9, 256)])
def test_match_with_gate_and_mutual_best(seed, ratio, max_dist):
    rng = np.random.default_rng(seed)
    a, b = _desc_with_ties(rng, 200, 150)
    gate = rng.random((200, 150)) < 0.3
    jr = jcore.match_with_gate(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gate), max_dist, ratio)
    tr = tcore.match_with_gate(_t(a), _t(b), _t(gate), max_dist, ratio)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    _eq(jr, tr)
    _eq(jcore.mutual_best(jr, 150), tcore.mutual_best(tr, 150))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_consistency_with_histogram_ties(seed):
    rng = np.random.default_rng(seed)
    n, m = 120, 90
    idx = rng.integers(0, m, n)
    ok = rng.random(n) < 0.8
    # Four bins with exactly equal counts: the top-3 must keep the lower bins.
    bins = np.repeat(np.array([3, 7, 11, 20]), 30)
    ang_b = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    rot = (bins + 0.5) * (2 * np.pi / 30)
    ang_a = (ang_b[idx] + rot).astype(np.float32)
    ang_a[:5] = ang_b[idx[:5]] - 0.3  # negative differences wrap
    res_j = jcore.MatchResult(idx=jnp.asarray(idx, jnp.int32), dist=jnp.zeros(n, jnp.int32),
                              ok=jnp.asarray(ok))
    res_t = tcore.MatchResult(idx=torch.from_numpy(idx), dist=torch.zeros(n, dtype=torch.int32),
                              ok=torch.from_numpy(ok))
    jr = jcore.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), res_j)
    tr = tcore.rotation_consistency(torch.from_numpy(ang_a), torch.from_numpy(ang_b), res_t)
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))


def _feats(rng, n, a_desc=None, xy=None, octave=None):
    xy = rng.uniform(20, 300, (n, 2)).astype(np.float32) if xy is None else xy
    fields = dict(
        xy=xy, response=rng.uniform(0, 50, n).astype(np.float32),
        angle=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        octave=rng.integers(0, 3, n).astype(np.int32) if octave is None else octave,
        desc=a_desc if a_desc is not None else rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32),
        valid=rng.random(n) < 0.9,
    )
    return (JFeats(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TFeats(**{k: _t(v) for k, v in fields.items()}), fields)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_initialization(seed):
    rng = np.random.default_rng(seed)
    a, b, src = _desc_with_ties(rng, 256, 256, return_src=True)
    octave = (rng.random(256) < 0.2).astype(np.int32)  # mostly level 0
    j2, t2, f2 = _feats(rng, 256, b, octave=octave)
    xy1 = (f2["xy"][src] + rng.normal(0, 20, (256, 2))).astype(np.float32)
    j1, t1, _ = _feats(rng, 256, a, xy=xy1, octave=octave[src])
    jr = jmatch.search_for_initialization(j1, j2)
    tr = tmatch.search_for_initialization(t1, t2)
    assert int(np.asarray(jr.ok).sum()) > 10
    _eq(jr, tr)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("unique", [True, False])
def test_search_by_projection(seed, unique):
    rng = np.random.default_rng(seed)
    a, b, src = _desc_with_ties(rng, 300, 256, return_src=True)
    jf, tf, f = _feats(rng, 256, b)
    uv = (f["xy"][src] + rng.normal(0, 3, (300, 2))).astype(np.float32)
    valid = rng.random(300) < 0.9
    octv = np.clip(f["octave"][src] + rng.integers(-1, 2, 300), 0, 2).astype(np.int32)
    radius = rng.uniform(2, 12, 300).astype(np.float32)
    jr = jmatch.search_by_projection(jnp.asarray(a), jnp.asarray(uv), jnp.asarray(valid),
                                     jnp.asarray(octv), jf, jnp.asarray(radius), unique=unique)
    tr = tmatch.search_by_projection(_t(a), _t(uv), _t(valid), _t(octv), tf, _t(radius),
                                     unique=unique)
    assert int(np.asarray(jr.ok).sum()) > 10
    _eq(jr, tr)


def test_predicted_octave():
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.2, 5.0, 500).astype(np.float32)
    maxd = rng.uniform(0.5, 8.0, 500).astype(np.float32)
    ref = np.asarray(jmatch.predicted_octave(jnp.asarray(dist), jnp.asarray(maxd), 1.2, 8))
    out = tmatch.predicted_octave(_t(dist), _t(maxd), 1.2, 8)
    np.testing.assert_array_equal(out.numpy(), ref)
