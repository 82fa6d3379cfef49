"""Port parity: pyramid, FAST + NMS, cell top-k and the whole ORB extractor
(os1_tpu_torch.ops, os1_tpu_torch.features).

The target is identity: the port makes the reference's bf16 casts at the
same places (FAST ring arithmetic, pyramid resize, BRIEF samples), so
pyramid levels, margins, keypoints, octaves, responses and descriptors must
be bit-equal (tolerance 0). Orientation angles come from float32 dot
products summed in another order: atol 1e-4 rad (the 64 orientation bins are
0.098 rad wide; the descriptors, which depend on the bin, must still be
identical).

Measured shortfall: padding lanes (valid=False) whose 32x32 patch lies in a
flat, edge-replicated region have moments that cancel to exactly 0 in the
reference's dot product but leave a rounding residue in torch's, so their
angle and descriptor differ (4 of 256 and 3 of 256 lanes of the two 120x160
frames below; none at 240x320). No matcher reads an invalid lane, so the
comparison of angles and descriptors is over valid lanes.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from os1_tpu.features import orb as jorb  # noqa: E402
from os1_tpu.io import synthetic  # noqa: E402
from os1_tpu.ops import fast as jfast  # noqa: E402
from os1_tpu.ops import image as jimage  # noqa: E402
from os1_tpu.ops import topk as jtopk  # noqa: E402
from os1_tpu_torch.features import orb as torb  # noqa: E402
from os1_tpu_torch.ops import fast as tfast  # noqa: E402
from os1_tpu_torch.ops import image as timage  # noqa: E402
from os1_tpu_torch.ops import topk as ttopk  # noqa: E402

SIZES = [(120, 160), (240, 320)]


def _frame(h, w, idx=0):
    K = np.array([[h * 1.08, 0, w / 2], [0, h * 1.08, h / 2], [0, 0, 1.0]])
    scene = synthetic.default_scene(seed=3)
    T = synthetic.orbit_trajectory(30, advance=0.05)[idx]
    return np.clip(synthetic.render(scene, T, K, h, w), 0, 255).astype(np.uint8).astype(np.float32)


def _cfgs(h, w):
    kw = dict(height=h, width=w, n_features=512 if h > 128 else 256, n_levels=4)
    return jorb.OrbConfig(**kw), torb.OrbConfig(**kw)


def test_brief_tables_identical():
    np.testing.assert_array_equal(torb._brief_pattern(42), jorb._brief_pattern(42))
    np.testing.assert_array_equal(torb._rotated_patch_table(42), jorb._rotated_patch_table(42))
    for a, b in zip(torb._ic_patch_weights(), jorb._ic_patch_weights()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", SIZES)
def test_pyramid_fast_nms_topk(h, w):
    img = _frame(h, w)
    cj, _ = _cfgs(h, w)
    Ry, Rx = jimage.pyramid_matrices(h, w, cj.level_sizes)
    pj = np.asarray(jimage.build_pyramid_stack(jnp.asarray(img), jnp.asarray(Ry), jnp.asarray(Rx)))
    pt = timage.build_pyramid_stack(torch.from_numpy(img), torch.from_numpy(Ry[1:]).bfloat16().float(),
                                    torch.from_numpy(Rx[1:]).bfloat16().float())
    np.testing.assert_array_equal(pt.numpy(), pj)

    hb = np.array([s[0] for s in cj.level_sizes], np.int32)
    wb = np.array([s[1] for s in cj.level_sizes], np.int32)
    sj = jfast.nms3x3(jfast.fast_with_fallback(jnp.asarray(pj), 20.0, 7.0,
                                               bounds=(jnp.asarray(hb), jnp.asarray(wb))))
    st = tfast.nms3x3(tfast.fast_with_fallback(pt, 20.0, 7.0,
                                               bounds=(torch.from_numpy(hb).long(), torch.from_numpy(wb).long())))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (np.asarray(sj) > 0).sum() > 100

    xyj, rj, vj = jtopk.balanced_cell_topk_batch(sj, 16, 4, 200)
    xyt, rt, vt = ttopk.balanced_cell_topk_batch(st, 16, 4, 200)
    np.testing.assert_array_equal(xyt.numpy(), np.asarray(xyj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))

    bj = np.asarray(jimage.gaussian_blur(jimage.replicate_level_edges(
        jnp.asarray(pj), jnp.asarray(hb), jnp.asarray(wb))))
    bt = timage.gaussian_blur(timage.replicate_level_edges(
        pt, torch.from_numpy(hb).long(), torch.from_numpy(wb).long()))
    np.testing.assert_array_equal(bt.numpy(), bj)


def test_topk_ties_break_to_lower_index():
    """Flat score plateaus: equal responses must be taken in index order."""
    s = np.zeros((2, 64, 64), np.float32)
    s[:, 8:40, 8:40] = 5.0
    s[1, 20:24, 20:24] = 9.0
    xyj, rj, vj = jtopk.balanced_cell_topk_batch(jnp.asarray(s), 16, 4, 40)
    xyt, rt, vt = ttopk.balanced_cell_topk_batch(torch.from_numpy(s), 16, 4, 40)
    np.testing.assert_array_equal(xyt.numpy(), np.asarray(xyj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("h,w", SIZES)
def test_extractor_identical(h, w):
    cj, ct = _cfgs(h, w)
    ej, et = jorb.make_extractor(cj), torb.make_extractor(ct, "cpu")
    for idx in (0, 17):
        img = _frame(h, w, idx)
        fj = ej(jnp.asarray(img))
        ft = et(torch.from_numpy(img))
        np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
        np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
        np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
        np.testing.assert_array_equal(ft.response.numpy(), np.asarray(fj.response))
        v = np.asarray(fj.valid)
        assert v.sum() > 0.5 * len(v)
        np.testing.assert_allclose(ft.angle.numpy()[v], np.asarray(fj.angle)[v], atol=1e-4)
        np.testing.assert_array_equal(ft.desc.numpy().view(np.uint32)[v], np.asarray(fj.desc)[v])
        rows_differ = (ft.desc.numpy().view(np.uint32) != np.asarray(fj.desc)).any(1)
        assert rows_differ.mean() <= 4 / 256  # padding lanes only (see module note)
