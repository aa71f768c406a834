"""Port parity: the corner detectors (``kernels/corners.py``: GFTT, ORB,
BRISK) against the JAX package, on the CPU.

Tolerances: the responses (min-eigenvalue, Harris, FAST score) within 1e-5
of their scale (the same f32 formulas; box sums in the reference's order);
the intensity-centroid angle within 1e-4 rad; the resize against
``jax.image.resize`` within 1e-5 at every ORB and BRISK scale. Detections
on ``tests/test_detectors.py``'s rectangle image and on a textured 256^2
view: the same number of keypoints, >= 99% at the reference's rank within
1e-3 px with the same size; where the resize's f32 rounding (a few ulp)
splits a tie between layers, keypoints whose reference scores lie within
2e-6 of each other may trade ranks (the rectangle's BRISK layers do).
Exact ties keep the lower index first, as ``lax.top_k``. The measure is
``tools.keypoint_agreement.rank_agreement``, the one
``chip_smoke.py``'s (m) holds the card to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.kernels import corners as jc
from regard3d_tpu_torch.ingest import synth
from regard3d_tpu_torch.kernels import corners as tc
from regard3d_tpu_torch.tools.keypoint_agreement import rank_agreement
from tests.test_detectors import _rect_image

torch.set_num_threads(min(2, torch.get_num_threads()))

DETECTORS = ("detect_gftt", "detect_orb", "detect_brisk")
MAX_KP = 512


@functools.lru_cache(maxsize=None)
def _textured():
    ds = synth.make_dataset("fountain", n_cams=2, hw=256, seed=0)
    return np.asarray(ds["images"][0], np.float32)


def _image(name):
    return _rect_image() if name == "rect" else _textured()


def _jdet(name):
    return jax.jit(functools.partial(getattr(jc, name),
                                     max_keypoints=MAX_KP))


def _rows(k):
    """(xy, size, score, mask) of image 0 (``rank_agreement``'s rows)."""
    return tuple(np.asarray(getattr(k, f)[0]) for f in (
        "xy", "scale", "score", "mask"))


@pytest.mark.parametrize("img", ["rect", "textured"])
def test_responses_match_reference(img):
    b = _image(img)[None]
    for fn in ("min_eig_response", "harris_response"):
        a = np.asarray(getattr(jc, fn)(jnp.asarray(b)))
        t = getattr(tc, fn)(torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(t, a, rtol=0, atol=1e-5 * np.abs(a).max(),
                                   err_msg=fn)
    for thr in (20.0 / 255.0, 30.0 / 255.0):
        a = np.asarray(jc.fast_score(jnp.asarray(b), thr))
        t = tc.fast_score(torch.as_tensor(b), thr).numpy()
        np.testing.assert_allclose(t, a, rtol=0, atol=1e-6)
        assert ((a > 0) == (t > 0)).all()


def test_ic_angle_matches_reference():
    rng = np.random.default_rng(0)
    img = np.stack([_textured(), rng.uniform(size=(256, 256))]).astype(
        np.float32)
    x = rng.integers(0, 256, size=(2, 200)).astype(np.float32)
    y = rng.integers(0, 256, size=(2, 200)).astype(np.float32)
    valid = rng.uniform(size=(2, 200)) > 0.1
    a = np.asarray(jax.vmap(jc.ic_angle)(*(jnp.asarray(v) for v in (
        img, x, y, valid))))
    t = tc.ic_angle(*(torch.as_tensor(v) for v in (img, x, y, valid))).numpy()
    np.testing.assert_allclose(t, a, rtol=0, atol=1e-4)
    assert (t[~valid] == 0).all()


def test_resize_matches_jax_image_resize_at_every_scale():
    """jax.image.resize(method="linear") antialiases when it downsamples;
    F.interpolate(antialias=True) is the same filter. ORB's 8 levels,
    BRISK's 6 layers, and BRISK's neighbour layers resampled up and down
    to each layer's size."""
    rng = np.random.default_rng(1)
    img = np.stack([_textured(),
                    rng.uniform(size=(256, 256)).astype(np.float32)])
    H = W = 256
    sizes = [(max(round(H / 1.2 ** k), 32), max(round(W / 1.2 ** k), 32))
             for k in range(1, 8)]
    brisk = [max(round(H / s), 16) for s in (1.0, 1.5, 2.0, 3.0, 4.0, 6.0)]
    sizes += [(h, h) for h in brisk[1:]]
    pairs = [((a, a), (b, b)) for a, b in zip(brisk, brisk[1:])]
    pairs += [(b, a) for a, b in pairs]
    for src, dst in [((H, W), s) for s in sizes] + pairs:
        im = img if src == (H, W) else np.asarray(jc._resize_bilinear(
            jnp.asarray(img), *src))
        a = np.asarray(jc._resize_bilinear(jnp.asarray(im), *dst))
        t = tc._resize_bilinear(torch.as_tensor(im), *dst).numpy()
        assert t.shape == a.shape
        np.testing.assert_allclose(t, a, rtol=0, atol=1e-5,
                                   err_msg=f"{src} -> {dst}")


def test_ties_keep_the_lower_index_first():
    x = np.asarray([3, 1, 2, 2, 5, 0, 1, 1], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 5)
    vt, it = tc._top_k(torch.as_tensor(x), 5)
    assert it.tolist() == np.asarray(ij).tolist() == [4, 0, 2, 3, 1]
    # a score map of 8-bit FAST-like values: many exact ties
    rng = np.random.default_rng(2)
    score = (rng.integers(0, 6, size=(2, 48, 40)) / 255.0).astype(np.float32)
    for k in (17, 300):
        a = [np.asarray(v) for v in jc._topk_points(jnp.asarray(score), k)]
        t = [v.numpy() for v in tc._topk_points(torch.as_tensor(score), k)]
        for u, v in zip(a, t):
            np.testing.assert_array_equal(v, u)


def test_orb_levels_distribution_matches_reference():
    for n, lv, s in ((4096, 8, 1.2), (500, 8, 1.2), (37, 5, 1.5)):
        assert tc.orb_levels_distribution(n, lv, s) == \
            jc.orb_levels_distribution(n, lv, s)


@pytest.mark.parametrize("img", ["rect", "textured"])
@pytest.mark.parametrize("det", DETECTORS)
def test_detectors_match_reference(det, img):
    b = _image(img)[None]
    kj = _jdet(det)(jnp.asarray(b))
    kt = getattr(tc, det)(torch.as_tensor(b), max_keypoints=MAX_KP)
    in_rank, in_group = rank_agreement(_rows(kj), _rows(kt))
    assert in_group >= 0.99, (in_rank, in_group)
    if img == "textured":
        assert in_rank >= 0.99, in_rank
    m = kt.mask[0].numpy()
    assert int(m.sum()) > 0
    np.testing.assert_allclose(kt.angle[0].numpy()[m],
                               np.asarray(kj.angle[0])[m], rtol=0,
                               atol=1e-3)


def test_detectors_honour_true_sizes_in_a_padded_batch():
    """A bucket's padded batch (a full image, one cropped to 120 x 100, a
    zero-size slot): the reference's keypoint masks, keypoints inside each
    image's true extent; GFTT finds nothing in the zero-size slot (ORB and
    BRISK clamp a level's extent to at least 32 and 16 pixels, as the
    reference does)."""
    img = np.zeros((3, 128, 160), np.float32)
    img[0] = _rect_image()
    img[1, :100, :120] = _rect_image()[:100, :120]
    w, h = np.asarray([160, 120, 0]), np.asarray([128, 100, 0])
    for det in DETECTORS:
        kt = getattr(tc, det)(torch.as_tensor(img), torch.as_tensor(w),
                              torch.as_tensor(h), max_keypoints=64)
        kj = jax.jit(functools.partial(getattr(jc, det), max_keypoints=64))(
            jnp.asarray(img), jnp.asarray(w), jnp.asarray(h))
        np.testing.assert_array_equal(kt.mask.numpy(), np.asarray(kj.mask))
        xy = kt.xy[1].numpy()[kt.mask[1].numpy()]
        assert len(xy) and (xy[:, 0] < 120).all() and (xy[:, 1] < 100).all()
        if det == "detect_gftt":
            assert not kt.mask[2].any()
