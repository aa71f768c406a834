"""Port parity: the feature half of the stage (``kernels/scale_space.py``,
``kernels/detect.py``, ``kernels/liop.py``, ``ingest/image_io.py``) of
``regard3d_tpu_torch`` against the JAX package and the reference goldens.

The same numpy images (the AKAZE golden set: three 320 px views) go
through both packages on the CPU; the JAX side is jitted at "highest"
precision. The two packages sum their convolutions in different orders
(XLA against oneDNN), so scale-space values agree to f32 rounding, not
bitwise, and a keypoint may move by that rounding. The port's detector and descriptor are then held to the
reference's own outputs under the gates the JAX package's golden tests use
(``tests/test_akaze_golden.py``, ``tests/test_liop.py``). The detector menu
(GFTT, ORB, BRISK on the device; MSER, TBMR through the native library)
goes through both packages' ``extract_features`` on one fountain view at
256 px, each test stating its gate.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.ingest import image_io as jio
from regard3d_tpu.kernels import detect as jd
from regard3d_tpu.kernels import liop as jl
from regard3d_tpu.kernels import scale_space as jss
from regard3d_tpu_torch.core import types as tt
from regard3d_tpu_torch.ingest import image_io as tio
from regard3d_tpu_torch.kernels import detect as td
from regard3d_tpu_torch.kernels import liop as tl
from regard3d_tpu_torch.kernels import scale_space as tss
from tests import test_akaze_golden as golden_gate

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))

DATA = os.path.join(os.path.dirname(__file__), "data")
THR = 0.0007           # the "normal" sensitivity preset, the stage default


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def images():
    g = np.load(os.path.join(DATA, "akaze_golden.npz"))
    return g["images"].astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def detections(images):
    """Both packages' detections (and the reference's LIOP descriptors of
    its own keypoints) on the golden images at the default preset."""
    cfg_j = jss.ScaleSpaceConfig(dthreshold=THR)

    def ref(im):
        kps = jd.detect_akaze(im, cfg=cfg_j, max_keypoints=512)
        return kps, jl.describe_liop(im, kps, 8.0, use_pyramid=False)

    kj, dj = jax.jit(ref)(jnp.asarray(images))
    kt = td.detect_akaze(torch.tensor(images),
                         cfg=tss.ScaleSpaceConfig(dthreshold=THR),
                         max_keypoints=512)
    return kj, dj, kt


# ---------------------------------------------------------------------------
# scale space
# ---------------------------------------------------------------------------

def test_scale_space_helpers_match_reference(rng):
    cfg_j, cfg_t = jss.ScaleSpaceConfig(), tss.ScaleSpaceConfig()
    assert jss.level_metas(cfg_j, 480, 640) == [
        jss.LevelMeta(**vars(m)) for m in tss.level_metas(cfg_t, 480, 640)]
    for T in (0.3, 2.5, 17.0):
        np.testing.assert_array_equal(tss.fed_tau_by_process_time(T),
                                      jss.fed_tau_by_process_time(T))
    for sigma in (1.0, 1.2, 1.6):
        np.testing.assert_array_equal(tss.gaussian_kernel1d(sigma),
                                      jss.gaussian_kernel1d(sigma))
    for s in (1, 2, 3):
        for a, b in zip(tss.scharr_kernels(s), jss.scharr_kernels(s)):
            np.testing.assert_array_equal(a, b)
    img = rng.uniform(size=(2, 40, 56)).astype(np.float32)
    k = jss.gaussian_kernel1d(1.6)
    np.testing.assert_allclose(
        _np(tss.conv_sep(torch.tensor(img), k, k)),
        _np(jss.conv_sep(jnp.asarray(img), k, k, use_matmul=False)),
        atol=1e-6)
    for dx, dy, s in ((1, 0, 1), (0, 1, 2)):
        np.testing.assert_allclose(
            _np(tss.scharr(torch.tensor(img), dx, dy, s)),
            _np(jss.scharr(jnp.asarray(img), dx, dy, s)), atol=1e-6)
    # (a 2x2 mean: one ulp apart where the two sum in another order)
    np.testing.assert_allclose(_np(tss.halfsample(torch.tensor(img))),
                               _np(jss.halfsample(jnp.asarray(img))),
                               rtol=0, atol=1.2e-7)
    g = rng.uniform(0.1, 1.0, size=img.shape).astype(np.float32)
    np.testing.assert_allclose(
        _np(tss.nld_step(torch.tensor(img), torch.tensor(g), 0.2)),
        _np(jss.nld_step(jnp.asarray(img), jnp.asarray(g), 0.2)), atol=1e-6)
    kk = np.asarray([0.02, 0.05], np.float32)
    np.testing.assert_allclose(
        _np(tss.pm_g2(torch.tensor(img), torch.tensor(g), torch.tensor(kk))),
        _np(jss.pm_g2(jnp.asarray(img), jnp.asarray(g), jnp.asarray(kk))),
        rtol=1e-6)


def test_build_scale_space_matches_reference(images):
    """Contrast factor and every level's diffused and smoothed images, to
    f32 rounding (values in [0, 1]; the FED steps accumulate it)."""
    crop = images[:, :160, :160]
    cfg_j = jss.ScaleSpaceConfig(dthreshold=THR)

    def ref(im):
        levels, k = jss.build_scale_space(im, cfg_j)
        return [(lv.Lt, lv.Lsmooth) for lv in levels], k

    lj, kj = jax.jit(ref)(jnp.asarray(crop))
    lt, kt = tss.build_scale_space(torch.tensor(crop),
                                   tss.ScaleSpaceConfig(dthreshold=THR))
    np.testing.assert_allclose(_np(kt), _np(kj), rtol=1e-5)
    metas = jss.level_metas(cfg_j, 160, 160)
    assert len(lt) == len(lj) == len(metas)
    for a, (Lt, Ls), m in zip(lt, lj, metas):
        assert a.meta.esigma == m.esigma and a.meta.taus == m.taus
        np.testing.assert_allclose(_np(a.Lt), _np(Lt), atol=2e-5)
        np.testing.assert_allclose(_np(a.Lsmooth), _np(Ls), atol=2e-5)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def test_detect_akaze_matches_reference(images, detections):
    """Counts within 1%; >= 99% of the reference's keypoints have a port
    keypoint within 0.01 px, with the same size and orientation."""
    kj, _, kt = detections
    for b in range(images.shape[0]):
        mj, mt = np.asarray(kj.mask[b]), kt.mask[b].numpy()
        xy_j, xy_t = np.asarray(kj.xy[b])[mj], kt.xy[b].numpy()[mt]
        assert len(xy_j) > 20
        assert abs(len(xy_t) - len(xy_j)) <= 0.01 * len(xy_j) + 1
        d = np.linalg.norm(xy_j[:, None] - xy_t[None], axis=-1)
        j = np.argmin(d, 1)
        close = d[np.arange(len(xy_j)), j] <= 0.01
        assert close.mean() >= 0.99, close.mean()
        np.testing.assert_allclose(kt.scale[b].numpy()[mt][j[close]],
                                   np.asarray(kj.scale[b])[mj][close],
                                   rtol=1e-6)
        da = (kt.angle[b].numpy()[mt][j[close]]
              - np.asarray(kj.angle[b])[mj][close])
        assert np.abs(np.angle(np.exp(1j * da))).max() < 1e-3
        # the port keeps the reference's order (descending response)
        np.testing.assert_array_equal(np.argsort(-kt.score[b].numpy()[mt],
                                                 kind="stable"),
                                      np.arange(mt.sum()))


def test_detector_internals_match_reference(images):
    """Hessian responses to f32 rounding, and the extrema masks equal
    wherever the suppression duel is not a near-tie."""
    cfg_j = jss.ScaleSpaceConfig(dthreshold=THR)
    cfg_t = tss.ScaleSpaceConfig(dthreshold=THR)
    crop = images[:1, :160, :160]

    def ref(im):
        levels, _ = jss.build_scale_space(im, cfg_j)
        dets = jd.det_hessian(levels)[0]
        return dets, jd.find_extrema(levels, dets, cfg_j)

    dj, kj = jax.jit(ref)(jnp.asarray(crop))
    lt, _ = tss.build_scale_space(torch.tensor(crop), cfg_t)
    dt = td.det_hessian(lt)[0]
    scale = max(float(np.abs(np.asarray(d)).max()) for d in dj)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4 * scale)
    kt = td.find_extrema(lt, dt, cfg_t)
    n = sum(int(np.asarray(k).sum()) for k in kj)
    n_diff = sum(int((_np(a) != _np(b)).sum()) for a, b in zip(kt, kj))
    assert n > 50 and n_diff <= 0.01 * n, (n, n_diff)


def test_port_detector_against_reference_goldens():
    """The reference AKAZE's own keypoints (tests/data/akaze_golden.npz)
    under the JAX package's golden gates, at every sensitivity preset."""
    g = np.load(os.path.join(DATA, "akaze_golden.npz"))
    imgs = torch.tensor(g["images"].astype(np.float32) / 255.0)
    counts = []
    for thr in golden_gate.THRESHOLDS:
        kps = td.detect_akaze(imgs, cfg=tss.ScaleSpaceConfig(
            dthreshold=float(thr)), max_keypoints=4096)
        mask = kps.mask.numpy()
        counts.append(mask.sum(1))
        for i in range(imgs.shape[0]):
            ref = g[f"kp_{i}_{thr:g}"]
            m = mask[i]
            xy = kps.xy[i].numpy()[m]
            ratio = len(xy) / max(len(ref), 1)
            lo, hi = golden_gate.COUNT_RATIO
            assert lo <= ratio <= hi, (i, thr, len(xy), len(ref))
            s = golden_gate._match_stats(ref, xy, kps.scale[i].numpy()[m],
                                         kps.angle[i].numpy()[m])
            assert s["recall"] >= golden_gate.MIN_RECALL, (i, thr, s)
            assert s["pos_err"] <= golden_gate.MAX_MEDIAN_POS_ERR, s
            assert s["size_err"] <= golden_gate.MAX_MEDIAN_SIZE_LOGRATIO, s
            assert s["ang_err"] <= golden_gate.MAX_MEDIAN_ANGLE_ERR, s
    counts = np.stack(counts)
    assert (np.diff(counts, axis=0) >= 0).all(), counts   # preset order


# ---------------------------------------------------------------------------
# LIOP
# ---------------------------------------------------------------------------

def test_liop_from_patches_matches_reference(rng):
    """Same patches in, same descriptors out: the binning is integer
    arithmetic on the same comparisons (exact up to the final norm)."""
    x = np.linspace(-1, 1, 41)
    xx, yy = np.meshgrid(x, x)
    smooth = [np.sin(3 * xx * a + 2 * yy) + 0.3 * np.cos(5 * yy * a)
              for a in np.linspace(0.5, 2.0, 16)]
    patches = np.concatenate([rng.uniform(size=(48, 41, 41)),
                              np.stack(smooth)]).astype(np.float32)
    want = _np(jax.jit(jl.liop_from_patches)(jnp.asarray(patches)))
    got = _np(tl.liop_from_patches(torch.tensor(patches)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(_np(tl.liop_from_patch(torch.tensor(
        patches[0]))), want[0], atol=1e-6)


def test_port_liop_against_reference_golden():
    """VLFeat LIOP's own vectors (tests/data/liop_golden.npz) under the
    gates of tests/test_liop.py: bitwise binning on the twelve generic
    patches, high agreement on the two perfectly symmetric ones."""
    data = np.load(os.path.join(DATA, "liop_golden.npz"))
    got = tl.liop_from_patches(torch.tensor(data["patches"])).numpy()
    want = data["descs"]
    err = np.abs(got - want).max(axis=1)
    cos = np.sum(got * want, 1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1), 1e-12)
    assert float(err[:12].max()) < 1e-5, err
    assert float(cos.min()) > 0.9, cos


def test_patch_warps_match_reference(rng):
    B, H, W, K = 2, 256, 256, 64
    img = rng.uniform(size=(B, H, W)).astype(np.float32)
    xy = rng.uniform(30, 220, size=(B, K, 2)).astype(np.float32)
    size = rng.uniform(4.8, 10.0, size=(B, K)).astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi, size=(B, K)).astype(np.float32)
    pj = jl.warp_patches(jnp.asarray(img[0]), jnp.asarray(xy[0]),
                         jnp.asarray(size[0]), jnp.asarray(angle[0]), 8.0)
    pt = tl.warp_patches(torch.tensor(img[0]), torch.tensor(xy[0]),
                         torch.tensor(size[0]), torch.tensor(angle[0]), 8.0)
    # the two libms' cos/sin of the patch angle may differ by an ulp, which
    # moves a sample by ~1e-6 px: on this white-noise image (gradients up
    # to 1 per px) that is a few 1e-6 of intensity
    np.testing.assert_allclose(_np(pt), _np(pj), atol=5e-5)
    # the reference's windowed pyramid warp (its TPU formulation), kept in
    # the port for parity; large keypoints sample a coarser level
    size[1] = rng.uniform(4.8, 40.0, size=K)
    img_id = np.repeat(np.arange(B), K).astype(np.int32)
    args = (img, img_id, xy.reshape(-1, 2), size.reshape(-1),
            angle.reshape(-1))
    wj = jl.warp_patches_pyramid(*(jnp.asarray(a) for a in args), 8.0,
                                 chunk=64)
    wt = tl.warp_patches_pyramid(*(torch.tensor(a) for a in args), 8.0,
                                 chunk=64)
    np.testing.assert_allclose(_np(wt), _np(wj), atol=1e-4)


@pytest.mark.parametrize("use_pyramid", [False, True])
def test_describe_liop_on_reference_keypoints(images, detections,
                                              use_pyramid):
    """The reference's detections (handed over with keypoints_from_numpy)
    described by both packages, with the direct warp (the stage's) and the
    windowed pyramid warp: the warp and binning are the same arithmetic,
    only the sigma=1.2 patch smoothing (and the pyramid's hat-weight
    contraction) sums in another order, so >= 99% of descriptors agree
    within 1e-4 (L2); the rest moved a near-tied pixel to its neighbouring
    ordinal bin (cosine > 0.99)."""
    kj, dj, _ = detections
    if use_pyramid:
        dj = jax.jit(lambda im, k: jl.describe_liop(im, k, 8.0,
                                                    use_pyramid=True))(
            jnp.asarray(images), kj)
    kt = tt.keypoints_from_numpy(*(np.asarray(getattr(kj, f)) for f in
                                   ("xy", "scale", "angle", "score", "mask")))
    dt = tl.describe_liop(torch.tensor(images), kt, 8.0,
                          use_pyramid=use_pyramid)
    m = np.asarray(kj.mask)
    a, b = np.asarray(dj.data)[m], dt.data.numpy()[m]
    assert dt.data.shape == dj.data.shape and len(a) > 100
    np.testing.assert_array_equal(dt.mask.numpy(), m)
    dist = np.linalg.norm(a - b, axis=1)
    assert (dist <= 1e-4).mean() >= 0.99, np.sort(dist)[-5:]
    assert np.sum(a * b, 1).min() > 0.99
    np.testing.assert_array_equal(dt.data.numpy()[~m], 0.0)
    dd = tt.descriptors_from_numpy(np.asarray(dj.data), np.asarray(dj.mask))
    np.testing.assert_array_equal(dd.data.numpy(), np.asarray(dj.data))
    assert dd.dim == jl.PADDED_DIM and kt.batch == images.shape[0]


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def test_image_io_matches_reference(tmp_path, rng):
    from PIL import Image
    rgb = (rng.uniform(size=(37, 53, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(rgb).save(path)
    for max_dim in (0, 40):
        np.testing.assert_array_equal(tio.load_gray(path, max_dim),
                                      jio.load_gray(path, max_dim))
    imgs = [rng.uniform(size=s).astype(np.float32)
            for s in ((37, 53), (40, 56), (37, 53), (64, 64))]
    np.testing.assert_array_equal(tio.pad_to_grid(imgs[0]),
                                  jio.pad_to_grid(imgs[0]))
    bj, bt = jio.bucket_images(imgs, max_batch=1), tio.bucket_images(
        imgs, max_batch=1)
    assert len(bj) == len(bt)
    for a, b in zip(bj, bt):
        assert a.indices == b.indices
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.true_sizes, b.true_sizes)


# ---------------------------------------------------------------------------
# the detector menu through the stage's feature driver
# ---------------------------------------------------------------------------

MENU = ("gftt", "orb", "brisk", "mser", "tbmr")


@pytest.fixture(scope="module")
def menu_image():
    from regard3d_tpu_torch.ingest import synth
    return synth.make_dataset("fountain", n_cams=2, hw=256, seed=0)[
        "images"][0].astype(np.float32)


def _liop_gate(a, b, frac=0.99, cos=0.99):
    """The LIOP gate of ``test_describe_liop_on_reference_keypoints``:
    >= ``frac`` within 1e-4 (L2), cosine > ``cos``; a flat patch's zero
    descriptor must be zero in both."""
    dist = np.linalg.norm(a - b, axis=1)
    assert (dist <= 1e-4).mean() >= frac, np.sort(dist)[-5:]
    live = np.linalg.norm(a, axis=1) > 0.5
    np.testing.assert_array_equal(np.linalg.norm(b, axis=1) > 0.5, live)
    assert np.sum(a * b, 1)[live].min() > cos


@pytest.mark.parametrize("detector", MENU)
def test_extract_features_detector_menu_matches_reference(
        menu_image, detector, tmp_path):
    """``extract_features(detector=...)`` in both packages on one view:
    the host detectors (MSER, TBMR through the native library) write the
    reference's .feat rows exactly; the device detectors (GFTT, ORB, BRISK)
    hold >= 99% of the reference's keypoints at its rank within 1e-3 px
    (``tools.keypoint_agreement.rank_agreement``). The descriptors of the
    keypoints both hold pass the LIOP gate; for the corner detectors at
    >= 97% within 1e-4 and cosine > 0.9999: their patches are small (GFTT
    3 px x 0.13, ORB 31 px x 0.025 at level 0) and bilinear samples of a
    sub-pixel neighbourhood tie often, so f32 rounding moves more pixels
    across an ordinal bin than at AKAZE's scales (measured on this view:
    97.9% GFTT, 97.8% ORB, 99.7% BRISK within 1e-4)."""
    from regard3d_tpu.pipeline import features as jf
    from regard3d_tpu_torch.pipeline import features as tf
    from regard3d_tpu_torch.tools.keypoint_agreement import rank_agreement
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    nj = jf.extract_features([menu_image], ref, detector=detector,
                             max_keypoints=512)
    nt = tf.extract_features([menu_image], port, detector=detector,
                             max_keypoints=512, device="cpu")
    assert nt == nj and nt[0] > 0
    pj, sj, aj, dj = jf.load_features(ref, 0)
    pt, st, at, dt = tf.load_features(port, 0)
    if detector in tf.HOST_DETECTORS:
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(at, aj)
        _liop_gate(dj, dt)
    else:
        rank = -np.arange(len(pj), dtype=np.float32)    # distinct ranks
        live = np.ones(len(pj), bool)
        in_rank, _ = rank_agreement((pj, sj, rank, live),
                                    (pt, st, rank, live))
        assert in_rank >= 0.99, in_rank
        same = np.abs(pj - pt).max(1) <= 1e-3
        _liop_gate(dj[same], dt[same], frac=0.97, cos=0.9999)
    with open(tf.feat_path(port, 0), "rb") as f:
        assert f.read().count(b"\n") == nt[0]
    # the native parser reads what np.loadtxt reads
    np.testing.assert_array_equal(
        np.loadtxt(tf.feat_path(port, 0), ndmin=2, dtype=np.float32)[:, :2],
        pt)


def test_detector_menu_names_match_reference():
    from regard3d_tpu.pipeline import features as jf
    from regard3d_tpu_torch.pipeline import features as tf
    assert tf.DETECTORS == jf.DETECTORS
    assert tf.HOST_DETECTORS == jf.HOST_DETECTORS
    for name in ("Classic A-KAZE", "Fast A-KAZE", "ORB", "gftt", "MSER",
                 "tbmr", "brisk", "fast_akaze"):
        assert tf.canonical_detector(name) == jf.canonical_detector(name)
        assert tf.detector_kp_size_factor(name) == \
            jf.detector_kp_size_factor(name)
    with pytest.raises(ValueError):
        tf.canonical_detector("sift")
