"""Port parity: dense MVS (``mvs/planesweep.py``, ``mvs/fusion.py``,
``mvs/driver.py``) and the interchange exporters (``export/formats.py``)
against the JAX package, on the CPU, on the reference tests' rendered
two-plane scenes (``tests/test_pipeline.render_scene``,
``tests/test_mvs._scene_from_render``).

Tolerances (f32 in both packages, sums in other orders):

* ``box_sum``, ``bilinear_sample``: within 1e-5 relative, masks identical;
  ``plane_homographies``, ``select_sources``, ``depth_range``: identical.
* ``sweep``: ``ncc`` within 1e-4 on >= 99% of pixels, the validity mask
  identical on >= 99.5%, ``idepth`` within 1e-4 relative where both are
  valid, except at plane flips (pixels where the reference's two best
  plane costs lie within 1e-5), which are counted and bounded at 1% of
  those pixels.
* ``consistency_mask``: ``accept`` identical on >= 99.5%, X within 1e-5
  relative; ``smoothed_normals`` within 1e-4 where valid.
* ``densify_scene``: point count within 2%, symmetric chamfer distance
  <= 1e-3 of the extent, and the reference test's plane gate; on the
  fountain stand-in (``ingest/synth.py``, 256 px, exact poses) the count
  within 2% and the cloud's distance and normal statistics against the
  fountain's quads within 1e-3.
* The exporters: byte-identical files from the same scene.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.export import formats as jfmt
from regard3d_tpu.mvs import driver as jdrv
from regard3d_tpu.mvs import fusion as jfus
from regard3d_tpu.mvs import planesweep as jps
from regard3d_tpu_torch.core.types import scene_from_numpy
from regard3d_tpu_torch.export import formats as tfmt
from regard3d_tpu_torch.mvs import driver as tdrv
from regard3d_tpu_torch.mvs import fusion as tfus
from regard3d_tpu_torch.mvs import planesweep as tps
from tests.test_mvs import _scene_from_render
from tests.test_pipeline import render_scene

torch.set_num_threads(min(2, torch.get_num_threads()))

T = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)


def port_scene(jscene):
    return scene_from_numpy(jsd.scene_to_numpy(jscene))


def chamfer(a, b):
    """Symmetric mean nearest-neighbour distance between point sets."""
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.fixture(scope="module")
def small():
    """5 views at 128 px (the reference's two-plane scene), uint8 images,
    both packages' scenes."""
    rng = np.random.default_rng(0)
    sc = render_scene(rng, n_cams=5, hw=128, f=165.0)
    js = _scene_from_render(sc, n_lm=120)
    images = [(np.clip(im, 0, 1) * 255).astype(np.uint8)
              for im in sc["images"]]
    return dict(sc=sc, js=js, ts=port_scene(js), images=images)


@pytest.fixture(scope="module")
def sweep_inputs(small):
    """The reference driver's inputs to one sweep: the middle view against
    its 3 sources, 32 planes, at level 0."""
    js = small["js"]
    params = jps.PlaneSweepParams(level=0, num_planes=32, num_sources=3)
    views = jdrv._posed_views(js)
    gray, _, _ = jdrv._prep_images(small["images"], js, views, 0)
    v = 2
    srcs = jdrv.select_sources(js, 3)[v]
    lo, hi = jdrv.depth_range(js, v)
    depths = jps.inverse_depth_planes(lo, hi, params.num_planes)
    pid = np.asarray(js.views.pose_id)
    Rs, Cs = np.asarray(js.poses.R), np.asarray(js.poses.C)
    K = jdrv._K_for(js, v, 0)
    homos = jps.plane_homographies(
        K, Rs[pid[v]], Cs[pid[v]],
        np.stack([jdrv._K_for(js, s, 0) for s in srcs]),
        Rs[pid[srcs]], Cs[pid[srcs]], depths)
    return dict(v=v, ref=gray[v], srcs=np.stack([gray[s] for s in srcs]),
                live=np.ones(3, bool), homos=homos.astype(np.float32),
                idepths=(1.0 / depths).astype(np.float32), depths=depths,
                K=K, srcs_ids=srcs)


@pytest.mark.parametrize("shape,w", [((16, 20), 5), ((3, 2, 40, 33), 7)])
def test_box_sum_matches_reference(rng, shape, w):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jps.box_sum(jnp.asarray(x), w))
    got = tps.box_sum(T(x), w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batched", [False, True])
def test_bilinear_sample_matches_reference(rng, batched):
    """In-bounds, out-of-bounds and non-finite coordinates: values within
    1e-5 wherever the reference's mask is set, masks identical."""
    H, W = 24, 31
    img = rng.uniform(size=(3, H, W) if batched else (H, W)).astype(
        np.float32)
    x = rng.uniform(-3, W + 2, size=(3, 500)).astype(np.float32)
    y = rng.uniform(-3, H + 2, size=(3, 500)).astype(np.float32)
    x[:, :4] = [np.nan, np.inf, -np.inf, 1e12]
    y[:, 4:8] = [np.nan, np.inf, -np.inf, -1e12]
    if batched:
        want_v, want_ok = zip(*(jps.bilinear_sample(jnp.asarray(img[b]),
                                                    jnp.asarray(x[b]),
                                                    jnp.asarray(y[b]))
                                for b in range(3)))
    else:
        want_v, want_ok = jps.bilinear_sample(jnp.asarray(img),
                                              jnp.asarray(x), jnp.asarray(y))
    want_v, want_ok = np.asarray(want_v), np.asarray(want_ok)
    got_v, got_ok = tps.bilinear_sample(T(img), T(x), T(y))
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert want_ok.mean() > 0.5
    np.testing.assert_allclose(got_v.numpy()[want_ok], want_v[want_ok],
                               rtol=1e-5, atol=1e-6)


def test_plane_homographies_and_source_selection_identical(small,
                                                           sweep_inputs):
    js, ts = small["js"], small["ts"]
    si = sweep_inputs
    pid = np.asarray(js.views.pose_id)
    Rs, Cs = np.asarray(js.poses.R), np.asarray(js.poses.C)
    v = si["v"]
    args = (si["K"], Rs[pid[v]], Cs[pid[v]],
            np.stack([jdrv._K_for(js, s, 0) for s in si["srcs_ids"]]),
            Rs[pid[si["srcs_ids"]]], Cs[pid[si["srcs_ids"]]], si["depths"])
    np.testing.assert_array_equal(tps.plane_homographies(*args),
                                  jps.plane_homographies(*args))
    np.testing.assert_array_equal(tps.inverse_depth_planes(2.0, 30.0, 16),
                                  jps.inverse_depth_planes(2.0, 30.0, 16))
    for k in (2, 3, 6):
        assert tdrv.select_sources(ts, k) == jdrv.select_sources(js, k)
    for v in range(5):
        assert tdrv.depth_range(ts, v) == jdrv.depth_range(js, v)
        np.testing.assert_array_equal(tdrv._K_for(ts, v, 1),
                                      jdrv._K_for(js, v, 1))


def _reference_plane_costs(si):
    """The reference's aggregated cost of each plane alone, (D, H, W): its
    sweep over two copies of one plane returns 1 - that plane's cost."""
    costs = []
    for d in range(len(si["idepths"])):
        _, ncc = jps.sweep(jnp.asarray(si["ref"]), jnp.asarray(si["srcs"]),
                           jnp.asarray(si["live"]),
                           jnp.asarray(si["homos"][:, [d, d]]),
                           jnp.asarray(si["idepths"][[d, d]]),
                           wsize=7, top_k=3, chunk=2)
        costs.append(1.0 - np.asarray(ncc))
    return np.stack(costs)


@pytest.mark.parametrize("top_k,chunk", [(3, 8), (2, 16)])
def test_sweep_matches_reference(sweep_inputs, top_k, chunk):
    si = sweep_inputs
    want_id, want_ncc = jps.sweep(
        jnp.asarray(si["ref"]), jnp.asarray(si["srcs"]),
        jnp.asarray(si["live"]), jnp.asarray(si["homos"]),
        jnp.asarray(si["idepths"]), wsize=7, top_k=top_k, chunk=chunk)
    want_id, want_ncc = np.asarray(want_id), np.asarray(want_ncc)
    got_id, got_ncc = tps.sweep(T(si["ref"]), T(si["srcs"]),
                                T(si["live"], torch.bool), T(si["homos"]),
                                T(si["idepths"]), wsize=7, top_k=top_k,
                                chunk=chunk)
    got_id, got_ncc = got_id.numpy(), got_ncc.numpy()
    assert np.isfinite(got_id).all() and np.isfinite(got_ncc).all()
    assert (np.abs(got_ncc - want_ncc) <= 1e-4).mean() >= 0.99
    v_want, v_got = want_ncc >= 0.7, got_ncc >= 0.7
    assert (v_want == v_got).mean() >= 0.995
    assert v_want.mean() > 0.1
    both = v_want & v_got
    if top_k == 3:
        costs = np.sort(_reference_plane_costs(si), axis=0)
        flip = costs[1] - costs[0] < 1e-5
    else:
        flip = np.zeros_like(both)
    rel = np.abs(got_id - want_id) / np.abs(want_id)
    assert flip[both].mean() <= 0.01
    assert (rel[both & ~flip] <= 1e-4).all(), rel[both & ~flip].max()


def test_sweep_rejects_a_chunk_that_does_not_divide(sweep_inputs):
    si = sweep_inputs
    with pytest.raises(ValueError, match="divisible"):
        tps.sweep(T(si["ref"]), T(si["srcs"]), T(si["live"], torch.bool),
                  T(si["homos"]), T(si["idepths"]), chunk=5)


@pytest.fixture(scope="module")
def dense():
    """Both packages' ``densify_scene`` on the reference test's scene and
    settings (5 views at 192 px, 64 planes, level 0, 4 sources)."""
    rng = np.random.default_rng(0)
    sc = render_scene(rng, n_cams=5, hw=192, f=248.0)
    js = _scene_from_render(sc, n_lm=200)
    images = [(np.clip(im, 0, 1) * 255).astype(np.uint8)
              for im in sc["images"]]
    kw = dict(level=0, num_planes=64, wsize=7, threshold=0.6,
              num_sources=4, csize=2, min_image_num=3)
    return dict(js=js, ref=jdrv.densify_scene(js, images, **kw),
                port=tdrv.densify_scene(port_scene(js), images,
                                        device="cpu", **kw))


def test_consistency_mask_and_normals_match_reference(dense):
    """On the reference's depth maps of the densify scene."""
    js, dmaps = dense["js"], dense["ref"][3]
    pid = np.asarray(js.views.pose_id)
    Rs, Cs = np.asarray(js.poses.R), np.asarray(js.poses.C)
    for v, dm in dmaps.items():
        srcs = dm.sources
        live = np.ones(len(srcs), bool)
        ref_args = [dm.idepth, dm.valid, dm.K.astype(np.float32),
                    Rs[pid[v]], Cs[pid[v]],
                    np.stack([dmaps[s].idepth for s in srcs]),
                    np.stack([dmaps[s].valid for s in srcs]),
                    np.stack([dmaps[s].K for s in srcs]).astype(np.float32),
                    Rs[pid[srcs]], Cs[pid[srcs]], live]
        kinds = [torch.bool if a.dtype == bool else torch.float32
                 for a in ref_args]
        acc_w, X_w = jfus.consistency_mask(*map(jnp.asarray, ref_args),
                                           tol=0.01, min_consistent=2)
        acc_g, X_g = tfus.consistency_mask(
            *(T(a, k) for a, k in zip(ref_args, kinds)), tol=0.01,
            min_consistent=2)
        acc_w, acc_g = np.asarray(acc_w), acc_g.numpy()
        assert (acc_w == acc_g).mean() >= 0.995
        assert acc_w.mean() > 0.05
        np.testing.assert_allclose(X_g.numpy(), np.asarray(X_w), rtol=1e-5,
                                   atol=1e-5)
        n_w = np.asarray(jfus.smoothed_normals(*map(jnp.asarray,
                                                    ref_args[:5])))
        n_g = tfus.smoothed_normals(*(T(a, k) for a, k in
                                      zip(ref_args[:5], kinds))).numpy()
        np.testing.assert_allclose(n_g[dm.valid], n_w[dm.valid], atol=1e-4)


def test_fusion_rejects_inconsistent_depth():
    """The reference's construction (``tests/test_mvs.py``): a depth map
    that disagrees with its source is filtered out, an agreeing one
    passes."""
    K = T([[80.0, 0, 32.0], [0, 80.0, 32.0], [0, 0, 1.0]])
    eye = torch.eye(3)
    idepth = torch.full((64, 64), 1.0 / 5.0)
    valid = torch.ones((64, 64), dtype=torch.bool)
    for src, C, want in ((torch.full((64, 64), 1.0 / 9.0), [0.2, 0, 0], 0.0),
                         (idepth, [0.0, 0, 0], 0.9)):
        acc, _ = tfus.consistency_mask(
            idepth, valid, K, eye, torch.zeros(3), src[None], valid[None],
            K[None], eye[None], T([C]), torch.ones(1, dtype=torch.bool),
            tol=0.01, min_consistent=1)
        assert (acc.float().mean() > want) if want else not acc.any()


def test_densify_scene_matches_reference(dense):
    """The port's cloud holds the reference's count within 2%, lies within
    1e-3 of the extent of the reference's cloud (symmetric chamfer), and
    meets the reference test's plane gate."""
    xyz_w, nrm_w, rgb_w, dm_w = dense["ref"]
    xyz, nrm, rgb, dm = dense["port"]
    assert set(dm) == set(dm_w) and len(dm) == 5
    assert abs(len(xyz) - len(xyz_w)) <= 0.02 * len(xyz_w)
    extent = float(np.ptp(xyz_w, 0).max())
    assert chamfer(xyz, xyz_w) <= 1e-3 * extent
    assert len(xyz) > 2000 and rgb.shape == xyz.shape
    d = np.minimum(np.abs(xyz[:, 2] - 8.0), np.abs(xyz[:, 2] - 13.0))
    assert (d < 0.25).mean() > 0.9
    assert np.median(nrm[:, 2]) < -0.8
    for v in dm:
        assert dm[v].sources == dm_w[v].sources


@pytest.fixture(scope="module")
def fountain(tmp_path_factory):
    """The fountain stand-in (``ingest/synth.py``) at 256 px: 11 views with
    exact poses, 1200 landmarks on its three quads, each observed where it
    projects into a view; the port's scene and the reference's."""
    import chip_smoke
    from regard3d_tpu_torch.core import cameras
    from regard3d_tpu_torch.tools.dense_normals import FOUNTAIN_QUADS
    from regard3d_tpu_torch.core.sfm_data import save_npz
    from regard3d_tpu_torch.core.types import PINHOLE, Scene
    from regard3d_tpu_torch.ingest import synth
    hw, n = 256, 11
    ds = synth.make_dataset("fountain", n_cams=n, hw=hw, seed=0)
    rng = np.random.default_rng(1)
    X = np.concatenate([o + rng.uniform(0, 1, (400, 1)) * u
                        + rng.uniform(0, 1, (400, 1)) * v
                        for o, u, v in FOUNTAIN_QUADS])
    params = T([ds["f"], hw / 2, hw / 2, 0, 0, 0, 0, 0, 0])
    lms, views, xys = [], [], []
    for v in range(n):
        uv, d = cameras.project(T(ds["Rs"][v], torch.float64),
                                T(ds["Cs"][v], torch.float64),
                                torch.tensor(PINHOLE), params.double(),
                                T(X, torch.float64))
        uv, d = uv.numpy(), d.numpy()
        ok = np.nonzero((d > 0) & (uv >= 0).all(1) & (uv <= hw - 1).all(1))[0]
        lms.append(ok)
        views.append(np.full(len(ok), v))
        xys.append(uv[ok])
    lms, views = np.concatenate(lms), np.concatenate(views)
    s = Scene.empty(n, 1, len(X), len(lms))
    i32 = lambda a: T(a, torch.int32)
    ts = s.replace(
        views=s.views.replace(width=i32([hw] * n), height=i32([hw] * n),
                              mask=torch.ones(n, dtype=torch.bool)),
        intrinsics=s.intrinsics.replace(
            model=i32([PINHOLE]), params=params[None].clone(),
            width=i32([hw]), height=i32([hw]),
            mask=torch.ones(1, dtype=torch.bool)),
        poses=s.poses.replace(R=T(ds["Rs"]), C=T(ds["Cs"]),
                              mask=torch.ones(n, dtype=torch.bool)),
        landmarks=s.landmarks.replace(X=T(X),
                                      mask=torch.ones(len(X),
                                                      dtype=torch.bool)),
        observations=s.observations.replace(
            landmark_id=i32(lms), view_id=i32(views),
            xy=T(np.concatenate(xys)),
            mask=torch.ones(len(lms), dtype=torch.bool)))
    path = str(tmp_path_factory.mktemp("fountain") / "scene.npz")
    save_npz(path, ts)
    return dict(ds=ds, ts=ts, js=jsd.load_npz(path), cs=chip_smoke)


def test_densify_fountain_matches_reference(fountain):
    """The fountain stand-in at the CLI's densify defaults (128^2 depth
    maps): both clouds hold the same count within 2% and lie on the quads
    alike (the share within 1% of the extent, and the median |cos| between
    each normal and its quad's, equal within 1e-3), and both meet
    ``chip_smoke.py`` (i)'s cloud gates with the normals at >= 0.98."""
    from regard3d_tpu_torch.tools.dense_normals import DENSE_KW
    cs, ds = fountain["cs"], fountain["ds"]
    xyz_w, nrm_w, _, _ = jdrv.densify_scene(fountain["js"], ds["images"],
                                            **DENSE_KW)
    xyz, nrm, _, _ = tdrv.densify_scene(fountain["ts"], ds["images"],
                                        device="cpu", **DENSE_KW)
    assert abs(len(xyz) - len(xyz_w)) <= 0.02 * len(xyz_w)
    geo_w = cs.dense_geometry(fountain["ts"], ds["Cs"], xyz_w, nrm_w)
    geo = cs.dense_geometry(fountain["ts"], ds["Cs"], xyz, nrm)
    for key in ("cloud_near_frac", "normal_cos_median"):
        assert abs(geo[key] - geo_w[key]) <= 1e-3, (key, geo, geo_w)
    assert len(xyz) > 20_000
    for g in (geo, geo_w):
        assert g["cloud_near_frac"] >= cs.GATE_CLOUD_FRAC
        assert g["normal_cos_median"] >= 0.98


def test_densify_photometric_scale_invariance(small):
    """The reference's regression: [0,1]-float images fuse like uint8
    images."""
    sc, ts = small["sc"], small["ts"]
    f01 = [np.clip(im, 0, 1).astype(np.float32) for im in sc["images"]]
    kw = dict(level=0, num_planes=32, wsize=7, threshold=0.6,
              num_sources=3, min_image_num=2, device="cpu")
    xyz_u8, *_ = tdrv.densify_scene(ts, small["images"], **kw)
    xyz_f, *_ = tdrv.densify_scene(ts, f01, **kw)
    assert len(xyz_f) > 100
    assert abs(len(xyz_f) - len(xyz_u8)) < 0.1 * max(len(xyz_u8), 1)


def _distorted_scene(js):
    """The small scene with a radial-K3 lens, so undistortion moves
    pixels."""
    params = np.asarray(js.intrinsics.params).copy()
    params[0, 3:6] = [-0.12, 0.03, 0.0]
    return js.replace(intrinsics=js.intrinsics.replace(
        params=jnp.asarray(params), model=jnp.asarray([2], jnp.int32)))


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    stack, diffs, n = [cmp], [], 0
    while stack:
        c = stack.pop()
        assert not c.left_only and not c.right_only, (c.left_only,
                                                      c.right_only)
        for name in c.common_files:
            n += 1
            if not filecmp.cmp(os.path.join(c.left, name),
                               os.path.join(c.right, name), shallow=False):
                diffs.append(os.path.join(c.left, name))
        stack += list(c.subdirs.values())
    assert not diffs, diffs
    return n


@pytest.mark.parametrize("distorted", [False, True])
def test_exporters_byte_identical(small, tmp_path, distorted):
    """Every exporter of ``export/formats.py`` writes the reference's bytes
    for the same scene (Bundler, PMVS with undistorted JPEGs, NVM, MeshLab,
    MVE2 with undistorted PNGs, mvs-texturing cams)."""
    js = _distorted_scene(small["js"]) if distorted else small["js"]
    ts = port_scene(js)
    images = small["images"]
    names = [f"img_{i}.png" for i in range(len(images))]
    counts = {}
    for mod, scene, root, kw in ((jfmt, js, tmp_path / "ref", {}),
                                 (tfmt, ts, tmp_path / "port",
                                  {"device": "cpu"})):
        root = str(root)
        mod.export_bundler(os.path.join(root, "bundler"), scene, names)
        mod.export_pmvs(root, scene, images, **kw)
        mod.export_nvm(os.path.join(root, "scene.nvm"), scene, names)
        mod.export_meshlab(os.path.join(root, "meshlab"), scene, names)
        mod.export_mve2(root, scene, images, names, **kw)
        counts[root] = mod.export_mvs_texturing(os.path.join(root, "tex"),
                                                scene, names)
    n = len(images)
    assert list(counts.values()) == [n, n]
    # bundler 2, PMVS 2n + 1, NVM 1, MeshLab 1, MVE2 2n + 1, cams n
    assert _same_tree(str(tmp_path / "ref"), str(tmp_path / "port")) \
        == 5 * n + 6
    und_w = jfmt.undistort_image(images[1], js, 1)
    und_g = tfmt.undistort_image(images[1], ts, 1, device="cpu")
    np.testing.assert_array_equal(und_g, und_w)
    assert (und_w != images[1]).any() == distorted
