"""Port parity: cameras, metrics, scene persistence, PLY export and the
deterministic segment sums of ``regard3d_tpu_torch`` against the JAX
package, on the CPU.

Tolerances: camera functions within f32 rtol 1e-5 / atol 1e-6 (the same
formulas; XLA and PyTorch order some f32 sums differently); the host numpy
metrics equal; artifacts byte-identical (``sfm_data.json``, PLY in binary
and ascii) or array-equal (``scene.npz``, read by the other package).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.core import cameras as jc
from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.core import types as jt
from regard3d_tpu.export import ply as jply
from regard3d_tpu_torch.core import cameras as tc
from regard3d_tpu_torch.core import metrics as tmet
from regard3d_tpu_torch.core import segments as tseg
from regard3d_tpu_torch.core import sfm_data as tsd
from regard3d_tpu_torch.core import types as tt
from regard3d_tpu_torch.export import ply as tply

# several pytest workers share the host: a small intra-op pool per worker
torch.set_num_threads(min(2, torch.get_num_threads()))

RTOL, ATOL = 1e-5, 1e-6
MODELS = (tt.PINHOLE, tt.RADIAL_K1, tt.RADIAL_K3, tt.BROWN_T2, tt.FISHEYE)
DISTO = {tt.PINHOLE: [0] * 6, tt.RADIAL_K1: [-0.12, 0, 0, 0, 0, 0],
         tt.RADIAL_K3: [-0.15, 0.03, -0.005, 0, 0, 0],
         tt.BROWN_T2: [-0.1, 0.02, 0.0, 0.001, -0.002, 0],
         tt.FISHEYE: [0.05, -0.01, 0.002, -0.0005, 0, 0]}


def both(fn_j, fn_t, *arrays):
    """fn on numpy inputs in both packages; numpy outputs (tuples kept)."""
    rj = fn_j(*(jnp.asarray(a) for a in arrays))
    rt = fn_t(*(torch.as_tensor(np.array(a)) for a in arrays))
    if isinstance(rj, tuple):
        return [np.asarray(a) for a in rj], [b.numpy() for b in rt]
    return np.asarray(rj), rt.numpy()


def camera_inputs(rng, model, n=200):
    params = np.zeros((n, 9), np.float32)
    params[:, 0] = rng.uniform(600, 1200, n)
    params[:, 1:3] = rng.uniform(300, 700, (n, 2))
    params[:, 3:] = DISTO[model]
    w = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    R = np.asarray(jc.exp_so3(jnp.asarray(w)))
    C = rng.normal(size=(n, 3)).astype(np.float32)
    X = (C + (np.einsum("nji,nj->ni", R, np.c_[rng.uniform(-2, 2, (n, 2)),
                                               rng.uniform(4, 9, n)]))
         ).astype(np.float32)
    uv = params[:, 1:3] + rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    return R, C, np.full((n,), model, np.int32), params, X, uv


@pytest.mark.parametrize("model", MODELS)
def test_camera_models_match_reference(rng, model):
    """project, bearing, add/remove_disto, distort/undistort_pixel of every
    model within f32 rtol 1e-5, atol 1e-6 (pixels: atol 1e-6 relative to
    the pixel scale)."""
    R, C, m, p, X, uv = camera_inputs(rng, model)
    (uj, dj), (ut, dt) = both(jc.project, tc.project, R, C, m, p, X)
    np.testing.assert_allclose(ut, uj, rtol=RTOL, atol=ATOL * 1e3)
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    bj, bt = both(jc.bearing, tc.bearing, m, p, uv)
    np.testing.assert_allclose(bt, bj, rtol=RTOL, atol=ATOL)
    xn = ((uv - p[:, 1:3]) / p[:, :1]).astype(np.float32)
    aj, at = both(jc.add_disto, tc.add_disto, m, p, xn)
    np.testing.assert_allclose(at, aj, rtol=RTOL, atol=ATOL)
    rj, rt = both(jc.remove_disto, tc.remove_disto, m, p, xn)
    np.testing.assert_allclose(rt, rj, rtol=RTOL, atol=ATOL)
    for fj, ft in ((jc.distort_pixel, tc.distort_pixel),
                   (jc.undistort_pixel, tc.undistort_pixel)):
        a, b = both(fj, ft, m, p, uv)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL * 1e3)
    # undistort then distort comes back (the fixed-point inverse converges
    # for the mild radial models)
    if model != tt.FISHEYE:
        mt, pt = torch.as_tensor(m), torch.as_tensor(p)
        back = tc.distort_pixel(mt, pt, tc.undistort_pixel(
            mt, pt, torch.as_tensor(uv)))
        np.testing.assert_allclose(back.numpy(), uv, atol=2e-3)


def test_so3_and_quaternions_match_reference(rng):
    """exp_so3 (incl. the zero and near-pi angles), log_so3, rot_to_quat,
    quat_to_rot, hat and project_so3 within rtol 1e-5, atol 1e-6."""
    w = (rng.normal(size=(300, 3)) * rng.uniform(0, 3.1, (300, 1))) \
        .astype(np.float32)
    w[:3] = 0.0
    w[3] = [1e-7, 0, 0]
    w[4] = [np.pi - 1e-3, 0, 0]
    Rj, Rt = both(jc.exp_so3, tc.exp_so3, w)
    np.testing.assert_allclose(Rt, Rj, rtol=RTOL, atol=ATOL)
    for fj, ft in ((jc.log_so3, tc.log_so3), (jc.rot_to_quat, tc.rot_to_quat)):
        a, b = both(fj, ft, Rj)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-5)
    q = np.asarray(jc.rot_to_quat(jnp.asarray(Rj)))
    a, b = both(jc.quat_to_rot, tc.quat_to_rot, q)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    a, b = both(jc.hat, tc.hat, w)
    np.testing.assert_array_equal(b, a)
    M = (Rj + rng.normal(size=Rj.shape) * 0.01).astype(np.float32)
    a, b = both(jc.project_so3, tc.project_so3, M)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_exp_so3_forward_mode_is_finite_and_float32_at_zero():
    """At zero angle the discarded branch is 0/0: forward mode (jacfwd)
    stays finite, keeps float32 and gives d exp(w)/dw = hat(e_k)."""
    J = torch.func.jacfwd(tc.exp_so3)(torch.zeros(3))
    assert J.dtype == torch.float32 and bool(torch.isfinite(J).all())
    for k in range(3):
        np.testing.assert_allclose(J[..., k].numpy(),
                                   tc.hat(torch.eye(3)[k]).numpy(), atol=1e-7)


def test_metrics_equal_reference(rng):
    A = rng.normal(size=(20, 3))
    R = np.asarray(jc.exp_so3(jnp.asarray([0.2, -0.4, 0.7])), np.float64)
    B = 2.5 * A @ R.T + np.array([1, 2, 3]) + rng.normal(size=A.shape) * 0.01
    sj, st = jmet.umeyama(A, B), tmet.umeyama(A, B)
    assert sj.scale == st.scale
    np.testing.assert_array_equal(st.R, sj.R)
    np.testing.assert_array_equal(st.t, sj.t)
    assert tmet.ate_rmse(A, B) == jmet.ate_rmse(A, B)
    assert tmet.ate_rmse(A, B, align=False) == jmet.ate_rmse(A, B, align=False)
    Re = np.stack([R, R.T])
    np.testing.assert_array_equal(tmet.rotation_error_deg(Re, Re[::-1]),
                                  jmet.rotation_error_deg(Re, Re[::-1]))
    r = rng.uniform(0, 2, 50)
    assert tmet.residual_stats(r) == jmet.residual_stats(r)
    assert tmet.residual_stats([]) == jmet.residual_stats([])


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def reference_scene(rng, V=4, K=2, L=30, O=90):
    """A JAX Scene with every field filled (some rows masked out)."""
    s = jt.Scene.empty(V, K, L, O)
    w = rng.normal(size=(V, 3)) * 0.2
    s = s.replace(
        views=s.views.replace(
            width=jnp.asarray(rng.integers(300, 900, V), jnp.int32),
            height=jnp.asarray(rng.integers(300, 900, V), jnp.int32),
            intrinsic_id=jnp.asarray(rng.integers(0, K, V), jnp.int32),
            mask=jnp.asarray([True] * (V - 1) + [False])),
        intrinsics=s.intrinsics.replace(
            model=jnp.asarray([jt.PINHOLE, jt.RADIAL_K3][:K], jnp.int32),
            params=jnp.asarray(rng.normal(size=(K, 9)), jnp.float32),
            width=jnp.asarray([640, 800][:K], jnp.int32),
            height=jnp.asarray([480, 600][:K], jnp.int32),
            mask=jnp.ones((K,), bool)),
        poses=s.poses.replace(
            R=jc.exp_so3(jnp.asarray(w, jnp.float32)),
            C=jnp.asarray(rng.normal(size=(V, 3)), jnp.float32),
            mask=jnp.asarray([True, False] + [True] * (V - 2))),
        landmarks=s.landmarks.replace(
            X=jnp.asarray(rng.normal(size=(L, 3)), jnp.float32),
            color=jnp.asarray(rng.uniform(size=(L, 3)), jnp.float32),
            mask=jnp.asarray(rng.uniform(size=L) < 0.8)),
        observations=s.observations.replace(
            landmark_id=jnp.asarray(rng.integers(0, L, O), jnp.int32),
            view_id=jnp.asarray(rng.integers(0, V, O), jnp.int32),
            xy=jnp.asarray(rng.uniform(0, 600, (O, 2)), jnp.float32),
            feature_id=jnp.asarray(rng.integers(0, 999, O), jnp.int32),
            mask=jnp.asarray(rng.uniform(size=O) < 0.9)))
    return s


def test_scene_npz_crosses_both_ways(rng, tmp_path):
    """scene.npz written by the port reads back in the reference with equal
    arrays (dtypes included), and the other way round."""
    sj = reference_scene(rng)
    flat = jsd.scene_to_numpy(sj)
    st = tt.scene_from_numpy(flat)
    tsd.save_npz(str(tmp_path / "port.npz"), st)
    jsd.save_npz(str(tmp_path / "ref.npz"), sj)
    back_j = jsd.scene_to_numpy(jsd.load_npz(str(tmp_path / "port.npz")))
    back_t = tsd.scene_to_numpy(tsd.load_npz(str(tmp_path / "ref.npz")))
    assert set(back_j) == set(flat) == set(back_t)
    for k, v in flat.items():
        for got in (back_j[k], back_t[k]):
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    assert st.num_calibrated() == int(sj.num_calibrated())
    assert st.num_landmarks() == int(sj.num_landmarks())


def test_sfm_data_json_byte_identical(rng, tmp_path):
    """The same scene gives the same sfm_data.json bytes (views, intrinsics,
    extrinsics, structure), with and without image names; an empty scene
    gives empty lists in both."""
    sj = reference_scene(rng)
    st = tt.scene_from_numpy(jsd.scene_to_numpy(sj))
    for names in (None, [f"im{i}.jpg" for i in range(4)]):
        jsd.save_json(str(tmp_path / "ref.json"), sj, names, "/data/images")
        tsd.save_json(str(tmp_path / "port.json"), st, names, "/data/images")
        with open(tmp_path / "ref.json", "rb") as a, \
                open(tmp_path / "port.json", "rb") as b:
            assert a.read() == b.read()
    empty_j = jsd.scene_to_json_dict(jt.Scene.empty(2, 1, 0, 0))
    empty_t = tsd.scene_to_json_dict(tt.Scene.empty(2, 1, 0, 0))
    assert json.dumps(empty_j) == json.dumps(empty_t)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_byte_identical(rng, tmp_path, binary):
    """FinalColorized / cloud_and_poses PLYs byte-identical for the same
    points, colors and cameras; each package reads the other's file."""
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    cams = rng.normal(size=(5, 3)).astype(np.float32)
    for name, wj, wt in (
            ("final", lambda p: jply.write_ply(p, jply.PlyData(xyz, rgb),
                                               binary),
             lambda p: tply.write_ply(p, tply.PlyData(xyz, rgb), binary)),
            ("cloud", lambda p: jply.export_cloud_and_poses(p, xyz, rgb, cams,
                                                            binary),
             lambda p: tply.export_cloud_and_poses(p, xyz, rgb, cams,
                                                   binary))):
        pj, pt = str(tmp_path / f"{name}_j.ply"), str(tmp_path / f"{name}_t.ply")
        wj(pj)
        wt(pt)
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read(), name
        got = tply.read_ply(pj)
        ref = jply.read_ply(pt)
        np.testing.assert_array_equal(got.xyz, ref.xyz)
        np.testing.assert_array_equal(got.rgb, ref.rgb)


@pytest.mark.parametrize("skewed", [False, True])
def test_segment_tables_sum_like_index_add(rng, skewed):
    """Both table kinds (padded gather; sorted segments when padding would
    exceed the factor) sum each segment like ``index_add_``, give zeros to
    empty segments, and give the same bits on a second call."""
    O, n = 500, 40
    ids = rng.integers(0, n, O)
    if skewed:
        ids[:300] = 3
    ids[ids == 7] = 8                      # one empty segment
    table = tseg.make_table(ids, n)
    assert (table.rows is None) == skewed
    x = torch.as_tensor(rng.normal(size=(O, 3, 3)).astype(np.float32))
    want = torch.zeros((n, 3, 3)).index_add_(0, torch.as_tensor(ids), x)
    got = tseg.segment_sum(x, table)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert bool((got[7] == 0).all())
    assert torch.equal(got, tseg.segment_sum(x, table))
