"""Port parity: the global engine (``sfm/global_sfm.py``) against the JAX
package, on the CPU, on ``tests/test_global_sfm.py``'s inputs.

* Rotation averaging (l2, l1) on exact and on noisy motions with two gross
  outliers, in the gauge R_0 = I that both return: within 0.15 degrees of
  the reference (both solve an f32 eigenproblem; each is 0.07 degrees from
  the truth on exact motions), and as close to the truth as the
  reference's within 0.1 degrees.
* Translation averaging by the direction-only spectral solver (l1,
  l2_chordal, softl1; one corrupted direction for the robust losses):
  centres within 1e-4 of the reference's (unit mean norm, sign fixed by
  cheirality on both sides).
* ``compute_relative_motions`` with the reference's draws (one key per
  (i, j, attempt), ``GlobalReplay``) on the collinear scene: the same edge
  set, the same inlier count on most edges, R_ij within 1e-4 rad on at
  least half the edges and within 1e-2 rad on all (the 5-point solver's
  f32 rounding lets an edge win with another draw, ROADMAP §3). On the
  reference's motions, ``reconcile_edge_scales`` gives the reference's
  scales to 1e-9 and the scaled translation averaging its centres to 1e-6;
  the spectral fallback cannot recover the uneven spacing.
* ``run_global`` end to end at ``test_global_pipeline_full``'s size (8
  cameras, 0.15 px, 512 iterations): the same cameras, centres within 1e-4
  of the scene extent of the reference's after Sim3, ATE and rms within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.core import cameras as jcam
from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.sfm import global_sfm as jg
from regard3d_tpu_torch.sfm import global_sfm as tg
from tests.test_global_sfm import collinear_scene, make_motions_from_gt
from tests.test_incremental import build_inputs, synth_scene
from tests.test_torch_incremental import _draw, _ttable, port_inputs

torch.set_num_threads(min(2, torch.get_num_threads()))


class GlobalReplay:
    """A ``sample_provider`` that hands out the reference's draws of
    ``compute_relative_motions``: pair (i, j)'s attempt a draws from
    fold_in(fold_in(fold_in(key, i), j), a)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, kind, mask, iters, s, ids=None):
        assert kind == "global_e"
        out = []
        for row, (i, j, a) in enumerate(ids):
            k = jax.random.fold_in(jax.random.fold_in(
                jax.random.fold_in(self.key, i), j), a)
            out.append(np.array(_draw(k, jnp.asarray(mask[row]), iters, s)))
        return np.stack(out)


def _port(motions):
    return [tg.RelativeMotion(*m) for m in motions]


def _corrupted(rng):
    """``test_rotation_averaging_l1_resists_outlier``'s motions: 0.01 rad
    of noise and two gross outliers."""
    motions, Rg, _ = make_motions_from_gt(rng, noise_rad=0.01)
    bad = np.asarray(jcam.exp_so3(jnp.asarray([1.5, -0.5, 1.0])))
    motions[3] = motions[3]._replace(R_ij=bad @ motions[3].R_ij)
    motions[11] = motions[11]._replace(R_ij=bad.T @ motions[11].R_ij)
    return motions, Rg


@pytest.mark.parametrize("case", ["l2-exact", "l1-exact", "l2-outliers",
                                  "l1-outliers"])
def test_average_rotations_match_reference(case):
    loss, data = case.split("-")
    rng = np.random.default_rng(0)
    if data == "exact":
        motions, Rg, _ = make_motions_from_gt(rng)
    else:
        motions, Rg = _corrupted(rng)
    Rj = jg.average_rotations(motions, 10, loss)
    Rt = tg.average_rotations(_port(motions), 10, loss, device="cpu")
    assert Rt.dtype == torch.float32 and Rt.shape == (10, 3, 3)
    Rt = Rt.numpy()
    np.testing.assert_allclose(Rt[0], np.eye(3), atol=1e-5)
    assert jmet.rotation_error_deg(Rt, Rj).max() < 0.15
    assert (jmet.rotation_error_deg(Rt, Rg).max()
            < jmet.rotation_error_deg(Rj, Rg).max() + 0.1)


@pytest.mark.parametrize("loss", ["l1", "l2_chordal", "softl1"])
def test_average_translations_spectral_match_reference(loss):
    rng = np.random.default_rng(0)
    motions, Rg, Cg = make_motions_from_gt(rng)
    if loss != "l2_chordal":
        motions[2] = motions[2]._replace(dir_i=np.array([0.0, 0.0, 1.0]))
    Cj = jg.average_translations(motions, Rg, 10, loss)
    Ct = tg.average_translations(_port(motions), Rg, 10, loss,
                                 device="cpu").numpy()
    np.testing.assert_allclose(Ct, Cj, atol=1e-4)
    bound = (0.02 if loss == "l2_chordal" else 0.05) * np.linalg.norm(
        Cg, axis=1).mean()
    assert jmet.ate_rmse(Ct, Cg) < bound


def test_relative_motions_and_scaled_translations_collinear():
    rng = np.random.default_rng(0)
    scene = collinear_scene(rng)
    inputs, table = build_inputs(scene)
    V = len(scene["feats"])
    key = jax.random.PRNGKey(0)
    mj = jg.compute_relative_motions(inputs, table,
                                     jg.GlobalConfig(ransac_iters=256), key,
                                     V)
    ti = port_inputs(inputs)
    mt = tg.compute_relative_motions(ti, _ttable(table),
                                     tg.GlobalConfig(ransac_iters=256),
                                     GlobalReplay(key), V)
    assert [(m.i, m.j) for m in mt] == [(m.i, m.j) for m in mj]
    assert len(mt) >= V - 1
    ang = np.array([np.arccos(np.clip((np.trace(
        a.R_ij.astype(np.float64) @ b.R_ij.T) - 1) / 2, -1, 1))
        for a, b in zip(mj, mt)])
    assert (ang < 1e-4).mean() >= 0.5 and ang.max() < 1e-2, ang
    same_n = np.mean([a.num_inliers == b.num_inliers for a, b in zip(mj, mt)])
    assert same_n >= 0.75

    # downstream of the reference's motions: the same scales and centres
    pm = _port(mj)
    sj = jg.reconcile_edge_scales(mj, inputs)
    st = tg.reconcile_edge_scales(pm, ti)
    np.testing.assert_allclose(st, sj, rtol=1e-9)
    Rg = jg.average_rotations(mj, V, "l2")
    Cj = jg.average_translations(mj, Rg, V, "softl1", inputs=inputs)
    Ct = tg.average_translations(pm, Rg, V, "softl1", inputs=ti,
                                 device="cpu").numpy()
    np.testing.assert_allclose(Ct, Cj, atol=1e-6)
    gt = scene["Cs"] - scene["Cs"].mean(0)
    gt = gt / np.linalg.norm(gt, axis=-1).mean()
    sign = lambda C: C if np.dot(C[-1] - C[0], gt[-1] - gt[0]) >= 0 else -C
    err = np.linalg.norm(sign(Ct) - gt, axis=-1)
    err_sp = np.linalg.norm(sign(tg._average_translations_spectral(
        pm, Rg, V, device="cpu").numpy()) - gt, axis=-1)
    assert err.max() < 0.08 and err.max() < err_sp.max()


def test_run_global_matches_reference():
    rng = np.random.default_rng(0)
    scene = synth_scene(rng, n_cams=8, visibility=0.9, noise_px=0.15)
    inputs, _ = build_inputs(scene)
    cfg = dict(ransac_iters=512, min_pair_inliers=15)
    rj = jg.run_global(inputs, jg.GlobalConfig(**cfg))
    rt = tg.run_global(port_inputs(inputs), tg.GlobalConfig(**cfg),
                       device="cpu",
                       sample_provider=GlobalReplay(jax.random.PRNGKey(0)))
    sj, st = rj.stats, rt.stats
    assert st["num_cameras"] == sj["num_cameras"] == 8
    assert st["num_relative_motions"] == sj["num_relative_motions"]
    np.testing.assert_array_equal(rt.pose_mask, rj.pose_mask)
    Cj, Ct = np.asarray(rj.C), rt.C.numpy()
    extent = np.ptp(scene["Cs"], axis=0).max()
    err = np.linalg.norm(jmet.umeyama(Ct, Cj).apply(Ct) - Cj, axis=1).max()
    assert err <= 1e-4 * extent, err / extent
    ate_j = jmet.ate_rmse(Cj, scene["Cs"])
    ate_t = jmet.ate_rmse(Ct, scene["Cs"])
    assert ate_t < 0.05 and ate_t == pytest.approx(ate_j, rel=0.05)
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=0.05)
    assert abs(st["num_tracks"] - sj["num_tracks"]) <= 0.02 * sj["num_tracks"]
