"""Port parity: the incremental engine (``sfm/incremental.py``) against
the JAX package, on the CPU (the stage end to end:
``tests/test_torch_triangulation_step.py``).

Random draws: the port is handed the reference's own samples. ``Replay``
walks the reference's key chain (``run_incremental``: ``split(key)`` for the
initializer, then ``split(key, 3)`` per E attempt with ``split(k, 16)`` per
block for E and H; ``split(key)`` and ``split(k, 16)`` per resection round)
and draws with its ``_draw_samples`` on each call's mask.

What must agree on ``tests/test_incremental.py``'s ``synth_scene`` (8
cameras, 300 points; pinhole and radial-K3): the initial pair, the posed
cameras, Sim3-aligned centers within 1e-3 of the scene extent, the
triangulated tracks (Jaccard >= 0.99) and the rms residual (within 5%).
The 5-point E solver is f32-rounding-bound in both packages (ROADMAP §3),
so the initializer's winning E draw may differ; everything downstream
runs from its pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core.types import RADIAL_K3
from regard3d_tpu.kernels import ransac as jr
from regard3d_tpu.sfm import incremental as jinc
from regard3d_tpu_torch.core.types import sfm_inputs_from_numpy
from regard3d_tpu_torch.pipeline import triangulation_step as tts
from regard3d_tpu_torch.sfm import incremental as tinc
from tests.test_incremental import build_inputs, synth_scene

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = dict(ransac_iters=512, resection_iters=256)
_draw = jax.jit(jr._draw_samples, static_argnums=(2, 3))


class Replay:
    """A ``sample_provider`` that hands out the reference's draws."""

    def __init__(self, seed=0, group=16):
        self.main, self.init = jax.random.split(jax.random.PRNGKey(seed))
        self.group = 1 << int(np.ceil(np.log2(group)))
        self.k_h = None
        self.calls = []

    def __call__(self, kind, mask, iters, s):
        self.calls.append(kind)
        if kind == "init_e":
            self.init, k_e, self.k_h = jax.random.split(self.init, 3)
            keys = jax.random.split(k_e, 16)
        elif kind == "init_h":
            keys = jax.random.split(self.k_h, 16)
        else:
            self.main, k = jax.random.split(self.main)
            keys = jax.random.split(k, self.group)
        return np.stack([np.asarray(_draw(keys[p], jnp.asarray(mask[p]),
                                          iters, s))
                         for p in range(len(mask))])


def port_inputs(inputs):
    return sfm_inputs_from_numpy(
        *(np.asarray(getattr(inputs, f)) for f in (
            "xy", "track_id", "view_id", "feature_id")),
        inputs.num_tracks, np.asarray(inputs.intr_id),
        np.asarray(inputs.intr), np.asarray(inputs.models),
        inputs.image_sizes)


def compare(rj, rt, extent):
    """The agreement the module docstring states."""
    sj, st = rj.stats, rt.stats
    assert st["init_pair"] == sj["init_pair"], (st["init_pair"],
                                                sj["init_pair"])
    np.testing.assert_array_equal(rt.pose_mask, rj.pose_mask)
    pm = rj.pose_mask
    Cj = np.asarray(rj.C)[pm]
    Ct = rt.C.numpy()[pm]
    aligned = jmet.umeyama(Ct, Cj).apply(Ct)
    err = np.linalg.norm(aligned - Cj, axis=1).max()
    assert err <= 1e-3 * extent, (err, extent)
    a, b = np.asarray(rj.track_ok), rt.track_ok
    jac = (a & b).sum() / max((a | b).sum(), 1)
    assert jac >= 0.99, jac
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=0.05)
    return err / extent, jac


@pytest.mark.parametrize("model", ["pinhole", "radial_k3"])
def test_run_incremental_matches_reference(model):
    rng = np.random.default_rng(0)
    if model == "pinhole":
        scene = synth_scene(rng)
    else:
        scene = synth_scene(rng, model=RADIAL_K3,
                            d=(-0.12, 0.02, 0, 0, 0, 0))
    inputs, _ = build_inputs(scene)
    rj = jinc.run_incremental(inputs, cfg=jinc.IncrementalConfig(**CFG))
    replay = Replay()
    rt = tinc.run_incremental(port_inputs(inputs),
                              cfg=tinc.IncrementalConfig(**CFG),
                              device="cpu", sample_provider=replay)
    assert rt.stats["num_cameras"] == rj.stats["num_cameras"] == 8
    extent = np.ptp(scene["Cs"], axis=0).max()
    compare(rj, rt, extent)
    # the replay walked the reference's chain: E then H per block, then
    # one resection round per group
    assert replay.calls[:2] == ["init_e", "init_h"]
    assert replay.calls.count("resection") == \
        rt.stats["profile"]["resection_rounds"] == \
        rj.stats["profile"]["resection_rounds"]
    assert set(rt.stats["profile"]) == set(rj.stats["profile"])


def test_port_draws_give_a_full_reconstruction():
    """The port's own draws (one generator per call, seeded from (seed,
    call)): every camera posed at the reference's accuracy, the same
    result from the same seed."""
    rng = np.random.default_rng(0)
    scene = synth_scene(rng, n_cams=6)
    inputs, _ = build_inputs(scene)
    cfg = tinc.IncrementalConfig(ransac_iters=256, resection_iters=128,
                                 ba_iterations=10, final_ba_iterations=20)
    runs = [tinc.run_incremental(port_inputs(inputs), cfg=cfg, seed=3,
                                 device="cpu") for _ in range(2)]
    r = runs[0]
    assert r.stats["num_cameras"] == 6
    assert jmet.ate_rmse(r.C.numpy(), scene["Cs"]) < 0.05
    assert torch.equal(runs[0].C, runs[1].C)
    np.testing.assert_array_equal(runs[0].track_ok, runs[1].track_ok)


def test_unported_options_raise():
    rng = np.random.default_rng(0)
    inputs, _ = build_inputs(synth_scene(rng, n_cams=3, n_pts=40))
    ti = port_inputs(inputs)
    for kw in (dict(initial_pair=(0, 1)), dict(center_priors=np.zeros((3, 3))),
               dict(cfg=tinc.IncrementalConfig(initializer="stellar"))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tinc.run_incremental(ti, device="cpu", **kw)
    for kw in (dict(engine="global"), dict(engine="incremental",
                                           initial_pair=(0, 1)),
               dict(dist_ba=True), dict(f64=True), dict(use_gps=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tts.run_triangulation("/nonexistent", "/nonexistent", [],
                                  np.zeros(0), np.zeros((1, 9)),
                                  np.zeros(1), tts.TriangulationParams(**kw),
                                  device="cpu")
