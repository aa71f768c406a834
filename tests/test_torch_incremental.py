"""Port parity: the incremental engine (``sfm/incremental.py``) against
the JAX package, on the CPU (the stage end to end:
``tests/test_torch_triangulation_step.py``).

Random draws: the port is handed the reference's own samples. ``Replay``
walks the reference's key chain (``run_incremental``: ``split(key)`` for the
initializer, then ``split(key, 3)`` per E attempt with ``split(k, 16)`` per
block for E and H; with a user's initial pair ``split(key, 3)`` instead, one
``split`` of the first key per attempt and of the second for the last
attempt; ``split(key)`` and ``split(k, 16)`` per resection round) and draws
with its ``_draw_samples`` on each call's mask.

What must agree on ``tests/test_incremental.py``'s ``synth_scene`` (8
cameras, 300 points; pinhole and radial-K3): the initial pair, the posed
cameras, Sim3-aligned centers within 1e-3 of the scene extent, the
triangulated tracks (Jaccard >= 0.99) and the rms residual (within 5%).
The 5-point E solver is f32-rounding-bound in both packages (ROADMAP §3),
so the initializer's winning E draw may differ; everything downstream
runs from its pose. With a user's initial pair (v1) and with GPS center
priors (some rows NaN) the same agreement holds, and the anchored centres
agree within 1e-3 of the extent with no alignment. The stellar
initializer (``tests/test_incremental.py``'s stellar scene, 8 cameras, 400
points) gives the reference's hub and pod, and its run the reference's
posed cameras, within the tolerances each test states.
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
from regard3d_tpu.sfm import tracks as jtracks
from regard3d_tpu_torch.core.types import sfm_inputs_from_numpy
from regard3d_tpu_torch.pipeline import triangulation_step as tts
from regard3d_tpu_torch.sfm import incremental as tinc
from regard3d_tpu_torch.sfm import tracks as ttracks
from tests.test_incremental import build_inputs, synth_scene

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG = dict(ransac_iters=512, resection_iters=256)
_draw = jax.jit(jr._draw_samples, static_argnums=(2, 3))


class Replay:
    """A ``sample_provider`` that hands out the reference's draws.
    ``stellar``: the chain of ``initializer="stellar"``: ``split(key)`` for
    the pod, one ``split`` of the pod's key per hub edge b (in branch
    order), whose key draws the planarity test and is split once per
    relative-pose attempt; MaxPair (if the pod fails) splits its key from
    the main key afterwards."""

    def __init__(self, seed=0, group=16, initial_pair=False, stellar=False):
        key = jax.random.PRNGKey(seed)
        self.init = None
        if initial_pair:
            self.main, self.pair, self.retry = jax.random.split(key, 3)
        elif stellar:
            self.main, self.stellar = jax.random.split(key)
        else:
            self.main, self.init = jax.random.split(key)
        self.group = 1 << int(np.ceil(np.log2(group)))
        self.k_h = None
        self.edge_keys = []
        self.calls = []

    def __call__(self, kind, mask, iters, s, ids=None):
        self.calls.append(kind)
        if kind in ("init_pair", "init_pair_retry"):
            name = "pair" if kind == "init_pair" else "retry"
            key, k = jax.random.split(getattr(self, name))
            setattr(self, name, key)
            return np.array(_draw(k, jnp.asarray(mask[0]), iters, s))[None]
        if kind in ("stellar_h", "stellar_e"):
            out = []
            for row, ident in enumerate(ids):
                while len(self.edge_keys) <= ident[0]:
                    self.stellar, k = jax.random.split(self.stellar)
                    self.edge_keys.append(k)
                key = k = self.edge_keys[ident[0]]
                if kind == "stellar_e":
                    for _ in range(ident[1] + 1):
                        key, k = jax.random.split(key)
                out.append(np.array(_draw(k, jnp.asarray(mask[row]), iters,
                                          s)))
            return np.stack(out)
        if kind == "init_e":
            if self.init is None:
                self.main, self.init = jax.random.split(self.main)
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


@pytest.mark.parametrize("case", ["initial_pair", "center_priors"])
def test_engine_options_match_reference(case):
    """v1 (the user's initial pair, the second-best covisible pair here)
    and GPS anchoring (noisy true centres, two rows NaN) against the
    reference with its draws."""
    rng = np.random.default_rng(1)
    scene = synth_scene(rng)
    inputs, table = build_inputs(scene)
    kw = {}
    if case == "initial_pair":
        cand, _ = jtracks.covisibility_pairs(table, 8, min_count=30)
        kw["initial_pair"] = (int(cand[1][0]), int(cand[1][1]))
    else:
        pri = scene["Cs"] + 0.01 * rng.normal(size=scene["Cs"].shape)
        pri[[2, 5]] = np.nan
        kw["center_priors"] = pri
    rj = jinc.run_incremental(inputs, cfg=jinc.IncrementalConfig(**CFG),
                              **kw)
    replay = Replay(initial_pair=case == "initial_pair")
    rt = tinc.run_incremental(port_inputs(inputs),
                              cfg=tinc.IncrementalConfig(**CFG),
                              device="cpu", sample_provider=replay, **kw)
    assert rt.stats["num_cameras"] == rj.stats["num_cameras"] == 8
    extent = np.ptp(scene["Cs"], axis=0).max()
    compare(rj, rt, extent)
    if case == "initial_pair":
        assert rt.stats["init_pair"] == kw["initial_pair"]
        assert replay.calls[0] == "init_pair"
        assert "init_e" not in replay.calls
    else:
        # anchored in the priors' frame: no alignment needed
        err = np.linalg.norm(rt.C.numpy() - np.asarray(rj.C), axis=1).max()
        assert err <= 1e-3 * extent, err
        assert jmet.ate_rmse(rt.C.numpy(), scene["Cs"], align=False) < 0.05
        # the MaxPair choice alone, from another key
        key = jax.random.PRNGKey(3)
        rp = Replay()
        rp.init = key
        ttable = ttracks.TrackTable(*(np.asarray(a) for a in (
            table.track_id, table.view_id, table.feature_id)),
            table.num_tracks)
        assert tinc.select_initial_pair(
            port_inputs(inputs), ttable, rp, tinc.IncrementalConfig(**CFG),
            8) == jinc.select_initial_pair(
            inputs, table, key, jinc.IncrementalConfig(**CFG), 8)


def _ttable(table):
    return ttracks.TrackTable(*(np.asarray(a) for a in (
        table.track_id, table.view_id, table.feature_id)), table.num_tracks)


def test_stellar_seed_matches_reference():
    """The stellar pod of ``tests/test_incremental.py``'s scene (8 cameras,
    400 points, 0.3 px) with the reference's draws: the same hub and pod
    views, poses within 2e-3 of the scene extent after Sim3 (measured
    1.3e-3: one hub edge's E wins with another draw, the 5-point solver's
    f32 rounding, ROADMAP §3)."""
    rng = np.random.default_rng(0)
    scene = synth_scene(rng, n_cams=8, n_pts=400, noise_px=0.3)
    inputs, table = build_inputs(scene)
    cfg = dict(initializer="stellar")
    xn = np.asarray(jinc._normalized_xy(inputs, inputs.intr))
    hj, pj, _ = jinc._stellar_seed(inputs, table, jax.random.PRNGKey(0),
                                   jinc.IncrementalConfig(**cfg), 8, xn)
    ti = port_inputs(inputs)
    replay = Replay(stellar=True)
    replay.stellar = jax.random.PRNGKey(0)      # the key _stellar_seed gets
    ht, pt, _ = tinc._stellar_seed(
        ti, _ttable(table), replay, tinc.IncrementalConfig(**cfg), 8,
        tinc._normalized_xy(ti, ti.intr).numpy(),
        tinc._host_columns(ti, ti.intr))
    assert ht == hj and sorted(pt) == sorted(pj) and len(pj) >= 3
    views = sorted(pj)
    Cj = np.stack([pj[v][1] for v in views])
    Ct = np.stack([pt[v][1] for v in views])
    extent = np.ptp(scene["Cs"], axis=0).max()
    err = np.linalg.norm(jmet.umeyama(Ct, Cj).apply(Ct) - Cj, axis=1).max()
    assert err <= 2e-3 * extent, err / extent
    rot = max(jmet.rotation_error_deg(pt[v][0][None], pj[v][0][None])[0]
              for v in views)
    assert rot < 0.2, rot
    assert replay.calls[0] == "stellar_h" and "stellar_e" in replay.calls
    assert jmet.ate_rmse(Ct, scene["Cs"][views]) < 0.5


def test_run_incremental_stellar_matches_reference():
    """``initializer="stellar"`` end to end on the same scene with the
    reference's draws: the same hub, pod size and posed cameras, centres
    within 2e-3 of the extent after Sim3, the ATE within 1e-3 of the
    extent of the reference's, rms within 5%."""
    rng = np.random.default_rng(0)
    scene = synth_scene(rng, n_cams=8, n_pts=400, noise_px=0.3)
    inputs, _ = build_inputs(scene)
    cfg = dict(CFG, initializer="stellar")
    rj = jinc.run_incremental(inputs, cfg=jinc.IncrementalConfig(**cfg))
    replay = Replay(stellar=True)
    rt = tinc.run_incremental(port_inputs(inputs),
                              cfg=tinc.IncrementalConfig(**cfg),
                              device="cpu", sample_provider=replay)
    sj, st = rj.stats, rt.stats
    assert st["init_hub"] == sj["init_hub"]
    assert st["stellar_pod_size"] == sj["stellar_pod_size"] >= 3
    assert "init_pair" not in st and "init_pair" not in sj
    np.testing.assert_array_equal(rt.pose_mask, rj.pose_mask)
    assert rt.pose_mask.sum() == 8
    extent = np.ptp(scene["Cs"], axis=0).max()
    Cj, Ct = np.asarray(rj.C), rt.C.numpy()
    err = np.linalg.norm(jmet.umeyama(Ct, Cj).apply(Ct) - Cj, axis=1).max()
    assert err <= 2e-3 * extent, err / extent
    ate_j = jmet.ate_rmse(Cj, scene["Cs"])
    ate_t = jmet.ate_rmse(Ct, scene["Cs"])
    assert ate_t < 0.1 and abs(ate_t - ate_j) <= 1e-3 * extent
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=0.05)
    assert "init_e" not in replay.calls


def test_unported_options_raise(tmp_path):
    """No option of the menu is left unported: the sharded BA polish
    (``dist_ba``, alone and with float64), float64 and stellar with a
    user's initial pair (stellar is ignored there, as in the reference) all
    get past the options to reading the match file, which is missing
    here."""
    for kw in (dict(dist_ba=True), dict(dist_ba=True, f64=True),
               dict(engine="incremental", initial_pair=(0, 1),
                    initializer="stellar", use_gps=True),
               dict(engine="global"), dict(initializer="stellar"),
               dict(f64=True), dict(engine="global", f64=True)):
        with pytest.raises(FileNotFoundError, match="matches"):
            tts.run_triangulation(str(tmp_path / "missing"),
                                  str(tmp_path / "out"), [],
                                  np.zeros(0), np.zeros((1, 9)),
                                  np.zeros(1), tts.TriangulationParams(**kw),
                                  device="cpu")


def test_maxpair_pose_explains_its_inliers(monkeypatch):
    """MaxPair counts the inliers its decomposed pose explains, not those of
    the sweep's matrix: the winning pair's E, swapped for one whose pose is
    3 degrees off (still in front of both cameras, as a float32 5-point
    candidate off the essential manifold decomposes), no longer wins with
    that pose; whatever pair is picked, its pose explains every inlier it
    returns within the bound."""
    from regard3d_tpu_torch.core import cameras
    from regard3d_tpu_torch.kernels import geometry, ransac
    rng = np.random.default_rng(0)
    scene = synth_scene(rng)
    inputs, table = build_inputs(scene)
    inputs = port_inputs(inputs)
    cfg = tinc.IncrementalConfig(**CFG)
    xn = tinc._normalized_xy(inputs, inputs.intr).numpy()
    host = tinc._host_columns(inputs, inputs.intr)
    ttable = _ttable(table)
    pick = lambda: tinc._select_initial_pose(
        inputs, ttable, tinc.default_provider(3), cfg, 8, xn, host)
    with torch.no_grad():
        i0, j0 = pick()[:2]
    sweep = ransac.acransac_e_batch
    # the winning pair's row in a block: its first observation
    first = xn[tinc._pair_obs(host["vid"], host["tid"], i0, j0)[0][0]]

    def twisted(*a, **kw):
        re = sweep(*a, **kw)
        x1, x2 = a[1], a[2]
        rows = [b for b in range(len(x1))
                if np.array_equal(x1[b, 0].numpy(), first)]
        R, t, _ = geometry.decompose_essential(re.model, x1, x2,
                                               mask=re.inliers)
        dR = cameras.exp_so3(torch.tensor([0.0, np.radians(3.0), 0.0]))
        model = re.model.clone()
        for b in rows:
            model[b] = cameras.hat(t[b]) @ dR.to(R.dtype) @ R[b]
        return re._replace(model=model)

    monkeypatch.setattr(ransac, "acransac_e_batch", twisted)
    with torch.no_grad():
        i, j, R, t, oi, oj, inl = pick()
    assert inl.sum() >= cfg.min_initial_inliers
    E = cameras.hat(torch.as_tensor(t)) @ torch.as_tensor(R)
    r = ransac._epi_resid(E[None, None].float(), {
        "x1": torch.as_tensor(xn[oi][inl])[None],
        "x2": torch.as_tensor(xn[oj][inl])[None]})[0, 0]
    f = float(host["intr"][host["iid"][i], 0])
    assert (r <= (cfg.max_err_px / f) ** 2 * (1 + 1e-5)).all()
