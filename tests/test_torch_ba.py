"""Port parity: Levenberg–Marquardt bundle adjustment (``ba/lm.py``) against
the JAX package, on the CPU.

Tolerances: one ``lm_trial`` gives the reference's new state and cost within
rtol 1e-4 (the same normal equations, summed in another order);
``bundle_adjust`` reaches the reference's final cost within 1e-3 relative on
the independent-oracle problem of ``tests/test_ba_oracle.py``; the cases of
``tests/test_ba.py`` (radial-K3 with intrinsic refinement, fixed poses,
masked and degenerate rows, Huber) behave as the reference's. The CG's
fixed step count with a frozen state equals an early stop, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from regard3d_tpu.ba import lm as jlm
from regard3d_tpu.core.types import RADIAL_K3
from regard3d_tpu_torch.ba import lm as tlm
from regard3d_tpu_torch.core.types import (ba_observations_from_numpy,
                                           ba_state_from_numpy)
from tests.test_ba import synth_ba_problem

torch.set_num_threads(min(2, torch.get_num_threads()))


def port(state, obs):
    """The port's BAState / BAObservations from the reference's."""
    return (ba_state_from_numpy(*(np.asarray(a) for a in state)),
            ba_observations_from_numpy(*(np.asarray(a) for a in obs)))


def fixed_first(V, n=1):
    m = np.zeros(V, bool)
    m[:n] = True
    return jnp.asarray(m), torch.as_tensor(m)


def rms(state, obs):
    r = tlm.compute_residuals(state, obs)
    live = obs.weight > 0
    return float(torch.sqrt((r[live] ** 2).sum(-1).mean()))


def test_lm_trial_matches_reference_on_synthetic_ba():
    """``__graft_entry__``'s flagship step: one damped trial (8 CG steps)
    from the perturbed radial-K3 state; then the same with refined
    intrinsics and a center prior."""
    js, jo = graft._synthetic_ba()
    ts, to = port(js, jo)
    V = js.R.shape[0]
    jf, tf = fixed_first(V)
    for refine, prior in ((False, None), (True, 0.5)):
        opts_j = jlm.BAOptions(max_iterations=1, cg_iterations=8,
                               huber_delta_px=2.0,
                               center_prior_weight=prior or 0.0)
        opts_t = tlm.BAOptions(max_iterations=1, cg_iterations=8,
                               huber_delta_px=2.0,
                               center_prior_weight=prior or 0.0)
        models = jnp.asarray([RADIAL_K3])
        jm = jlm._intr_dof_mask(models, refine, jnp.float32)
        tm = tlm._intr_dof_mask(torch.as_tensor([RADIAL_K3]), refine)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        cp = None if prior is None else np.asarray(js.C) + 0.01
        trial = jax.jit(lambda st, ob, fx, im, c, o=opts_j: jlm.lm_trial(
            st, jnp.float32(1e-3), ob, o, fx, im, center_prior=c))
        nj = trial(js, jo, jf, jm, None if cp is None else jnp.asarray(cp))
        nt = tlm.lm_trial(ts, 1e-3, to, opts_t, tf, tm,
                          center_prior=None if cp is None
                          else torch.as_tensor(cp))
        for name, a, b in zip(("R", "C", "intr", "X"), nj, nt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        cj = float(jlm.compute_cost(nj, jo, opts_j))
        ct = float(tlm.compute_cost(nt, to, opts_t))
        assert ct == pytest.approx(cj, rel=1e-4), (refine, ct, cj)
        assert ct < float(tlm.compute_cost(ts, to, opts_t))


def test_residuals_costs_and_blocks_match_reference():
    """Residuals (rtol 1e-5, atol 1e-3 px), the Huber cost, and the
    normal-equation
    blocks U, V_l, U_i and gradients (rtol 1e-4) of one linearization."""
    js, jo = graft._synthetic_ba()
    ts, to = port(js, jo)
    # pixel residuals are differences of ~500 px values: a few f32 ulps
    np.testing.assert_allclose(tlm.compute_residuals(ts, to).numpy(),
                               np.asarray(jlm.compute_residuals(js, jo)),
                               rtol=1e-5, atol=1e-3)
    for d in (0.0, 2.0):
        oj, ot = jlm.BAOptions(huber_delta_px=d), tlm.BAOptions(
            huber_delta_px=d)
        assert float(tlm.compute_cost(ts, to, ot)) == pytest.approx(
            float(jlm.compute_cost(js, jo, oj)), rel=1e-5)
    nj = jlm._normal_blocks(js, jo, jlm.BAOptions(huber_delta_px=2.0))
    layout = tlm.make_layout(to, 4, 64, 1)
    nt = tlm._normal_blocks(ts, to, tlm.BAOptions(huber_delta_px=2.0),
                            layout)
    for f in ("A", "B", "Ji", "w", "U", "Vl", "Ui", "gc", "gp", "gi"):
        a, b = np.asarray(getattr(nj, f)), getattr(nt, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=f)


@pytest.mark.parametrize("skewed", [False, True])
def test_layout_tables_give_the_same_step(skewed):
    """Padded gather tables and sorted segments (the fallback when one
    camera holds most rows) give the same trial step within 1e-4 (the sums
    run in another order and 40 CG steps carry the difference)."""
    rng = np.random.default_rng(0)
    js, _, jo = synth_ba_problem(rng, n_cams=6, n_pts=120)
    ts, to = port(js, jo)
    if skewed:
        vid = to.view_id.clone()
        vid[:600] = 0
        to = to._replace(view_id=vid)
    padded = tlm.make_layout(to, 6, 120, 1, max_pad_factor=1e9)
    fallback = tlm.make_layout(to, 6, 120, 1, max_pad_factor=0.0)
    assert padded.cam.rows is not None and fallback.cam.rows is None
    auto = tlm.make_layout(to, 6, 120, 1, max_pad_factor=2.0)
    assert (auto.cam.rows is None) == skewed
    _, tf = fixed_first(6)
    imask = torch.zeros((1, 9), dtype=torch.bool)
    a = tlm.lm_trial(ts, 1e-3, to, tlm.BAOptions(), tf, imask, layout=padded)
    b = tlm.lm_trial(ts, 1e-3, to, tlm.BAOptions(), tf, imask,
                     layout=fallback)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_bundle_adjust_reaches_reference_cost_on_oracle_problem():
    """``tests/test_ba_oracle.py``'s problem (8 cameras, 250 points, 0.5 px
    noise), 40 iterations: final cost within 1e-3 of the reference's."""
    rng = np.random.default_rng(0)
    js, _, jo = synth_ba_problem(rng, n_cams=8, n_pts=250, noise_px=0.5)
    ts, to = port(js, jo)
    jf, tf = fixed_first(8)
    _, sj = jlm.bundle_adjust(js, jo, jlm.BAOptions(max_iterations=40),
                              fixed_pose_mask=jf)
    out, st = tlm.bundle_adjust(ts, to, tlm.BAOptions(max_iterations=40),
                                fixed_pose_mask=tf, device="cpu")
    assert st.final_cost == pytest.approx(float(sj.final_cost), rel=1e-3)
    assert st.initial_cost == pytest.approx(float(sj.initial_cost), rel=1e-5)
    assert st.final_cost < st.initial_cost * 1e-2


@pytest.mark.parametrize("case", ["refine", "radial", "radial_refine"])
def test_intrinsics_and_radial_k3_like_reference(case):
    """The cases of ``tests/test_ba.py`` with its bounds, and the final cost
    set beside the reference's:

    * ``refine``: pinhole, no noise, focal 2% off, intrinsics refined:
      focal within 0.5%, rms < 0.1 px; cost within 2% of the reference's
      (both end 6 orders below the start, short of convergence);
    * ``radial``: radial-K3 with known distortion, 0.5 px noise: rms < 0.9;
      cost within 5% (25 iterations end short of convergence in both, with
      other damping histories);
    * ``radial_refine``: radial-K3 with the distortion starting at zero and
      the focal 2% off, everything refined (the accuracy run's setting):
      focal within 0.5%, k1 within 0.02, cost down by 6 orders in both and
      within a factor 2 of the reference's (not converged in 40 steps)."""
    rng = np.random.default_rng(1)
    d = (-0.15, 0.03, -0.005, 0, 0, 0)
    if case == "refine":
        js, _, jo = synth_ba_problem(rng, noise_px=0.0)
        js = js._replace(intr=js.intr.at[0, 0].multiply(1.02))
        opts, rel = dict(max_iterations=40, refine_intrinsics=True), 0.02
    elif case == "radial":
        js, _, jo = synth_ba_problem(rng, model=RADIAL_K3, d=d)
        opts, rel = dict(max_iterations=25), 0.05
    else:
        js, _, jo = synth_ba_problem(rng, noise_px=0.0, model=RADIAL_K3, d=d)
        js = js._replace(intr=js.intr.at[0, 0].multiply(1.02)
                         .at[0, 3:6].set(0.0))
        opts, rel = dict(max_iterations=40, refine_intrinsics=True), None
    ts, to = port(js, jo)
    jf, tf = fixed_first(6)
    _, sj = jlm.bundle_adjust(js, jo, jlm.BAOptions(**opts),
                              fixed_pose_mask=jf)
    out, st = tlm.bundle_adjust(ts, to, tlm.BAOptions(**opts),
                                fixed_pose_mask=tf, device="cpu")
    f = float(out.intr[0, 0])
    if case == "radial":
        assert rms(out, to) < 0.9 and f == 900.0
    else:
        assert abs(f - 900.0) / 900.0 < 0.005, f
    if case == "refine":
        assert rms(out, to) < 0.1
    if rel is not None:
        assert st.final_cost == pytest.approx(float(sj.final_cost), rel=rel)
    else:
        assert abs(float(out.intr[0, 3]) - d[0]) < 0.02
        assert st.final_cost < 1e-6 * st.initial_cost
        assert 0.5 < st.final_cost / float(sj.final_cost) < 2.0
    # intrinsics beyond the model's parameters stay untouched
    np.testing.assert_array_equal(out.intr[0, 6:].numpy(),
                                  ts.intr[0, 6:].numpy())


def test_fixed_poses_and_masked_rows_like_reference():
    """Fixed cameras keep their exact pose; rows of weight 0 (poisoned by
    1000 px, or at a camera center: zero depth) change nothing."""
    rng = np.random.default_rng(2)
    js, _, jo = synth_ba_problem(rng, noise_px=0.0)
    xy = np.asarray(jo.xy).copy()
    xy[:50] += 1000.0
    w = np.asarray(jo.weight).copy()
    w[:50] = 0.0
    X = np.asarray(js.X).copy()
    X[0] = np.asarray(js.C)[0]
    w[np.asarray(jo.point_id) == 0] = 0.0
    jo = jo._replace(xy=jnp.asarray(xy), weight=jnp.asarray(w))
    js = js._replace(X=jnp.asarray(X))
    ts, to = port(js, jo)
    jf, tf = fixed_first(6, 2)
    assert np.isfinite(float(tlm.compute_cost(ts, to, tlm.BAOptions())))
    _, sj = jlm.bundle_adjust(js, jo, jlm.BAOptions(max_iterations=20),
                              fixed_pose_mask=jf)
    out, st = tlm.bundle_adjust(ts, to, tlm.BAOptions(max_iterations=20),
                                fixed_pose_mask=tf, device="cpu")
    assert torch.equal(out.R[:2], ts.R[:2]) and torch.equal(out.C[:2],
                                                            ts.C[:2])
    # camera 1 is pinned at its perturbed pose, so the cost stays above 0
    assert np.isfinite(st.final_cost)
    assert st.final_cost == pytest.approx(float(sj.final_cost), rel=1e-3)
    # one camera pinned (the gauge only): the live rows reach 0 px
    _, tf1 = fixed_first(6)
    out1, _ = tlm.bundle_adjust(ts, to, tlm.BAOptions(max_iterations=20),
                                fixed_pose_mask=tf1, device="cpu")
    assert rms(out1, to) < 0.05


def test_huber_and_determinism():
    """Huber with gross outliers: the port's final cost within 1e-3 of the
    reference's; two calls on the same input give the same bits."""
    rng = np.random.default_rng(3)
    js, _, jo = synth_ba_problem(rng, noise_px=0.3)
    xy = np.asarray(jo.xy).copy()
    idx = rng.choice(xy.shape[0], 36, replace=False)
    xy[idx] += rng.uniform(80, 300, size=(36, 2))
    jo = jo._replace(xy=jnp.asarray(xy))
    ts, to = port(js, jo)
    jf, tf = fixed_first(6)
    kw = dict(max_iterations=15, huber_delta_px=2.0)
    _, sj = jlm.bundle_adjust(js, jo, jlm.BAOptions(**kw), fixed_pose_mask=jf)
    runs = [tlm.bundle_adjust(ts, to, tlm.BAOptions(**kw), fixed_pose_mask=tf,
                              device="cpu") for _ in range(2)]
    assert runs[0][1].final_cost == pytest.approx(float(sj.final_cost),
                                                  rel=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1]


def test_frozen_cg_equals_early_stop_and_reference():
    """The CG runs ``cg_iterations`` steps and freezes its state once the
    preconditioned residual has dropped by ``cg_tol``: the result equals,
    bit for bit, the one of exactly as many steps as the stop needs, and
    no step count beyond it changes anything. Against the reference's
    while-loop stop: the same step within rtol 1e-4."""
    rng = np.random.default_rng(4)
    js, _, jo = synth_ba_problem(rng)
    ts, to = port(js, jo)
    jf, tf = fixed_first(6)
    layout = tlm.make_layout(to, 6, 120, 1)
    imask = torch.zeros((1, 9), dtype=torch.bool)
    nb = tlm._normal_blocks(ts, to, tlm.BAOptions(), layout)

    def solve(k, tol=1e-2):
        return tlm._solve_schur(nb, to, 1e-3, ts,
                                tlm.BAOptions(cg_iterations=k, cg_tol=tol),
                                tf, imask, layout)
    full = solve(40)
    same = [all(torch.equal(a, b) for a, b in zip(solve(k), full))
            for k in range(1, 41)]
    n_stop = same.index(True) + 1
    assert 1 < n_stop < 40 and all(same[n_stop - 1:]), same
    assert all(torch.equal(a, b) for a, b in zip(solve(200), full))
    # with tol 0 the stop never triggers: every step changes the state
    assert not all(torch.equal(a, b) for a, b in zip(solve(40, 0.0),
                                                     solve(41, 0.0)))
    # the reference's early-stopped while loop, same tolerance
    ref = jax.jit(lambda st, ob, fx: jlm._solve_schur(
        jlm._normal_blocks(st, ob, jlm.BAOptions()), ob, jnp.float32(1e-3),
        st, jlm.BAOptions(cg_iterations=40, cg_tol=1e-2), fx,
        jnp.zeros((1, 9), bool)))(js, jo, jf)
    for a, b in zip(ref, full):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(a)).max())


def test_bundle_adjust_runs_on_the_card_unless_asked(monkeypatch):
    """No card and no device: bundle_adjust raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    js, jo = graft._synthetic_ba()
    ts, to = port(js, jo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.bundle_adjust(ts, to, tlm.BAOptions(max_iterations=1))
