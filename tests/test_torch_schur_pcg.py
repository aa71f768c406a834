"""Which Schur solve a bundle adjustment runs, on any machine.

``lm_trial`` launches the Schur PCG kernel (``kernels/schur_pcg.py``) only
for CUDA tensors with both reduce hooks ``identity_reduce``; CPU tensors
and the sharded hooks take the plain ``_solve_schur``. The kernel's wrapper
raises on what the kernel cannot take and nothing falls back from it. The
counters ``pcg_kernel`` (a trial the kernel solved, on the ``.trial``
span) and ``pcg_steps`` (its CG steps, read once after the LM loop, on the
caller's span) reach a step's ``stats["spans"]``: shown here with the
launch replaced by the plain solve. Where a test takes CPU tensors for the
card's, the linearisation and cost kernels (``kernels/ba_linearize.py``)
are replaced by their plain versions too (``plain_kernels``). The kernel
itself runs in ``tests/test_torch_schur_pcg_kernel.py``, on the card.

``ba_problem`` builds the BA problems of both files without JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from regard3d_tpu_torch import spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.ba import sharded
from regard3d_tpu_torch.core import cameras as cam
from regard3d_tpu_torch.core.types import PINHOLE, RADIAL_K3
from regard3d_tpu_torch.kernels import _build, ba_linearize, schur_pcg

torch.set_num_threads(min(2, torch.get_num_threads()))

DISTO = (-0.15, 0.03, -0.005, 0.0, 0.0, 0.0)


def ba_problem(seed=0, n_cams=6, n_pts=120, model=RADIAL_K3, groups=1,
               noise_px=0.5, hard=True, dtype=torch.float32, device="cpu"):
    """Cameras on an arc around a point cloud, every point in every view,
    the rows shuffled; the state perturbed from the truth (focal 2% off,
    distortion zeroed). ``hard``: 50 rows poisoned by 1000 px at weight 0,
    point 0 at camera 0's centre with its rows at weight 0 (its V block
    0), and two cameras fixed. ``groups`` intrinsic groups, camera v in
    group v % groups. Returns (state, obs, fixed_pose_mask, center_prior:
    the true centres 0.01 off)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_pts, 3)) * [2, 1.5, 1] + [0, 0, 8]
    a = -0.3 + 0.6 * np.arange(n_cams) / max(n_cams - 1, 1)
    R = cam.exp_so3(torch.tensor(np.stack([0 * a, a, 0 * a], 1)))
    C = np.stack([-8 * np.sin(a), 0.3 * rng.normal(size=n_cams),
                  8 - 8 * np.cos(a)], 1)
    intr = np.zeros((groups, 9))
    intr[:, :3] = [900.0, 640.0, 480.0]
    if model == RADIAL_K3:
        intr[:, 3:] = DISTO
    O = n_cams * n_pts
    perm = rng.permutation(O)
    vid = np.repeat(np.arange(n_cams), n_pts)[perm]
    pid = np.tile(np.arange(n_pts), n_cams)[perm]
    gid = vid % groups
    uv, _ = cam.project(R[vid], torch.tensor(C)[vid],
                        torch.full((O,), model), torch.tensor(intr)[gid],
                        torch.tensor(X)[pid])
    xy = uv.numpy() + rng.normal(size=(O, 2)) * noise_px
    weight = np.ones(O)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    if hard:
        xy[:50] += 1000.0
        weight[:50] = 0.0
        X[0] = C[0]
        weight[pid == 0] = 0.0
        fixed[1] = True
    Rp = cam.exp_so3(torch.tensor(rng.normal(size=(n_cams, 3)) * 0.01)) @ R
    Cp = C + rng.normal(size=C.shape) * 0.05
    Rp[0], Cp[0] = R[0], C[0]
    Xp = X + rng.normal(size=X.shape) * 0.05
    intr_p = intr.copy()
    intr_p[:, 0] *= 1.02
    intr_p[:, 3:] = 0.0
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                  device=device)
    state = lm.BAState(R=f(Rp), C=f(Cp), intr=f(intr_p), X=f(Xp))
    obs = lm.BAObservations(view_id=i(vid), intr_id=i(gid), point_id=i(pid),
                            model=i(np.full(O, model)), xy=f(xy),
                            weight=f(weight))
    return (state, obs, torch.as_tensor(fixed, device=device),
            f(C + 0.01))


def solve_inputs(state, obs, opts, fixed, prior=None, max_pad_factor=4.0):
    """What a trial hands the solve: the linearization's blocks (the
    center prior added as ``lm_trial`` adds it), the layout and the
    intrinsic dof mask."""
    V, L, K = state.R.shape[0], state.X.shape[0], state.intr.shape[0]
    layout = lm.make_layout(obs, V, L, K, max_pad_factor)
    nb = lm._normal_blocks(state, obs, opts, layout)
    if prior is not None and opts.center_prior_weight > 0:
        w = opts.center_prior_weight
        gc = nb.gc.clone()
        gc[:, 3:] += w * (state.C - prior)
        U = nb.U.clone()
        U[:, 3:, 3:] += w * torch.eye(3, dtype=U.dtype, device=U.device)
        nb = nb._replace(U=U, gc=gc)
    return nb, layout, lm.intr_mask_of(obs, K, opts.refine_intrinsics)


def kernel_args(nb, obs, fixed, imask, layout):
    return (nb.A.contiguous(), nb.B.contiguous(), nb.Ji.contiguous(), nb.w,
            nb.U, nb.Vl, nb.Ui, nb.gc, nb.gp, nb.gi, obs.view_id,
            obs.intr_id, obs.point_id, fixed, imask, layout.cam, layout.pt,
            layout.intr)


def plain_launch(A, B, Ji, w, U, Vl, Ui, gc, gp, gi, view_id, intr_id,
                 point_id, fixed_pose_mask, intr_dof_mask, cam_t, pt_t,
                 intr_t, lam, cg_iterations, cg_tol, steps=None):
    """A stand-in for the kernel's launch on the CPU: the plain solve of
    the same inputs; adds 3 to ``steps``."""
    nb = lm._Normal(A, B, Ji, w, U, Vl, Ui, gc, gp, gi)
    obs = lm.BAObservations(view_id, intr_id, point_id, None, None, w)
    out = lm._solve_schur(nb, obs, lam, None, lm.BAOptions(
        cg_iterations=cg_iterations, cg_tol=cg_tol), fixed_pose_mask,
        intr_dof_mask, lm.BALayout(cam_t, pt_t, intr_t))
    if steps is not None:
        steps += 3
    return out


def plain_linearize(R, C, intr, X, view_id, intr_id, point_id, model, xy,
                    weight, cam_t, pt_t, intr_t, huber_delta_px):
    """A stand-in for the linearisation kernel's launch on the CPU: the
    plain linearisation of the same inputs, the residuals first."""
    state = lm.BAState(R, C, intr, X)
    obs = lm.BAObservations(view_id, intr_id, point_id, model, xy, weight)
    opts = lm.BAOptions(huber_delta_px=huber_delta_px)
    return (lm._build_blocks(state, obs, opts)[0],
            *lm._normal_blocks(state, obs, opts,
                               lm.BALayout(cam_t, pt_t, intr_t)))


def plain_cost(R, C, intr, X, view_id, intr_id, point_id, model, xy,
               weight, huber_delta_px):
    """A stand-in for the cost kernel's launch on the CPU."""
    return lm.compute_cost(
        lm.BAState(R, C, intr, X),
        lm.BAObservations(view_id, intr_id, point_id, model, xy, weight),
        lm.BAOptions(huber_delta_px=huber_delta_px))


@pytest.fixture()
def plain_kernels(monkeypatch):
    """The linearisation and cost launches replaced by their plain
    versions, for CPU tensors taken for the card's."""
    monkeypatch.setattr(ba_linearize, "linearize", plain_linearize)
    monkeypatch.setattr(ba_linearize, "cost", plain_cost)


@pytest.fixture()
def small():
    return ba_problem(n_cams=5, n_pts=40)


def test_cpu_tensors_take_the_plain_solve(small):
    """On CPU tensors a trial and a whole bundle adjustment launch nothing
    and count nothing; the trial is the plain solve's."""
    state, obs, fixed, prior = small
    opts = lm.BAOptions(max_iterations=3, refine_intrinsics=True,
                        huber_delta_px=2.0, center_prior_weight=0.5)
    before = dict(_build.LAUNCHES)
    imask = lm.intr_mask_of(obs, 1, True)
    new = lm.lm_trial(state, 1e-3, obs, opts, fixed, imask, prior)
    nb, layout, _ = solve_inputs(state, obs, opts, fixed, prior)
    dc, dp, di = lm._solve_schur(nb, obs, 1e-3, state, opts, fixed, imask,
                                 layout)
    want = lm._apply_step(state, dc, dp, di)
    assert all(torch.equal(a, b) for a, b in zip(new, want))
    with spans.collect() as c, spans.span("triangulation.ba"):
        lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                         center_prior=prior, device="cpu")
    summary = c.summary()
    assert "pcg_steps" not in summary["triangulation.ba"]
    assert "pcg_kernel" not in summary["triangulation.ba.trial"]
    assert _build.LAUNCHES == before


def test_only_unsharded_card_tensors_take_the_kernel():
    """The kernel solves only CUDA tensors with both hooks the identity:
    any other hook (the sharded BA's reductions) keeps the plain solve."""
    card = types.SimpleNamespace(is_cuda=True)
    ident = lm.identity_reduce
    other = sharded.group_reduce(None)
    assert lm._pcg_on_card(card, ident, ident)
    assert not lm._pcg_on_card(card, other, ident)
    assert not lm._pcg_on_card(card, ident, other)
    assert not lm._pcg_on_card(card, other, other)
    assert not lm._pcg_on_card(torch.zeros(1), ident, ident)


def test_sharded_hooks_take_the_plain_solve(small, monkeypatch,
                                           plain_kernels):
    """A trial with non-identity hooks, on tensors taken for the card's,
    never reaches the kernel's launch."""
    state, obs, fixed, _ = small
    monkeypatch.setattr(lm, "_pcg_on_card", lambda x, c, p: (
        c is lm.identity_reduce and p is lm.identity_reduce))

    def refuse(*a, **k):
        raise AssertionError("the kernel ran under sharded hooks")
    monkeypatch.setattr(schur_pcg, "schur_pcg", refuse)
    summed = lambda tensors, site: tensors
    imask = lm.intr_mask_of(obs, 1, False)
    for hooks in ((summed, lm.identity_reduce), (lm.identity_reduce, summed)):
        lm.lm_trial(state, 1e-3, obs, lm.BAOptions(), fixed, imask, None,
                    None, *hooks)
    with pytest.raises(AssertionError, match="sharded"):
        lm.lm_trial(state, 1e-3, obs, lm.BAOptions(), fixed, imask)


def test_kernel_failure_is_not_caught(small, monkeypatch, plain_kernels):
    """A failed launch raises out of the trial: no plain solve instead."""
    state, obs, fixed, _ = small
    monkeypatch.setattr(lm, "_pcg_on_card", lambda x, c, p: True)

    def fail(*a, **k):
        raise RuntimeError("Schur PCG CUDA kernel launch failed")
    monkeypatch.setattr(schur_pcg, "schur_pcg", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        lm.lm_trial(state, 1e-3, obs, lm.BAOptions(), fixed,
                    lm.intr_mask_of(obs, 1, False))


def test_pcg_counters_reach_the_spans(small, monkeypatch, plain_kernels):
    """With the launch replaced by the plain solve (3 steps a call): one
    ``pcg_kernel`` a trial on ``triangulation.ba.trial``, and
    ``pcg_steps`` = 3 x trials once on the caller's ``triangulation.ba``;
    the result is the plain bundle adjustment's."""
    state, obs, fixed, prior = small
    opts = lm.BAOptions(max_iterations=4, huber_delta_px=2.0,
                        center_prior_weight=0.5)
    want, st_want = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                     center_prior=prior, device="cpu")
    monkeypatch.setattr(lm, "_pcg_on_card", lambda x, c, p: (
        c is lm.identity_reduce and p is lm.identity_reduce))
    monkeypatch.setattr(schur_pcg, "schur_pcg", plain_launch)
    with spans.collect() as c, spans.span("triangulation.ba"):
        got, st = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                   center_prior=prior, device="cpu")
    summary = c.summary()
    assert st == st_want and all(torch.equal(a, b)
                                 for a, b in zip(got, want))
    assert summary["triangulation.ba.trial"]["pcg_kernel"] == st.iterations
    assert summary["triangulation.ba"]["pcg_steps"] == 3 * st.iterations
    assert summary["triangulation.ba"]["n"] == 1


@pytest.mark.parametrize("case", ["cpu", "dtype", "index_dtype", "shape",
                                  "layout", "table", "mixed_dtype"])
def test_schur_pcg_refuses_what_it_cannot_take(small, case):
    """The launch raises ValueError on CPU tensors, on blocks neither
    float32 nor float64 or of mixed dtypes, on ids that are not int64, on
    shapes that do not fit together, on non-contiguous tensors and on a
    table of another segment count; it launches nothing."""
    state, obs, fixed, _ = small
    opts = lm.BAOptions(refine_intrinsics=True)
    nb, layout, imask = solve_inputs(state, obs, opts, fixed)
    args = list(kernel_args(nb, obs, fixed, imask, layout))
    if case == "dtype":
        args[:10] = [a.half() for a in args[:10]]
    elif case == "mixed_dtype":
        args[4] = args[4].double()
    elif case == "index_dtype":
        args[10] = args[10].int()
    elif case == "shape":
        args[1] = args[1][:-1]
    elif case == "layout":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "table":
        args[16] = layout.cam          # 5 segments for the 40 points
    want = {"cpu": "CUDA", "dtype": "float32 or float64",
            "mixed_dtype": "want float32", "index_dtype": "int64",
            "shape": "shape", "layout": "contiguous",
            "table": "segments"}[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=want):
        schur_pcg.schur_pcg(*args, 1e-3, 40, 1e-6)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("form", ["padded", "sorted"])
def test_problem_and_plain_stand_in(form):
    """The problems the card tests use are sound on the CPU: the plain
    solve through the launch's argument list equals ``_solve_schur``, and
    a bundle adjustment cuts the cost 20-fold, with sorted tables as with
    padded ones (camera 1 is pinned at its perturbed pose, so the cost
    stays above the noise's)."""
    pad = 1e9 if form == "padded" else 0.0
    state, obs, fixed, prior = ba_problem(model=PINHOLE if form == "sorted"
                                          else RADIAL_K3, groups=2)
    opts = lm.BAOptions(refine_intrinsics=True, huber_delta_px=2.0,
                        center_prior_weight=0.5)
    nb, layout, imask = solve_inputs(state, obs, opts, fixed, prior, pad)
    assert (layout.pt.rows is None) == (form == "sorted")
    got = plain_launch(*kernel_args(nb, obs, fixed, imask, layout), 1e-3,
                       40, 1e-6)
    want = lm._solve_schur(nb, obs, 1e-3, state, opts, fixed, imask, layout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, st = lm.bundle_adjust(state, obs, dataclasses.replace(
        opts, max_iterations=15), fixed_pose_mask=fixed, center_prior=prior,
        layout=layout, device="cpu")
    assert st.final_cost < 0.05 * st.initial_cost
