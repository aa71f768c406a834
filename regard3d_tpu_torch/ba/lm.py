"""Bundle adjustment — Levenberg–Marquardt with an implicit Schur complement.

Counterpart of ``regard3d_tpu/ba/lm.py`` (single device):

* The scene is flat arrays: cameras (V, 6 dof), intrinsics (K, 9), points
  (L, 3), observations (O,). Every per-observation residual and Jacobian
  block — A (2x6 camera), B (2x3 point), Ji (2x9 intrinsics) — comes from
  one batched forward-mode evaluation: a ``jvp`` per increment direction,
  ``vmap``-ped over the 18 directions, on the whole observation table (the
  reference's ``vmap(jacfwd)`` over observations). Forward mode matters:
  ``exp_so3``'s guarded branch divides 0 by 0 at zero increment in the
  branch ``where`` discards, and forward mode takes the tangent of the kept
  branch only.
* Normal equations stay block-diagonal: U (V,6,6), V_l (L,3,3), U_i
  (K,9,9) and the gradients are segment sums over the observation table,
  through ``BALayout`` gather tables (``core/segments.py``), so two calls on
  the same input give the same bits on the card.
* The reduced camera system S = U - W V^-1 W^T is solved by Jacobi-
  preconditioned CG with implicit S-products. The reference's relative-
  residual stop (a ``while_loop``) becomes ``cg_iterations`` fixed steps
  whose state a device-side ``done`` flag freezes: the same result without a
  host synchronisation per step. Block inverses use ``inv_ex``.
* On the card, with no shards, a trial is three C calls: the linearisation
  (residuals, Jacobian blocks, IRLS weights and block sums) in one launch
  of ``kernels/ba_linearize.py`` (``csrc/ba_linearize.cu``), the whole
  solve in one launch of ``kernels/schur_pcg.py`` (``csrc/schur_pcg.cu``),
  which leaves the CG loop at the step where this loop freezes, and the
  cost read in one more launch of ``ba_linearize``. CPU tensors and the
  sharded hooks take the plain ``_normal_blocks``, ``_solve_schur`` and
  ``compute_cost`` (``lm_trial``, ``_full_cost``). What is left eager on
  the card is ``_apply_step`` (~34 operations a trial) and the center
  prior; the sharded BA stays eager.
* The LM outer loop runs on the host, with one ``float(cost)`` per trial.

Gauge: ``fixed_pose_mask`` pins chosen cameras. A center prior
(weight * ||C - C_prior||^2) is the reference's motion-prior option.

Sharding hooks (the reference's ``axis_name`` / ``point_axis_name`` psums):
``cam_reduce`` and ``point_reduce`` take a tuple of tensors and a site name
and return their sum over the shards (identity by default, the single-
device run). The camera system (U, U_i, g_c, g_i) is reduced once at the
linearization, the camera part of the right-hand side once, (V,6)+(K,9)
once per CG step; the per-point sums (V_l, g_p, W^T x) go through
``point_reduce``, which is the identity when the points are sharded with
all their rows (``ba/sharded.py``). Sites: ``linearize``, ``rhs``,
``cg_step``, ``back_substitution`` and ``cost``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.core import cameras as cam
from regard3d_tpu_torch.core.segments import (SegmentTable, make_table,
                                              segment_sum)
from regard3d_tpu_torch.kernels import ba_linearize, schur_pcg


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_iterations: int = 30
    cg_iterations: int = 40
    cg_tol: float = 1e-6              # relative preconditioned-residual stop
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    refine_intrinsics: bool = False       # ADJUST_ALL vs NONE parity
    huber_delta_px: float = 0.0           # 0 = plain squared loss
    center_prior_weight: float = 0.0      # GPS prior strength
    ftol: float = 1e-8


class BAState(NamedTuple):
    R: torch.Tensor            # (V, 3, 3)
    C: torch.Tensor            # (V, 3)
    intr: torch.Tensor         # (K, 9) [f, cx, cy, d0..d5]
    X: torch.Tensor            # (L, 3)


class BAObservations(NamedTuple):
    view_id: torch.Tensor      # (O,) int64
    intr_id: torch.Tensor      # (O,) int64
    point_id: torch.Tensor     # (O,) int64
    model: torch.Tensor        # (O,) int64 camera model code
    xy: torch.Tensor           # (O, 2)
    weight: torch.Tensor       # (O,) float — 0 masks the row


NUM_INTR_DOF = 9

# (tensors, site) -> the tensors summed over the shards
Reduce = Callable[[Tuple[torch.Tensor, ...], str], Tuple[torch.Tensor, ...]]


def identity_reduce(tensors, site):
    """The single-device reduction: nothing to sum."""
    return tensors


def _residual(dw, dC, dX, dintr, R0, C0, intr0, model, X0, uv):
    """Residuals (O, 2) at per-observation local increments dw, dC, dX
    (O, 3) and dintr (O, 9) (all zeros at the linearization point)."""
    R = cam.exp_so3(dw) @ R0
    C = C0 + dC
    X = X0 + dX
    params = intr0 + dintr
    proj, _ = cam.project(R, C, model, params, X)
    return proj - uv


# forward-mode AD levels are process-wide in PyTorch: shards that run in
# threads of one process (ba/sharded.py) take turns through the jvp
_JVP_LOCK = threading.Lock()


def _res_and_jac(R0, C0, intr0, model, X0, uv):
    """Residuals (O, 2) and their Jacobians against the 3+3+3+9 increments
    (O, 2, 18), in forward mode: one ``jvp`` per increment direction
    (``vmap`` over the 18 directions). Row o depends only on increment row
    o, so one batched jvp gives every observation's column at once."""
    O = R0.shape[0]
    z = torch.zeros((O, 18), dtype=X0.dtype, device=X0.device)

    def f(inc):
        return _residual(inc[:, 0:3], inc[:, 3:6], inc[:, 6:9], inc[:, 9:],
                         R0, C0, intr0, model, X0, uv)
    basis = torch.eye(18, dtype=X0.dtype, device=X0.device)[:, None, :] \
        .expand(18, O, 18)
    with _JVP_LOCK:
        J = torch.func.vmap(lambda t: torch.func.jvp(f, (z,), (t,))[1])(
            basis)
    return f(z), J.permute(1, 2, 0)


def _gather(state: BAState, obs: BAObservations):
    return (state.R[obs.view_id], state.C[obs.view_id],
            state.intr[obs.intr_id], state.X[obs.point_id])


def compute_residuals(state: BAState, obs: BAObservations):
    """(O, 2) residuals in pixels at the current state."""
    R0, C0, intr0, X0 = _gather(state, obs)
    z3 = torch.zeros((R0.shape[0], 3), dtype=X0.dtype, device=X0.device)
    z9 = torch.zeros((R0.shape[0], NUM_INTR_DOF), dtype=X0.dtype,
                     device=X0.device)
    return _residual(z3, z3, z3, z9, R0, C0, intr0, obs.model, X0, obs.xy)


def compute_cost(state: BAState, obs: BAObservations,
                 opts: BAOptions) -> torch.Tensor:
    r = compute_residuals(state, obs)
    r2 = torch.sum(r * r, -1)
    # rows behind the camera project to non-finite values: a huge-but-finite
    # cost lets LM reject the step instead of the sum becoming NaN
    r2 = torch.where(torch.isfinite(r2), r2, 1e12)
    if opts.huber_delta_px > 0:
        d = opts.huber_delta_px
        rho = torch.where(r2 <= d * d, r2, 2.0 * d * torch.sqrt(r2) - d * d)
    else:
        rho = r2
    return torch.sum(torch.where(obs.weight > 0, rho * obs.weight, 0.0))


def _irls_weights(r2, opts: BAOptions):
    if opts.huber_delta_px <= 0:
        return torch.ones_like(r2)
    d = opts.huber_delta_px
    rnorm = torch.sqrt(torch.clamp_min(r2, 1e-24))
    return torch.where(r2 <= d * d, 1.0, d / rnorm)


def _build_blocks(state: BAState, obs: BAObservations, opts: BAOptions):
    """Per-observation residuals + Jacobian blocks, IRLS-weighted: r (O,2),
    A (O,2,6), B (O,2,3), Ji (O,2,9), w (O,)."""
    R0, C0, intr0, X0 = _gather(state, obs)
    r, J = _res_and_jac(R0, C0, intr0, obs.model, X0, obs.xy)
    A, JX, Jintr = J[..., :6], J[..., 6:9], J[..., 9:]
    # masked rows and degenerate live rows (non-finite projection) must
    # contribute exact zeros: NaN times weight 0 would poison every sum
    live = obs.weight > 0
    r = torch.where(live[:, None] & torch.isfinite(r), r, 0.0)
    A = torch.where(live[:, None, None] & torch.isfinite(A), A, 0.0)
    B = torch.where(live[:, None, None] & torch.isfinite(JX), JX, 0.0)
    Ji = torch.where(live[:, None, None] & torch.isfinite(Jintr), Jintr, 0.0)
    w = obs.weight * _irls_weights(torch.sum(r * r, -1), opts)
    return r, A, B, Ji, w


# ---------------------------------------------------------------------------
# Gather-based reduction layout
# ---------------------------------------------------------------------------

class BALayout(NamedTuple):
    cam: SegmentTable         # rows of each camera
    pt: SegmentTable          # rows of each point
    intr: SegmentTable        # rows of each intrinsic group


def make_layout(obs: BAObservations, num_cams: int, num_points: int,
                num_intrinsics: int, max_pad_factor: float = 4.0
                ) -> BALayout:
    """The reduction tables, built on the host once per observation table
    (they depend only on the index columns). A table whose padding would
    exceed ``max_pad_factor`` times the rows falls back to sorted segments
    (the reference falls back to ``segment_sum``)."""
    dev = obs.view_id.device
    mk = lambda ids, n: make_table(ids.cpu().numpy(), n, dev, max_pad_factor)
    return BALayout(mk(obs.view_id, num_cams), mk(obs.point_id, num_points),
                    mk(obs.intr_id, num_intrinsics))


class _Normal(NamedTuple):
    """Cached block-diagonal pieces for one linearization."""
    A: torch.Tensor        # (O, 2, 6)
    B: torch.Tensor        # (O, 2, 3)
    Ji: torch.Tensor       # (O, 2, 9)
    w: torch.Tensor        # (O,)
    U: torch.Tensor        # (V, 6, 6)
    Vl: torch.Tensor       # (L, 3, 3)
    Ui: torch.Tensor       # (K, 9, 9)
    gc: torch.Tensor       # (V, 6)
    gp: torch.Tensor       # (L, 3)
    gi: torch.Tensor       # (K, 9)


def _outer(wJ, J):
    """sum_k wJ[o,k,i] J[o,k,j] -> (O, i, j)."""
    return wJ.transpose(-1, -2) @ J


def _jt_r(wJ, r):
    """sum_k wJ[o,k,i] r[o,k] -> (O, i)."""
    return (wJ.transpose(-1, -2) @ r[..., None])[..., 0]


def _j_x(J, x):
    """J[o] @ x[o] -> (O, k)."""
    return (J @ x[..., None])[..., 0]


def _normal_blocks(state, obs, opts, layout: BALayout,
                   cam_reduce: Reduce = identity_reduce,
                   point_reduce: Reduce = identity_reduce) -> _Normal:
    r, A, B, Ji, w = _build_blocks(state, obs, opts)
    wA = A * w[:, None, None]
    wB = B * w[:, None, None]
    wJi = Ji * w[:, None, None]
    U = segment_sum(_outer(wA, A), layout.cam)
    Ui = segment_sum(_outer(wJi, Ji), layout.intr)
    gc = segment_sum(_jt_r(wA, r), layout.cam)
    gi = segment_sum(_jt_r(wJi, r), layout.intr)
    U, Ui, gc, gi = cam_reduce((U, Ui, gc, gi), "linearize")
    Vl = segment_sum(_outer(wB, B), layout.pt)
    gp = segment_sum(_jt_r(wB, r), layout.pt)
    Vl, gp = point_reduce((Vl, gp), "linearize")
    return _Normal(A, B, Ji, w, U, Vl, Ui, gc, gp, gi)


def _damped_inv(M, lam, eps=1e-12):
    """(M + lam * diag(M) + eps I)^-1, batched over leading dims."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.inv_ex(M + (lam * d + eps)[..., None] * eye)[0]


def _solve_schur(nb: _Normal, obs: BAObservations, lam, state,
                 opts: BAOptions, fixed_pose_mask, intr_dof_mask,
                 layout: BALayout, cam_reduce: Reduce = identity_reduce,
                 point_reduce: Reduce = identity_reduce):
    """One damped Schur/CG solve. Returns (dc (V,6), dp (L,3), di (K,9))."""
    dtype, dev = nb.U.dtype, nb.U.device
    free_c = (~fixed_pose_mask).to(dtype)[:, None]                 # (V, 1)
    intr_free = intr_dof_mask.to(dtype)                            # (K, 9)

    Vinv = _damped_inv(nb.Vl, lam)                                  # (L,3,3)
    d6 = torch.diagonal(nb.U, dim1=-2, dim2=-1)
    Ud = nb.U + (lam * d6 + 1e-12)[..., None] * torch.eye(6, dtype=dtype,
                                                          device=dev)
    d9 = torch.diagonal(nb.Ui, dim1=-2, dim2=-1)
    Uid = nb.Ui + (lam * d9 + 1.0)[..., None] * torch.eye(9, dtype=dtype,
                                                          device=dev)

    wA = nb.A * nb.w[:, None, None]
    wB = nb.B * nb.w[:, None, None]
    wJi = nb.Ji * nb.w[:, None, None]
    red_c = lambda x: segment_sum(x, layout.cam)
    red_p = lambda x: segment_sum(x, layout.pt)
    red_i = lambda x: segment_sum(x, layout.intr)
    vid, iid, pid = obs.view_id, obs.intr_id, obs.point_id

    def WT_x(xc, xi):
        """W^T [xc; xi] -> per-point 3-vectors."""
        ax = _j_x(nb.A, xc[vid])
        ix = _j_x(nb.Ji, xi[iid])
        return point_reduce((red_p(_jt_r(wB, ax + ix)),),
                            "back_substitution")[0]

    def W_y(yp):
        """W y -> (camera part, intrinsic part)."""
        by = _j_x(nb.B, yp[pid])
        return cam_reduce((red_c(_jt_r(wA, by)), red_i(_jt_r(wJi, by))),
                          "rhs")

    def S_mv(xc, xi):
        """Implicit reduced-system matvec over stacked [cams; intrinsics]:
        camera rows reduce A^T w (ix - by), intrinsic rows Ji^T w (ax - by)."""
        xc = xc * free_c
        xi = xi * intr_free
        ax = _j_x(nb.A, xc[vid])
        ix = _j_x(nb.Ji, xi[iid])
        t = point_reduce((red_p(_jt_r(wB, ax + ix)),), "cg_step")[0]
        y = _j_x(Vinv, t)
        by = _j_x(nb.B, y[pid])
        # the camera and intrinsic parts ship in one reduction: per CG step
        # (V,6)+(K,9), whatever the landmark count
        dc_part, di_part = cam_reduce((red_c(_jt_r(wA, ix - by)),
                                       red_i(_jt_r(wJi, ax - by))), "cg_step")
        uc = _j_x(Ud, xc) + dc_part
        ui = _j_x(Uid, xi) + di_part
        return uc * free_c, ui * intr_free

    # rhs = -g + W V^-1 gp  (for [c; i])
    wc0, wi0 = W_y(_j_x(Vinv, nb.gp))
    rc = (-nb.gc + wc0) * free_c
    ri = (-nb.gi + wi0) * intr_free

    # Jacobi preconditioner from the damped block diagonals
    pc = 1.0 / torch.clamp_min(torch.diagonal(Ud, dim1=-2, dim2=-1), 1e-12)
    pi = 1.0 / torch.clamp_min(torch.diagonal(Uid, dim1=-2, dim2=-1), 1e-12)
    precond = lambda c, i: (c * pc * free_c, i * pi * intr_free)
    dot = lambda a, b, c, d: torch.sum(a * b) + torch.sum(c * d)

    # preconditioned CG with a relative residual stop (Ceres-style eta
    # termination). The stop is a device-side flag that freezes the state:
    # the fixed step count gives the early-stopped result with no host sync
    xc = torch.zeros_like(rc)
    xi = torch.zeros_like(ri)
    zc, zi = precond(rc, ri)
    pc_, pi_ = zc, zi
    rz = dot(rc, zc, ri, zi)
    stop = opts.cg_tol ** 2 * rz
    for _ in range(opts.cg_iterations):
        go = rz > stop
        Sc, Si = S_mv(pc_, pi_)
        alpha = rz / torch.clamp_min(dot(pc_, Sc, pi_, Si), 1e-30)
        xc_n = xc + alpha * pc_
        xi_n = xi + alpha * pi_
        rc_n = rc - alpha * Sc
        ri_n = ri - alpha * Si
        zc, zi = precond(rc_n, ri_n)
        rz_n = dot(rc_n, zc, ri_n, zi)
        beta = rz_n / torch.clamp_min(rz, 1e-30)
        pc_n = zc + beta * pc_
        pi_n = zi + beta * pi_
        xc, xi = torch.where(go, xc_n, xc), torch.where(go, xi_n, xi)
        rc, ri = torch.where(go, rc_n, rc), torch.where(go, ri_n, ri)
        pc_, pi_ = torch.where(go, pc_n, pc_), torch.where(go, pi_n, pi_)
        rz = torch.where(go, rz_n, rz)

    # back-substitute points: dp = V^-1 (-gp - W^T dc)
    dp = _j_x(Vinv, -nb.gp - WT_x(xc, xi))
    return xc, dp, xi


def _pcg_on_card(x: torch.Tensor, cam_reduce: Reduce,
                 point_reduce: Reduce) -> bool:
    """Whether the kernels linearise, solve and read the cost: tensors on
    CUDA and no shards (both hooks ``identity_reduce``). The sharded BA
    sums over the ranks inside the linearisation, every CG step and the
    cost, which no single launch can do."""
    return (x.is_cuda and cam_reduce is identity_reduce
            and point_reduce is identity_reduce)


def _solve_schur_kernel(nb: _Normal, obs: BAObservations, lam,
                        opts: BAOptions, fixed_pose_mask, intr_dof_mask,
                        layout: BALayout, steps=None):
    """``_solve_schur`` (no shards) as one launch of the CUDA kernel;
    ``steps``: an int64 scalar on the card the CG steps run are added
    to."""
    c = lambda t: t.contiguous()
    return schur_pcg.schur_pcg(
        c(nb.A), c(nb.B), c(nb.Ji), c(nb.w), c(nb.U), c(nb.Vl), c(nb.Ui),
        c(nb.gc), c(nb.gp), c(nb.gi), c(obs.view_id), c(obs.intr_id),
        c(obs.point_id), c(fixed_pose_mask), c(intr_dof_mask), layout.cam,
        layout.pt, layout.intr, lam, opts.cg_iterations, opts.cg_tol, steps)


def _normal_blocks_kernel(state: BAState, obs: BAObservations,
                          opts: BAOptions, layout: BALayout) -> _Normal:
    """``_normal_blocks`` (no shards) as one launch of the CUDA kernel."""
    c = lambda t: t.contiguous()
    out = ba_linearize.linearize(*map(c, state), *map(c, obs), *layout,
                                 opts.huber_delta_px)
    return _Normal(*out[1:])


def _apply_step(state: BAState, dc, dp, di) -> BAState:
    R = cam.exp_so3(dc[:, :3]) @ state.R
    C = state.C + dc[:, 3:]
    return BAState(R, C, state.intr + di, state.X + dp)


def _intr_dof_mask(models, refine: bool, dtype=None):
    """(K, 9) mask of refined intrinsic dofs: focal, principal point, and
    the model's distortion parameters."""
    K = models.shape[0]
    if not refine:
        return torch.zeros((K, 9), dtype=torch.bool, device=models.device)
    nd = torch.tensor([0, 1, 3, 5, 4], device=models.device)[
        torch.clamp(models, 0, 4)]
    cols = torch.arange(9, device=models.device)[None, :]
    return (cols < 3) | ((cols >= 3) & (cols < 3 + nd[:, None]))


def lm_trial(state, lam, obs, opts, fixed_pose_mask, intr_mask,
             center_prior=None, layout: Optional[BALayout] = None,
             cam_reduce: Reduce = identity_reduce,
             point_reduce: Reduce = identity_reduce, pcg_steps=None):
    """One damped LM trial step (linearize + Schur/CG solve + apply).
    With shards, ``obs`` is this shard's rows and the hooks sum over the
    shards (module docstring). On the card with no shards the linearisation
    and the solve are the kernels' (counters ``ba_kernel`` and
    ``pcg_kernel`` of the open span; ``pcg_steps``, an int64 scalar on the
    card or None, gathers the CG steps); otherwise ``_normal_blocks`` and
    ``_solve_schur``."""
    if layout is None:
        layout = make_layout(obs, state.R.shape[0], state.X.shape[0],
                             state.intr.shape[0])
    kernel = _pcg_on_card(state.X, cam_reduce, point_reduce)
    if kernel:
        nb = _normal_blocks_kernel(state, obs, opts, layout)
        spans.count("ba_kernel")
    else:
        nb = _normal_blocks(state, obs, opts, layout, cam_reduce,
                            point_reduce)
    if center_prior is not None and opts.center_prior_weight > 0:
        w = opts.center_prior_weight
        eye_c = torch.zeros((6, 6), dtype=state.X.dtype,
                            device=state.X.device)
        eye_c[3:, 3:] = torch.eye(3, dtype=state.X.dtype,
                                  device=state.X.device)
        gc = nb.gc.clone()
        gc[:, 3:] += w * (state.C - center_prior)
        nb = nb._replace(U=nb.U + w * eye_c[None], gc=gc)
    if kernel:
        dc, dp, di = _solve_schur_kernel(nb, obs, lam, opts, fixed_pose_mask,
                                         intr_mask, layout, pcg_steps)
        spans.count("pcg_kernel")
    else:
        dc, dp, di = _solve_schur(nb, obs, lam, state, opts, fixed_pose_mask,
                                  intr_mask, layout, cam_reduce, point_reduce)
    return _apply_step(state, dc, dp, di)


class BAStats(NamedTuple):
    initial_cost: float
    final_cost: float
    iterations: int
    final_lambda: float


def _full_cost(st: BAState, obs: BAObservations, opts: BAOptions,
               center_prior, reduce: Reduce = identity_reduce):
    """The cost with the center prior, a scalar on the state's device. On
    the card with no shards the data term is the kernel's (counter
    ``cost_kernel`` of the open span); otherwise ``compute_cost``, summed
    over the shards by ``reduce``."""
    if _pcg_on_card(st.X, reduce, reduce):
        c = ba_linearize.cost(*(t.contiguous() for t in st),
                              *(t.contiguous() for t in obs),
                              opts.huber_delta_px)
        spans.count("cost_kernel")
    else:
        c = reduce((compute_cost(st, obs, opts).reshape(1),), "cost")[0][0]
    if center_prior is not None and opts.center_prior_weight > 0:
        c = c + opts.center_prior_weight * torch.sum(
            (st.C - center_prior) ** 2)
    return c


def _to(x, dev):
    return type(x)(*(t.to(dev) for t in x))


def intr_mask_of(obs: BAObservations, num_intrinsics: int,
                 refine: bool) -> torch.Tensor:
    """(K, 9) refined-dof mask, each group's model code recovered from the
    observation table."""
    intr_models = torch.zeros((num_intrinsics,), dtype=obs.model.dtype,
                              device=obs.model.device)
    if obs.model.numel():
        intr_models = intr_models.scatter_reduce(0, obs.intr_id, obs.model,
                                                 "amax", include_self=False)
    return _intr_dof_mask(intr_models, refine)


def lm_loop(state: BAState, obs: BAObservations, opts: BAOptions,
            fixed_pose_mask, intr_mask, center_prior, layout: BALayout,
            cam_reduce: Reduce = identity_reduce,
            point_reduce: Reduce = identity_reduce):
    """The LM outer loop on the host, one cost read per trial. With shards,
    every shard runs it on its own rows; the reduced costs agree, so every
    shard takes the same steps. Returns (state, BAStats).

    Spans, under the caller's: ``.trial`` (linearise, solve and apply as
    enqueued) and ``.cost`` (the cost read, which waits on the device).
    Where the kernels run, the CG steps are gathered on the card and read
    once, after the loop, into the caller's span's counter ``pcg_steps``."""
    kernel = _pcg_on_card(state.X, cam_reduce, point_reduce)
    steps = (torch.zeros((), dtype=torch.int64, device=state.X.device)
             if kernel else None)

    def cost_of(st):
        with spans.span(".cost"):
            return float(_full_cost(st, obs, opts, center_prior,
                                    cam_reduce))

    with torch.no_grad():
        cost = cost_of(state)
        initial = cost
        lam = opts.init_lambda
        it = 0
        for it in range(1, opts.max_iterations + 1):
            with spans.span(".trial"):
                new_state = lm_trial(state, lam, obs, opts, fixed_pose_mask,
                                     intr_mask, center_prior, layout,
                                     cam_reduce, point_reduce, steps)
            new_cost = cost_of(new_state)
            if new_cost == new_cost and abs(new_cost) != float("inf") \
                    and new_cost < cost:
                rel = (cost - new_cost) / max(cost, 1e-30)
                state = new_state
                cost = new_cost
                lam = max(lam * opts.lambda_down, opts.min_lambda)
                if rel < opts.ftol:
                    break
            else:
                lam = lam * opts.lambda_up
                if lam > opts.max_lambda:
                    break
    if kernel:
        spans.count("pcg_steps", int(steps))
    return state, BAStats(initial, cost, it, lam)


def bundle_adjust(state: BAState, obs: BAObservations,
                  opts: BAOptions = BAOptions(),
                  fixed_pose_mask: Optional[torch.Tensor] = None,
                  center_prior: Optional[torch.Tensor] = None,
                  layout: Optional[BALayout] = None,
                  device=None):
    """Run LM to convergence: host outer loop, one cost read per trial.

    Runs on ``device`` (default cuda; raises with no card unless the CPU is
    asked for); inputs are moved there. ``layout``: optional precomputed
    reduction tables (incremental SfM builds them once). Returns (state,
    BAStats)."""
    dev = runtime.resolve_device(device)
    state, obs = _to(state, dev), _to(obs, dev)
    V = state.R.shape[0]
    if fixed_pose_mask is None:
        fixed_pose_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
    fixed_pose_mask = fixed_pose_mask.to(dev)
    if center_prior is not None:
        center_prior = center_prior.to(dev)
    K = state.intr.shape[0]
    intr_mask = intr_mask_of(obs, K, opts.refine_intrinsics)
    if layout is None:
        layout = make_layout(obs, V, state.X.shape[0], K)
    return lm_loop(state, obs, opts, fixed_pose_mask, intr_mask,
                   center_prior, layout)
