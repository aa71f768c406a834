"""Global SfM — rotation and translation averaging.

Counterpart of ``regard3d_tpu/sfm/global_sfm.py`` (OpenMVG's
``GlobalSfMReconstructionEngine_RelativeMotions`` with the reference's menus:
rotation averaging L1 | L2, translation averaging L1 | L2-chordal | SoftL1):

  robust E per co-visible pair (blocked AC-RANSAC + cheirality vote)
  -> rotation averaging -> translation averaging -> triangulation
  -> BA rounds that re-test every observation between them.

* rotations: the block matrix G with G[j, i] = w_ij R_ij has the stacked
  rotations as its dominant 3-eigenspace (a spectral relaxation); each 3x3
  block of the eigenvectors is projected back to SO(3), after the sign of
  one eigenvector is fixed by the majority of the blocks' determinants,
  and IRLS reweights pairs by their chordal residual for L1. The result is
  in the gauge R_0 = I, so the eigensolver's basis drops out.
* translations: per-edge baseline scales are reconciled from the depths of
  tracks two edges share (a log least squares on the host), then the
  centres solve one weighted graph Laplacian (float64, as the reference's
  numpy solve), IRLS for L1 / SoftL1. Where the edges do not connect
  through shared tracks, the direction-only spectral solver (the smallest
  eigenvector of the stacked cross-product constraints) is the fallback,
  its sign fixed by majority cheirality.

The dense solves are torch ops on the engine's device (``torch.linalg.eigh``
in place of ``jnp.linalg.eigh``). Random draws go through the incremental
engine's ``sample_provider`` under kind ``"global_e"`` with ``ids`` = one
(i, j, attempt) row per pair, so a pair's draws do not depend on the block
it lands in. Profiler spans: ``triangulation.motions``, ``.averaging``,
``.triangulation``, ``.ba``, ``.outlier``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core import cameras
from regard3d_tpu_torch.kernels import geometry, ransac
from regard3d_tpu_torch.sfm import incremental as inc
from regard3d_tpu_torch.sfm import tracks as tracks_mod
from regard3d_tpu_torch.sfm.triangulate import (reprojection_residuals_px,
                                                track_table,
                                                triangulate_tracks)


@dataclasses.dataclass(frozen=True)
class GlobalConfig:
    rotation_loss: str = "l2"          # "l1" | "l2"
    translation_loss: str = "softl1"   # "l1" | "l2_chordal" | "softl1"
    irls_iterations: int = 8
    min_pair_inliers: int = 30
    max_err_px: float = 4.0
    ransac_iters: int = 1024
    ba_iterations: int = 40
    refine_intrinsics: bool = True
    huber_delta_px: float = 2.0
    min_angle_deg: float = 2.0


class RelativeMotion(NamedTuple):
    i: int
    j: int
    R_ij: np.ndarray      # (3, 3): R_j = R_ij @ R_i
    dir_i: np.ndarray     # (3,): direction of (C_j - C_i) in camera i's frame
    num_inliers: int
    obs_i: np.ndarray     # observation rows in view i (inliers)
    obs_j: np.ndarray


def _edge_tensors(motions, dev, dtype=torch.float32):
    idx_i = torch.as_tensor([m.i for m in motions], device=dev)
    idx_j = torch.as_tensor([m.j for m in motions], device=dev)
    w = torch.as_tensor([float(m.num_inliers) for m in motions],
                        dtype=dtype, device=dev)
    return idx_i, idx_j, w


def _blocks(idx_a, idx_b, blocks, V):
    """(3V, 3V) matrix with block (a_p, b_p) = sum of ``blocks[p]`` (3, 3):
    a one-hot contraction, so repeated indices sum in a fixed order."""
    oa = torch.nn.functional.one_hot(idx_a, V).to(blocks.dtype)
    ob = torch.nn.functional.one_hot(idx_b, V).to(blocks.dtype)
    return torch.einsum("pa,pb,pxy->axby", oa, ob, blocks).reshape(3 * V,
                                                                  3 * V)


def average_rotations(motions: List[RelativeMotion], V: int,
                      loss: str = "l2", irls_iterations: int = 8,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    """Spectral rotation averaging (+ IRLS for l1). Returns (V, 3, 3)
    rotations on ``device`` in the gauge R[0] = I, solved in ``dtype``
    (float64 for the f64 engines: the relative rotations come from the
    float32 minimal solvers and the weights and the eigensolver run in
    float64, as in the reference under x64)."""
    dev = runtime.resolve_device(device)
    idx_i, idx_j, w = _edge_tensors(motions, dev, dtype)
    Rij = torch.as_tensor(np.stack([m.R_ij for m in motions]),
                          dtype=torch.float32, device=dev).to(dtype)
    w = w / w.max()

    def solve(weights):
        # R_j = R_ij R_i  =>  G[j, i] += w R_ij ; G[i, j] += w R_ij^T
        wR = weights[:, None, None] * Rij
        G = (_blocks(idx_j, idx_i, wR, V)
             + _blocks(idx_i, idx_j, wR.transpose(-1, -2), V))
        deg = (torch.nn.functional.one_hot(idx_i, V).to(w.dtype)
               + torch.nn.functional.one_hot(idx_j, V).to(w.dtype)).T \
            @ weights
        G = G + torch.diag(deg.repeat_interleave(3))
        _, evecs = torch.linalg.eigh(G)
        M = evecs[:, -3:].reshape(V, 3, 3)                     # top 3-space
        # blocks are R_i (c Q) for a shared Q with det = +-1; det(Q) < 0
        # would flip blocks inconsistently under the per-block projection,
        # so one eigenvector's sign follows the majority of determinants
        s = torch.sign(torch.sign(torch.linalg.det(M)).sum())
        M = torch.cat([M[:, :, :2], M[:, :, 2:] * torch.where(
            s < 0, -1.0, 1.0)], -1)
        return cameras.project_so3(M)

    def residual_weights(R):
        Rj_pred = Rij @ R[idx_i]
        res = torch.linalg.norm((Rj_pred - R[idx_j]).reshape(-1, 9), dim=-1)
        return w / torch.clamp_min(res, 1e-2)

    R = solve(w)
    if loss == "l1":
        for _ in range(irls_iterations):
            R = solve(residual_weights(R))
    return R @ R[0].T                                    # gauge: R_0 -> I


def _edge_depths(xh: np.ndarray, xv: np.ndarray, R_ij: np.ndarray,
                 Cj: np.ndarray):
    """Two-ray closest-point depths of an edge's inlier tracks in both
    cameras, for a unit baseline. xh/xv: (N, 2) normalized coords in cam i
    / cam j; R_ij, Cj: the pose of j in i's frame. Returns (z_i, z_j)."""
    dh = np.concatenate([xh, np.ones((len(xh), 1))], 1)
    dh /= np.linalg.norm(dh, axis=1, keepdims=True)
    dv = np.concatenate([xv, np.ones((len(xv), 1))], 1) @ R_ij  # R^T d
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    b = np.sum(dh * dv, 1)
    d = dh @ Cj
    e = dv @ Cj
    den = np.maximum(1.0 - b * b, 1e-9)
    t = (d - b * e) / den
    X = t[:, None] * dh
    z_i = X[:, 2]
    z_j = (X - Cj) @ R_ij[2]
    return z_i, z_j


def reconcile_edge_scales(motions: List[RelativeMotion],
                          inputs: inc.SfMInputs) -> Optional[np.ndarray]:
    """Per-edge baseline scales from shared-track depth ratios.

    A unit-baseline triangulation of edge m gives track depths lambda_m =
    d_true / s_m, so two edges that see one track from one view constrain
    log s_a - log s_b = log lambda_b - log lambda_a. A log least squares
    over the edge graph recovers every baseline up to one global scale,
    which keeps translation averaging well posed for collinear centres.
    Returns (M,) scales with geometric mean 1, or None when the edge graph
    does not connect through shared tracks. Host code, as the reference's,
    with its per-track loops as array operations."""
    M = len(motions)
    if M < 2:
        return None
    track_id = inputs.track_id.cpu().numpy()
    xn = inc._normalized_xy(inputs, inputs.intr).cpu().numpy()
    # one row per (motion, view, track) with both depths positive: its log
    # depth in that view
    cols = ([], [], [], [])
    for mi, m in enumerate(motions):
        z_i, z_j = _edge_depths(xn[m.obs_i], xn[m.obs_j], m.R_ij, m.dir_i)
        ok = (z_i > 1e-6) & (z_j > 1e-6)
        tids = track_id[m.obs_i][ok]
        for view, z in ((m.i, z_i[ok]), (m.j, z_j[ok])):
            for c, a in zip(cols, (np.full(len(tids), view), tids,
                                   np.full(len(tids), mi), np.log(z))):
                c.append(a)
    view, tid, mot, logz = (np.concatenate(c) for c in cols)
    # per (view, track), the first motion that sees it against each later
    # one: the pairwise log-ratio observations of that motion pair
    order = np.lexsort((mot, tid, view))
    view, tid, mot, logz = view[order], tid[order], mot[order], logz[order]
    first = np.ones(len(view), bool)
    first[1:] = (view[1:] != view[:-1]) | (tid[1:] != tid[:-1])
    base = np.maximum.accumulate(np.where(first, np.arange(len(view)), 0))
    later = ~first
    if not later.any():
        return None
    key = mot[base][later] * M + mot[later]
    diff = logz[later] - logz[base][later]
    order = np.lexsort((diff, key))
    key, diff = key[order], diff[order]
    pairs, start, count = np.unique(key, return_index=True,
                                    return_counts=True)
    med = 0.5 * (diff[start + (count - 1) // 2] + diff[start + count // 2])
    pa, pb = pairs // M, pairs % M

    parent = list(range(M))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b2 in zip(pa.tolist(), pb.tolist()):
        parent[find(a)] = find(b2)
    if len({find(x) for x in range(M)}) > 1:
        return None

    # minimize sum w (x_a - x_b - r_ab)^2 in the gauge mean(x) = 0, with r
    # the median log ratio of the pair and w its count (at most 20)
    w = np.minimum(count, 20).astype(np.float64)
    L = np.zeros((M, M))
    rhs = np.zeros(M)
    np.add.at(L, (pa, pa), w)
    np.add.at(L, (pb, pb), w)
    np.add.at(L, (pa, pb), -w)
    np.add.at(L, (pb, pa), -w)
    np.add.at(rhs, pa, w * med)
    np.add.at(rhs, pb, -w * med)
    L += np.ones((M, M)) / M          # centroid gauge
    x = np.linalg.solve(L, rhs)
    x -= x.mean()
    return np.exp(x)


def _solve_centers_scaled(idx_i, idx_j, targets, weights, V):
    """min sum w ||(C_j - C_i) - t_m||^2 in the centroid-zero gauge: one
    (V, V) float64 graph-Laplacian solve for the 3 right-hand sides."""
    oi = torch.nn.functional.one_hot(idx_i, V).to(targets.dtype)
    oj = torch.nn.functional.one_hot(idx_j, V).to(targets.dtype)
    d = oj - oi                                                  # (P, V)
    L = d.T @ (weights[:, None] * d) + 1.0 / V
    rhs = d.T @ (weights[:, None] * targets)
    return torch.linalg.solve(L, rhs)


def average_translations(motions: List[RelativeMotion],
                         R_global: torch.Tensor, V: int,
                         loss: str = "softl1", irls_iterations: int = 8,
                         inputs: Optional[inc.SfMInputs] = None,
                         device=None) -> torch.Tensor:
    """Camera centres from the pairwise directions. Returns (V, 3) centres
    (dtype of ``R_global``) on ``device``: centroid 0, mean norm 1.

    With ``inputs`` and an edge graph that connects through shared tracks,
    the edges' baseline scales are reconciled first and the centres come
    from the scaled linear system (collinear-safe); otherwise the
    direction-only spectral solver."""
    dev = runtime.resolve_device(device)
    R_global = torch.as_tensor(R_global, device=dev)
    if inputs is not None:
        scales = reconcile_edge_scales(motions, inputs)
        if scales is not None:
            f64 = torch.float64
            idx_i, idx_j, base_w = _edge_tensors(motions, dev)
            dirs = torch.as_tensor(np.stack([m.dir_i for m in motions]),
                                   dtype=f64, device=dev)
            d_w = torch.einsum("pji,pj->pi", R_global[idx_i].to(f64), dirs)
            d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)
            sc = torch.as_tensor(scales, dtype=f64, device=dev)
            targets = sc[:, None] * d_w
            base_w = base_w.to(f64)
            base_w = torch.sqrt(base_w / base_w.max())
            C = _solve_centers_scaled(idx_i, idx_j, targets, base_w, V)
            if loss in ("l1", "softl1"):
                s = max(float(np.median(scales)) * 0.05, 1e-9)
                for _ in range(irls_iterations):
                    res = torch.linalg.norm((C[idx_j] - C[idx_i]) - targets,
                                            dim=-1)
                    if loss == "softl1":
                        w = base_w / torch.sqrt(torch.sqrt(
                            1.0 + (res / s) ** 2))
                    else:
                        w = base_w / torch.clamp_min(res, 1e-3 * s)
                    C = _solve_centers_scaled(idx_i, idx_j, targets, w, V)
            C = C - C.mean(0)
            C = C / max(float(torch.linalg.norm(C, dim=-1).mean()), 1e-12)
            return C.to(R_global.dtype)
    return _average_translations_spectral(motions, R_global, V, loss,
                                          irls_iterations, device=dev)


def _average_translations_spectral(motions: List[RelativeMotion],
                                   R_global: torch.Tensor, V: int,
                                   loss: str = "softl1",
                                   irls_iterations: int = 8,
                                   device=None) -> torch.Tensor:
    """Direction-only spectral solver (null space of the stacked
    cross-product constraints). Degenerate for collinear centres: the
    fallback when scale reconciliation is unavailable."""
    dev = runtime.resolve_device(device)
    R_global = torch.as_tensor(R_global, device=dev)
    idx_i, idx_j, base_w = _edge_tensors(motions, dev, R_global.dtype)
    dirs = torch.as_tensor(np.stack([m.dir_i for m in motions]),
                           dtype=R_global.dtype, device=dev)
    # world-frame direction of (C_j - C_i): d_w = R_i^T d_i
    d_w = torch.einsum("pji,pj->pi", R_global[idx_i], dirs)
    d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)
    base_w = torch.sqrt(base_w / base_w.max())
    cross = cameras.hat(d_w)                                     # (P, 3, 3)
    ones = torch.eye(3, dtype=d_w.dtype, device=dev).repeat(V, 1) / V

    def solve(weights):
        # rows w [d]_x (C_j - C_i) = 0 -> the normal matrix directly
        Wc = cross * weights[:, None, None]
        CC = torch.einsum("pki,pkj->pij", Wc, Wc)                # (P, 3, 3)
        M = (_blocks(idx_i, idx_i, CC, V) + _blocks(idx_j, idx_j, CC, V)
             - _blocks(idx_i, idx_j, CC, V) - _blocks(idx_j, idx_i, CC, V))
        # remove the translation gauge (constant shifts) by a penalty on
        # the mean
        M = M + (ones @ ones.T) * torch.trace(M) / V
        _, evecs = torch.linalg.eigh(M)
        return evecs[:, 0].reshape(V, 3)

    def residual_weights(C):
        diff = C[idx_j] - C[idx_i]
        res = torch.linalg.norm(torch.einsum("pij,pj->pi", cross, diff),
                                dim=-1)
        scale = torch.linalg.norm(diff, dim=-1).mean()
        if loss == "softl1":
            return base_w / torch.sqrt(torch.sqrt(
                1.0 + (res / (0.01 * scale + 1e-12)) ** 2))
        return base_w / torch.maximum(res, 1e-3 * scale)

    C = solve(base_w)
    if loss in ("l1", "softl1"):
        for _ in range(irls_iterations):
            C = solve(residual_weights(C))
    # sign: most pairs must have dot(C_j - C_i, d_w) > 0
    diff = C[idx_j] - C[idx_i]
    s = torch.sign(torch.sign((diff * d_w).sum(-1)).sum())
    C = C * torch.where(s < 0, -1.0, 1.0)
    C = C - C.mean(0)
    return C / torch.clamp_min(torch.linalg.norm(C, dim=-1).mean(), 1e-12)


# pairs a block of ``compute_relative_motions`` holds: as the geometric
# filter's blocks (pipeline/compute_matches.py), at most 128, and at most
# ~2^26 candidate residuals a chunk of 128 draws
MAX_BLOCK, BLOCK_BUDGET = 128, 1 << 26


def compute_relative_motions(inputs: inc.SfMInputs,
                             table: tracks_mod.TrackTable,
                             cfg: GlobalConfig,
                             draws: inc.SampleProvider,
                             num_views: int, block: Optional[int] = None,
                             attempts: int = 3) -> List[RelativeMotion]:
    """Robust E per co-visible pair -> relative rotation + direction.

    Pairs come from the sparse co-visibility table and are estimated in
    blocks (``block`` pairs, default by the budget above; the reference
    takes 16, and a pair's draws do not depend on its block): one batched
    AC-RANSAC-E call and one batched cheirality-voting decomposition per
    block. A pair whose best E
    decomposes with < 70% cheirality-consistent inliers (a twisted pose
    that would inject an outlier edge into the averaging) is retried with
    fresh draws up to ``attempts`` times, then dropped. ``inputs`` on the
    engine's device; ``draws`` a ``sample_provider`` (kind ``"global_e"``,
    ``ids`` = (i, j, attempt) per row)."""
    pairs, _ = tracks_mod.covisibility_pairs(table, num_views,
                                             min_count=cfg.min_pair_inliers)
    host = inc._host_columns(inputs, inputs.intr)
    xn = inc._normalized_xy(inputs, inputs.intr).cpu().numpy()
    items = []
    for i, j in ((int(a), int(b)) for a, b in pairs):
        oi, oj = inc._pair_obs(host["vid"], host["tid"], i, j)
        if len(oi) >= 16:
            items.append((i, j, oi, oj))
    if not items:
        return []
    cap = max(64, 1 << int(np.ceil(np.log2(max(len(g[2]) for g in items)))))
    if block is None:
        block = max(1, min(MAX_BLOCK, BLOCK_BUDGET // (
            min(cfg.ransac_iters, 128) * cap)))
    intr_np, iid_np = host["intr"], host["iid"]
    sizes = np.asarray(inputs.image_sizes)
    t = lambda a: torch.as_tensor(a, device=inputs.xy.device)

    motions = []
    pending = items
    for attempt in range(attempts):
        retry = []
        for s0 in range(0, len(pending), block):
            grp = pending[s0:s0 + block]
            P = len(grp)
            x1 = np.zeros((P, cap, 2), np.float32)
            x2 = np.zeros((P, cap, 2), np.float32)
            mask = np.zeros((P, cap), bool)
            la_e = np.zeros((P,), np.float32)
            me_e = np.zeros((P,), np.float32)
            for bi, (i, j, oi, oj) in enumerate(grp):
                n = len(oi)
                f = float(intr_np[iid_np[i], 0])
                x1[bi, :n] = xn[oi]
                x2[bi, :n] = xn[oj]
                mask[bi, :n] = True
                w = float(sizes[i][0]) or 2.0 * f
                h = float(sizes[i][1]) or 2.0 * f
                la_e[bi] = np.log10(2.0 * np.hypot(w, h) / (w * h) * f)
                me_e[bi] = (cfg.max_err_px / f) ** 2
            idx = draws("global_e", mask, cfg.ransac_iters, 5,
                        ids=[(g[0], g[1], attempt) for g in grp])
            x1b, x2b, maskb = t(x1), t(x2), t(mask)
            re = ransac.acransac_e_batch(None, x1b, x2b, maskb, t(la_e),
                                         t(me_e), iters=cfg.ransac_iters,
                                         idx=t(idx))
            inl_dev = re.inliers & maskb
            Rb, tb, nval = geometry.decompose_essential(re.model, x1b, x2b,
                                                        mask=inl_dev)
            e_valid = re.valid.cpu().numpy()
            e_num = re.num_inliers.cpu().numpy()
            inl_np = inl_dev.cpu().numpy()
            Rb_np, tb_np = Rb.cpu().numpy(), tb.cpu().numpy()
            frac = nval.cpu().numpy() / np.maximum(e_num, 1)
            for bi, (i, j, oi, oj) in enumerate(grp):
                if not e_valid[bi] or e_num[bi] < cfg.min_pair_inliers:
                    continue
                if frac[bi] < 0.7:
                    retry.append((i, j, oi, oj))
                    continue
                R_ij = Rb_np[bi]
                inl = inl_np[bi][:len(oi)]
                if int(inl.sum()) < cfg.min_pair_inliers:
                    continue
                # C_j in cam i's frame: -R^T t; the direction of C_j - C_i
                Cj_i = -R_ij.T @ tb_np[bi]
                nrm = np.linalg.norm(Cj_i)
                if nrm < 1e-9:
                    continue
                motions.append(RelativeMotion(i, j, R_ij, Cj_i / nrm,
                                              int(inl.sum()), oi[inl],
                                              oj[inl]))
        if not retry:
            break
        pending = retry
    return motions


def run_global(inputs: inc.SfMInputs, cfg: GlobalConfig = GlobalConfig(),
               seed: int = 0, device=None,
               sample_provider: Optional[inc.SampleProvider] = None
               ) -> inc.SfMResult:
    """The global pipeline on ``device`` (default cuda; raises with no card
    unless the CPU is asked for): relative motions -> rotation averaging ->
    translation averaging -> triangulation -> BA rounds. Views outside the
    motion graph stay unposed. ``sample_provider``: as the incremental
    engine's (``sfm/incremental.py``)."""
    dev = runtime.resolve_device(device)
    draws = sample_provider or inc.default_provider(seed)
    inputs = inputs._replace(**{k: getattr(inputs, k).to(dev) for k in (
        "xy", "track_id", "view_id", "feature_id", "intr_id", "intr",
        "models")})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    V = inputs.intr_id.shape[0]
    T = inputs.num_tracks
    dtype = inputs.xy.dtype
    host = inc._host_columns(inputs, inputs.intr)
    tid_np, vid_np = host["tid"], host["vid"]
    table = tracks_mod.TrackTable(tid_np, vid_np,
                                  inputs.feature_id.cpu().numpy(), T)

    with spans.span("triangulation.motions"), torch.no_grad():
        motions = compute_relative_motions(inputs, table, cfg, draws, V)
        sync()
    if not motions:
        raise ValueError("no relative motions could be estimated")
    connected = sorted({m.i for m in motions} | {m.j for m in motions})

    with spans.span("triangulation.averaging"), torch.no_grad():
        R = average_rotations(motions, V, cfg.rotation_loss,
                              cfg.irls_iterations, device=dev, dtype=dtype)
        # translation averaging returns centres of mean norm 1: the
        # absolute scale is a free gauge, kept as is
        C = average_translations(motions, R, V, cfg.translation_loss,
                                 cfg.irls_iterations, inputs=inputs,
                                 device=dev).to(dtype)
        sync()
    pose_mask = np.zeros(V, bool)
    pose_mask[connected] = True
    obs_active = np.ones(inputs.xy.shape[0], bool)
    intr = inputs.intr.to(dtype)
    tid, vid = inputs.track_id, inputs.view_id
    g_obs = inputs.intr_id[vid]
    mean_focal = float(np.mean(host["intr"][:, 0]))
    tri_table = track_table(tid, T)

    def triangulate():
        with spans.span("triangulation.triangulation"), \
                torch.no_grad():
            tri = triangulate_tracks(
                R, C, torch.as_tensor(pose_mask, device=dev), tid, vid,
                torch.as_tensor(obs_active, device=dev),
                inc._bearings(inputs, intr), T, cfg.min_angle_deg,
                cfg.max_err_px, mean_focal, table=tri_table)
            return tri.X, tri.ok.cpu().numpy()

    def residuals_px():
        return reprojection_residuals_px(R, C, intr, inputs.models, g_obs,
                                         vid, tid, X, inputs.xy)

    X, track_ok = triangulate()
    ba_layout = []
    fixed = torch.as_tensor(~pose_mask | (np.arange(V) == connected[0]),
                            device=dev)

    def run_ba(iterations, refine):
        nonlocal R, C, X, intr
        with spans.span("triangulation.ba"):
            w = obs_active & track_ok[tid_np] & pose_mask[vid_np]
            obs_ba = lm.BAObservations(
                view_id=vid, intr_id=g_obs, point_id=tid,
                model=inputs.models[g_obs], xy=inputs.xy,
                weight=torch.as_tensor(w, dtype=dtype, device=dev))
            if not ba_layout:
                ba_layout.append(lm.make_layout(obs_ba, V, T,
                                                int(intr.shape[0])))
            opts = lm.BAOptions(max_iterations=iterations,
                                refine_intrinsics=refine,
                                huber_delta_px=cfg.huber_delta_px)
            out, _ = lm.bundle_adjust(lm.BAState(R=R, C=C, intr=intr, X=X),
                                      obs_ba, opts, fixed_pose_mask=fixed,
                                      layout=ba_layout[0], device=dev)
            R, C, intr, X = out.R, out.C, out.intr, out.X
            sync()

    # BA rounds with the outlier test between them. Rejection is not
    # permanent: each round re-admits observations that fit again (the
    # averaged poses can start far enough from the optimum that a hard
    # first-round rejection starves the cameras at the graph's ends), and
    # the first round tests at twice the threshold.
    run_ba(cfg.ba_iterations, False)
    for round_i in range(3):
        with spans.span("triangulation.outlier"), torch.no_grad():
            r2 = residuals_px().cpu().numpy()
        thr = cfg.max_err_px * (2.0 if round_i == 0 else 1.0)
        obs_active = pose_mask[vid_np] & (r2 <= thr ** 2)
        X, track_ok = triangulate()
        run_ba(cfg.ba_iterations, cfg.refine_intrinsics)

    with torch.no_grad():
        r2 = residuals_px().cpu().numpy()
    live = obs_active & track_ok[tid_np] & pose_mask[vid_np]
    resid = np.sqrt(r2[live]) if live.any() else np.zeros(1)
    stats = {
        "num_cameras": int(pose_mask.sum()),
        "num_tracks": int(track_ok.sum()),
        "num_observations": int(live.sum()),
        "rms_px": float(np.sqrt(r2[live].mean())) if live.any()
        else float("nan"),
        "residual_min": float(resid.min()),
        "residual_max": float(resid.max()),
        "residual_mean": float(resid.mean()),
        "residual_median": float(np.median(resid)),
        "num_relative_motions": len(motions),
    }
    return inc.SfMResult(R, C, pose_mask, X, track_ok, obs_active, intr,
                         stats)
