"""Trajectory/reconstruction quality metrics (numpy, on the host).

Counterpart of ``regard3d_tpu/core/metrics.py``: ATE after similarity
(Sim3/Umeyama) alignment — reconstructions are defined up to a 7-dof gauge —
plus the residual statistics the reference surfaces after every
triangulation (``src/threads/R3DTriangulationThread.cpp:634-679``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Sim3(NamedTuple):
    scale: float
    R: np.ndarray    # (3, 3)
    t: np.ndarray    # (3,)

    def apply(self, X):
        return self.scale * (np.asarray(X) @ self.R.T) + self.t


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> Sim3:
    """Least-squares similarity aligning src -> dst. src/dst: (N, 3)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var = (sc ** 2).sum() / len(src)
        s = float((D * np.diag(S)).sum() / max(var, 1e-18))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return Sim3(s, R, t)


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) after optional
    Sim3 alignment."""
    est = np.asarray(estimated, np.float64)
    gt = np.asarray(ground_truth, np.float64)
    if align:
        est = umeyama(est, gt).apply(est)
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))


def rotation_error_deg(R_est: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """Per-camera rotation error in degrees, after removing the global
    rotation gauge (best-fit alignment of the first camera pair)."""
    R_est = np.asarray(R_est)
    R_gt = np.asarray(R_gt)
    errs = []
    for Re, Rg in zip(R_est, R_gt):
        dR = Re @ Rg.T
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(c)))
    return np.asarray(errs)


def residual_stats(residuals_px: np.ndarray) -> dict:
    r = np.asarray(residuals_px)
    if r.size == 0:
        return {"min": 0.0, "max": 0.0, "mean": 0.0, "median": 0.0}
    return {"min": float(r.min()), "max": float(r.max()),
            "mean": float(r.mean()), "median": float(np.median(r))}
