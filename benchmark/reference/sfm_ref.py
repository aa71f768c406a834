"""Plain reference of the triangulation step's end state, and the numbers
that judge it.

* Tracks: OpenMVG's semantics (connected components of the match graph
  over (view, feature) nodes; a component with two features of one view,
  or fewer than two nodes, is dropped), by a host union-find.
* Bundle adjustment: Levenberg-Marquardt with a dense Schur complement over
  the posed cameras and the shared pinhole intrinsics (focal, principal
  point), the program's Huber loss (2 px), from the step's own end state.
  The gap between the step's cost and the optimum the reference reaches
  from it says whether the step left its scene at a minimum.
* Camera centres against the scene's exact ones after a similarity
  (Umeyama), the check of the incremental growth the BA starts from.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

HUBER_PX = 2.0


def tracks(matches: Dict[Tuple[int, int], np.ndarray]) -> set:
    """The set of tracks, each a frozenset of (view, feature) nodes."""
    parent: Dict[tuple, tuple] = {}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (i, j), m in matches.items():
        for a, b in np.asarray(m).reshape(-1, 2).tolist():
            u, v = (i, a), (j, b)
            parent.setdefault(u, u)
            parent.setdefault(v, v)
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[max(ru, rv)] = min(ru, rv)
    groups: Dict[tuple, list] = {}
    for node in parent:
        groups.setdefault(find(node), []).append(node)
    out = set()
    for nodes in groups.values():
        views = [v for v, _ in nodes]
        if len(nodes) >= 2 and len(set(views)) == len(views):
            out.add(frozenset(nodes))
    return out


def umeyama_rmse(src: np.ndarray, dst: np.ndarray) -> float:
    """RMSE of ``src`` mapped onto ``dst`` by the best similarity."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    a, b = src - ms, dst - md
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((a ** 2).sum() / len(src), 1e-300)
    res = dst - (s * (R @ src.T).T + (md - s * R @ ms))
    return float(np.sqrt((res ** 2).sum(1).mean()))


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w):
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = _skew(w)
    small = th < 1e-12
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5, (1 - torch.cos(ths)) / (ths * ths))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


class Problem:
    """Observations of live tracks in posed views: ``cam`` (O,) index into
    the refined cameras (-1 for the fixed one), ``pt`` (O,), ``uv`` (O, 2).
    Every posed view but ``fixed_view`` is refined."""

    def __init__(self, R, C, intr, X, view, pt, uv, posed, fixed_view: int):
        self.R, self.C, self.intr, self.X = R, C, intr, X
        self.view, self.pt, self.uv = view, pt, uv
        V = R.shape[0]
        free = [int(v) for v in posed if v != fixed_view]
        col = torch.full((V,), -1, dtype=torch.long, device=R.device)
        col[free] = torch.arange(len(free), device=R.device)
        self.col = col
        self.n_cam = len(free)
        # gauge: the fixed view's pose, and the scale by the coordinate of
        # the farthest view's centre that lies farthest from the fixed one
        self.pin = None
        if free and fixed_view >= 0:
            d = C[free] - C[fixed_view]
            far = int(torch.argmax(torch.linalg.norm(d, dim=-1)))
            axis = int(torch.argmax(d[far].abs()))
            self.pin = 6 * far + 3 + axis

    def project(self, R, C, intr, X):
        xc = (R[self.view] @ (X[self.pt] - C[self.view])[..., None])[..., 0]
        z = xc[:, 2:3]
        return intr[0] * xc[:, :2] / z + intr[1:3], xc

    def cost(self, R=None, C=None, intr=None, X=None) -> torch.Tensor:
        R = self.R if R is None else R
        C = self.C if C is None else C
        intr = self.intr if intr is None else intr
        X = self.X if X is None else X
        uvp, _ = self.project(R, C, intr, X)
        r2 = ((uvp - self.uv) ** 2).sum(-1)
        d = HUBER_PX
        return torch.where(r2 <= d * d, r2,
                           2 * d * torch.sqrt(r2) - d * d).sum()

    def step(self, lam: float):
        """One damped Gauss-Newton step; returns the trial state."""
        R, C, intr, X = self.R, self.C, self.intr, self.X
        uvp, xc = self.project(R, C, intr, X)
        r = uvp - self.uv                                   # (O, 2)
        n2 = (r * r).sum(-1)
        w = torch.where(n2 <= HUBER_PX ** 2, 1.0,
                        HUBER_PX / torch.sqrt(torch.clamp_min(n2, 1e-300)))
        f = intr[0]
        z = xc[:, 2]
        dudx = torch.zeros((len(z), 2, 3), dtype=X.dtype, device=X.device)
        dudx[:, 0, 0] = f / z
        dudx[:, 1, 1] = f / z
        dudx[:, :, 2] = -f * xc[:, :2] / (z * z)[:, None]
        Rv = R[self.view]
        Jw = dudx @ (-_skew(xc))                            # rotation
        JC = -(dudx @ Rv)                                   # centre
        B = dudx @ Rv                                       # point
        Ji = torch.zeros((len(z), 2, 3), dtype=X.dtype, device=X.device)
        Ji[:, :, 0] = xc[:, :2] / z[:, None]
        Ji[:, 0, 1] = 1.0
        Ji[:, 1, 2] = 1.0
        nc = 6 * self.n_cam + 3
        Jc = torch.zeros((len(z), 2, nc), dtype=X.dtype, device=X.device)
        c = self.col[self.view]
        on = c >= 0
        base = (6 * c[on])[:, None] + torch.arange(6, device=X.device)
        Jc[on] = Jc[on].scatter(-1, base[:, None, :].expand(-1, 2, -1),
                                torch.cat([Jw, JC], -1)[on])
        Jc[:, :, -3:] = Ji
        if self.pin is not None:
            Jc[:, :, self.pin] = 0.0
        wJc = Jc * w[:, None, None]
        wB = B * w[:, None, None]
        U = torch.einsum("oki,okj->ij", wJc, Jc)
        gc = torch.einsum("oki,ok->i", wJc, r)
        L = X.shape[0]
        Vp = torch.zeros((L, 3, 3), dtype=X.dtype, device=X.device)
        Vp.index_add_(0, self.pt, torch.einsum("oki,okj->oij", wB, B))
        gp = torch.zeros((L, 3), dtype=X.dtype, device=X.device)
        gp.index_add_(0, self.pt, torch.einsum("oki,ok->oi", wB, r))
        W = torch.zeros((L, 3, nc), dtype=X.dtype, device=X.device)
        W.index_add_(0, self.pt, torch.einsum("oki,okj->oij", wB, Jc))
        eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
        Vd = Vp + lam * (Vp * eye3 + 1e-12 * eye3)
        Vinv = torch.linalg.inv(Vd)
        Y = Vinv @ W                                        # (L, 3, nc)
        S = U + lam * torch.diag(torch.diagonal(U) + 1e-12) \
            - torch.einsum("pki,pkj->ij", W, Y)
        if self.pin is not None:
            S[self.pin, self.pin] += 1.0
        rhs = -gc + torch.einsum("pki,pk->i", Y, gp)
        dc = torch.linalg.solve(S, rhs)
        dp = -(Vinv @ (gp[..., None] + W @ dc[:, None]))[..., 0]
        dcam = dc[:-3].reshape(self.n_cam, 6)
        R2, C2 = R.clone(), C.clone()
        free = self.col >= 0
        idx = self.col[free]
        R2[free] = _exp_so3(dcam[idx, :3]) @ R[free]
        C2[free] = C[free] + dcam[idx, 3:]
        return R2, C2, intr + dc[-3:], X + dp

    def solve(self, iterations: int = 200, rtol: float = 1e-13):
        """LM from the current state until a step gains under ``rtol`` of
        the cost; returns the final cost."""
        cost = float(self.cost())
        lam = 1e-4
        for _ in range(iterations):
            trial = self.step(lam)
            c2 = float(self.cost(*trial))
            if c2 < cost:
                gain = (cost - c2) / max(cost, 1e-300)
                self.R, self.C, self.intr, self.X = trial
                cost = c2
                lam = max(lam / 3.0, 1e-12)
                if gain < rtol:
                    break
            else:
                lam *= 4.0
                if lam > 1e8:
                    break
        return cost


def problem_from_scene(z: Dict[str, np.ndarray], dtype, device) -> Problem:
    """The BA problem of a saved scene (the arrays of its ``scene.npz``):
    live observations of live tracks in posed views."""
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=device)
    pose_mask = np.asarray(z["poses.mask"], bool)
    live = (np.asarray(z["observations.mask"], bool)
            & np.asarray(z["landmarks.mask"], bool)[z["observations.landmark_id"]]
            & pose_mask[z["observations.view_id"]])
    lid = np.asarray(z["observations.landmark_id"])[live]
    pts, pt = np.unique(lid, return_inverse=True)
    view = np.asarray(z["observations.view_id"])[live]
    posed = np.nonzero(pose_mask)[0]
    intr = np.asarray(z["intrinsics.params"])[0, :3]
    return Problem(t(z["poses.R"]), t(z["poses.C"]), t(intr),
                   t(np.asarray(z["landmarks.X"])[pts]),
                   t(view, torch.long), t(pt, torch.long),
                   t(np.asarray(z["observations.xy"])[live]), posed,
                   fixed_view=int(posed[0]) if len(posed) else -1)


def residuals_px(p: Problem) -> np.ndarray:
    uvp, _ = p.project(p.R, p.C, p.intr, p.X)
    return torch.linalg.norm(uvp - p.uv, dim=-1).cpu().numpy()


def program_tracks(z: Dict[str, np.ndarray]) -> List[frozenset]:
    """The step's track table (every row of ``scene.npz``) as track sets."""
    lid = np.asarray(z["observations.landmark_id"])
    vid = np.asarray(z["observations.view_id"])
    fid = np.asarray(z["observations.feature_id"])
    out: Dict[int, list] = {}
    for l, v, f in zip(lid.tolist(), vid.tolist(), fid.tolist()):
        out.setdefault(l, []).append((v, f))
    return [frozenset(n) for n in out.values()]
