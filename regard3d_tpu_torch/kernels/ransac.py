"""Batched AC-RANSAC: the geometric filter (F / E / H) and resection.

Counterpart of ``regard3d_tpu/kernels/ransac.py``. The
reference vmaps a single-pair filter over a block of pairs; here the pair
block is an explicit leading dimension P of every tensor, and the
``lax.scan`` hypothesis sweep is a Python loop over chunks:

* all samples of a pair are drawn up front (``_draw_samples``), or injected
  as a precomputed ``(P, iters, s)`` index tensor;
* each chunk of draws (128, or 64 for the 5-point E solver that emits up to
  10 models a draw) is solved as one batched minimal problem and scored with
  the truncated residual sum; a later chunk replaces the best model only if
  its score is strictly lower, so ties keep the earliest draw;
* the a-contrario threshold (NFA minimisation over the sorted residuals) is
  applied to the winner, followed by a masked least-squares refit.

The E filter's hypothesis sweep (``e_sweep``) is the one step with a kernel
of its own: on CUDA tensors one C call of ``csrc/essential5.cu`` solves and
scores every draw on the card; CPU tensors take ``e_sweep_plain``, the
chunked loop above with the 5-point solver of ``geometry``. There is no
fallback: a CUDA tensor launches the kernel or raises.

Random draws come from ``torch.Generator``s, one per pair. They cannot give
``jax.random``'s bits, so parity tests inject the reference's indices.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from regard3d_tpu_torch.kernels import _build, geometry

_BIG = 1e30
_E_SOURCE = "essential5.cu"

_E_DTYPE = {torch.float32: (0, "f32"), torch.float64: (1, "f64")}


class RansacResult(NamedTuple):
    model: torch.Tensor         # (P, 3, 3)
    inliers: torch.Tensor       # (P, N) bool
    num_inliers: torch.Tensor   # (P,) int
    threshold_sq: torch.Tensor  # (P,) adaptive squared threshold
    log_nfa: torch.Tensor       # (P,) log10 NFA of the accepted model
    valid: torch.Tensor         # (P,) bool


def _draw_samples_batch(generators: Sequence[torch.Generator], mask,
                        iters: int, s: int):
    """(P, iters, s) distinct indices of valid entries, one generator per
    pair. Sequential-sampling construction: draw j from [0, nvalid - j) and
    shift past the already-chosen slots; a stable argsort compacts the
    valid indices to the front."""
    P, n = mask.shape
    nvalid = mask.sum(-1, keepdim=True).to(torch.int32)            # (P, 1)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    u = torch.stack([torch.rand((iters, s), generator=g, device=g.device)
                     for g in generators]).to(mask.device)        # (P, it, s)
    cols = []
    for j in range(s):
        hi = torch.clamp_min(nvalid - j, 1)
        dj = torch.minimum((u[..., j] * hi).to(torch.int32), hi - 1)
        if j > 0:
            prev = torch.sort(torch.stack(cols, -1), dim=-1).values
            for k in range(j):
                dj = dj + (dj >= prev[..., k]).to(torch.int32)
        cols.append(dj)
    chosen = torch.clamp(torch.stack(cols, -1), 0, n - 1).long()
    return torch.gather(order, 1, chosen.reshape(P, -1)).reshape(P, iters, s)


def _draw_samples(generator: torch.Generator, mask, iters: int, s: int):
    """(iters, s) distinct indices of valid entries of one pair."""
    return _draw_samples_batch([generator], mask[None], iters, s)[0]


def _samples(generators, mask, iters, s, idx):
    if idx is not None:
        return torch.as_tensor(idx, device=mask.device).long()
    if generators is None:
        raise ValueError("pass either per-pair generators or idx")
    return _draw_samples_batch(generators, mask, iters, s)


def _log10_comb(n, k):
    """log10 C(n, k) elementwise (float inputs ok)."""
    ln10 = math.log(10.0)
    like = n if torch.is_tensor(n) else k
    n = torch.as_tensor(n, dtype=like.dtype, device=like.device)
    k = torch.as_tensor(k, dtype=like.dtype, device=like.device)
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0)) / ln10


def _per_pair(x, P, like):
    return torch.as_tensor(x, dtype=like.dtype,
                           device=like.device).reshape(-1).expand(P)


def _nfa_threshold(resid_sq, mask, sample_size: int, logalpha0,
                   err_dim: float, max_err_sq):
    """A-contrario threshold per pair. resid_sq, mask: (P, N); logalpha0,
    max_err_sq: (P,). Returns (threshold_sq, log_nfa, k_star), each (P,).
    NFA(k) = (N-s) C(N,k) C(k,s) (alpha0 * r_k^d)^(k-s)  (ORSA)."""
    P, n = resid_sq.shape
    r = torch.where(mask, resid_sq, _BIG)
    sorted_r = torch.sort(r, dim=-1).values
    nvalid = mask.sum(-1)
    ks = torch.arange(1, n + 1, dtype=resid_sq.dtype,
                      device=resid_sq.device)[None, :]
    nf = nvalid.to(resid_sq.dtype)[:, None]
    log_c_n_k = _log10_comb(nf, ks)
    log_c_k_s = _log10_comb(ks, float(sample_size))
    dist = torch.sqrt(torch.clamp_min(sorted_r, 1e-24))
    lognfa = (torch.log10(torch.clamp_min(nf - sample_size, 1.0))
              + log_c_n_k + log_c_k_s
              + (ks - sample_size) * (logalpha0[:, None]
                                      + err_dim * torch.log10(dist)))
    eligible = ((ks > sample_size) & (ks <= nf)
                & (sorted_r <= max_err_sq[:, None]) & (sorted_r < _BIG / 2))
    lognfa = torch.where(eligible, lognfa, math.inf)
    k_star = torch.argmin(lognfa, dim=-1, keepdim=True)
    best = torch.gather(lognfa, -1, k_star)[:, 0]
    thr = torch.gather(sorted_r, -1, k_star)[:, 0]
    ok = torch.isfinite(best)
    return (torch.where(ok, thr, max_err_sq), torch.where(ok, best, math.inf),
            k_star[:, 0])


def _take(t, b):
    """t[p, b[p]] for a (P, M, ...) tensor and (P,) indices."""
    return t[torch.arange(t.shape[0], device=t.device), b]


def _finish(model, score_resid, data, mask, fit_fn, resid_fn, sample_size,
            logalpha0, err_dim, max_err_sq, ok_best=None):
    """AC threshold on the winner, weighted refit, keep the better NFA."""
    m_ok = mask if ok_best is None else mask & ok_best[:, None]
    r_best = torch.where(m_ok, score_resid(model), _BIG)
    thr_sq, log_nfa, _ = _nfa_threshold(r_best, mask, sample_size, logalpha0,
                                        err_dim, max_err_sq)
    inliers = mask & (r_best <= thr_sq[:, None])
    model2 = fit_fn(data, weights=inliers.to(model.dtype))        # (P, 3, 3)
    r2 = torch.where(mask, score_resid(model2), _BIG)
    thr2, nfa2, _ = _nfa_threshold(r2, mask, sample_size, logalpha0, err_dim,
                                   max_err_sq)
    better = nfa2 <= log_nfa
    model = torch.where(better[:, None, None], model2, model)
    inliers = torch.where(better[:, None], mask & (r2 <= thr2[:, None]),
                          inliers)
    thr_sq = torch.where(better, thr2, thr_sq)
    log_nfa = torch.minimum(nfa2, log_nfa)
    return model, inliers, thr_sq, log_nfa


def ransac(generators, data, mask, fit_fn: Callable, resid_fn: Callable,
           sample_size: int, iters: int, max_err_sq, logalpha0,
           err_dim: float = 1.0, min_inliers: int = 0,
           idx: Optional[torch.Tensor] = None) -> RansacResult:
    """Generic AC-RANSAC over a block of P pairs.

    data: dict of (P, N, ...) tensors; mask: (P, N); fit_fn(sampled dict of
    (S, s, ...), weights=None) -> (S, 3, 3); resid_fn(models (P, S, 3, 3),
    data) -> (P, S, N) squared residuals. ``generators``: one
    ``torch.Generator`` per pair, or ``idx`` (P, iters, s) precomputed
    sample indices. ``max_err_sq``/``logalpha0``: scalars or (P,)."""
    P, n = mask.shape
    leaf = next(iter(data.values()))
    max_err_sq = _per_pair(max_err_sq, P, leaf)
    logalpha0 = _per_pair(logalpha0, P, leaf)
    chunk = min(iters, 128)
    n_chunks = -(-iters // chunk)
    idx = _samples(generators, mask, n_chunks * chunk, sample_size, idx)

    best_score = torch.full((P,), _BIG * n, dtype=leaf.dtype,
                            device=leaf.device)
    best_model = torch.zeros((P, 3, 3), dtype=leaf.dtype, device=leaf.device)
    for c in range(n_chunks):
        ic = idx[:, c * chunk:(c + 1) * chunk]                     # (P, C, s)
        sampled = {k: _gather_rows(v, ic).reshape(
            P * chunk, sample_size, *v.shape[2:]) for k, v in data.items()}
        models = fit_fn(sampled).reshape(P, chunk, 3, 3)
        resid = torch.where(mask[:, None, :], resid_fn(models, data), _BIG)
        score = torch.sum(torch.minimum(resid, max_err_sq[:, None, None]), -1)
        b = torch.argmin(score, dim=-1)
        sb = _take(score, b)
        better = sb < best_score
        best_score = torch.where(better, sb, best_score)
        best_model = torch.where(better[:, None, None], _take(models, b),
                                 best_model)

    model, inliers, thr_sq, log_nfa = _finish(
        best_model, lambda M: resid_fn(M[:, None], data)[:, 0], data, mask,
        fit_fn, resid_fn, sample_size, logalpha0, err_dim, max_err_sq)
    num = inliers.sum(-1)
    valid = (log_nfa < 0.0) & (num >= max(min_inliers, sample_size + 1))
    return RansacResult(model, inliers, num, thr_sq, log_nfa, valid)


def _gather_rows(v, ic):
    """v (P, N, ...) rows at ic (P, C, s) -> (P, C, s, ...)."""
    P, C, s = ic.shape
    flat = ic.reshape(P, C * s)
    idx = flat.reshape(P, C * s, *([1] * (v.dim() - 2))).expand(
        P, C * s, *v.shape[2:])
    return torch.gather(v, 1, idx).reshape(P, C, s, *v.shape[2:])


# ---------------------------------------------------------------------------
# Concrete filters (F / E / H)
# ---------------------------------------------------------------------------

def _logalpha0_line(w: float, h: float) -> float:
    """alpha0 for point-to-line errors: P(dist<r) ~ 2r * diag / area."""
    area = w * h
    diag = math.sqrt(w * w + h * h)
    return math.log10(2.0 * diag / area)


def _logalpha0_point(w: float, h: float) -> float:
    """alpha0 for point-to-point errors: P(dist<r) ~ pi r^2 / area."""
    return math.log10(math.pi / (w * h))


def _logalpha0_e(w: float, h: float, focal_px: float) -> float:
    """alpha0 for the E filter: normalized-coordinate point-to-line errors,
    so the pixel-domain alpha0 picks up +log10(f) (dist_px = f dist_norm)."""
    area = w * h
    diag = math.sqrt(w * w + h * h)
    return math.log10(2.0 * diag / area * focal_px)


def _epi_resid(M, d):
    return geometry.epipolar_dist_f(M, d["x1"][:, None], d["x2"][:, None])


def _h_resid(M, d):
    return geometry.sym_transfer_h(M, d["x1"][:, None], d["x2"][:, None])


def _f_one(generators, x1, x2, mask, logalpha0, max_err_sq, iters: int,
           idx=None) -> RansacResult:
    return ransac(
        generators, {"x1": x1, "x2": x2}, mask,
        fit_fn=lambda d, weights=None: geometry.fit_fundamental_8pt(
            d["x1"], d["x2"], weights),
        resid_fn=_epi_resid, sample_size=8, iters=iters,
        max_err_sq=max_err_sq, logalpha0=logalpha0, err_dim=1.0, idx=idx)


def _h_one(generators, x1, x2, mask, logalpha0, max_err_sq, iters: int,
           idx=None) -> RansacResult:
    return ransac(
        generators, {"x1": x1, "x2": x2}, mask,
        fit_fn=lambda d, weights=None: geometry.fit_homography_4pt(
            d["x1"], d["x2"], weights),
        resid_fn=_h_resid, sample_size=4, iters=iters,
        max_err_sq=max_err_sq, logalpha0=logalpha0, err_dim=2.0, idx=idx)


def e_sweep_plain(x1n, x2n, mask, max_err_sq, idx):
    """The E hypothesis sweep in plain PyTorch: Nistér 5-point candidates
    of every draw of ``idx`` (P, D, 5), 64 draws (<= 640 candidates) a
    chunk, each scored with the truncated epipolar residual sum over all
    slots (1e30 on masked slots and for candidates that are not ok); the
    least score wins, ties to the earliest (draw, slot). x1n, x2n: (P, N,
    2); mask: (P, N); max_err_sq: (P,). Returns (model (P, 3, 3), ok (P,))."""
    P, n = mask.shape
    data = {"x1": x1n, "x2": x2n}
    chunk = min(idx.shape[1], 64)
    n_chunks = -(-idx.shape[1] // chunk)

    b_score = torch.full((P,), _BIG * n, dtype=x1n.dtype, device=x1n.device)
    b_model = torch.zeros((P, 3, 3), dtype=x1n.dtype, device=x1n.device)
    b_ok = torch.zeros((P,), dtype=torch.bool, device=x1n.device)
    for c in range(n_chunks):
        ic = idx[:, c * chunk:(c + 1) * chunk]
        C = ic.shape[1]
        models, okm = geometry.fit_essential_5pt(
            _gather_rows(x1n, ic).reshape(P * C, 5, 2),
            _gather_rows(x2n, ic).reshape(P * C, 5, 2))
        models = models.reshape(P, C * 10, 3, 3)
        okm = okm.reshape(P, C * 10)
        resid = _epi_resid(models, data)
        resid = torch.where(mask[:, None, :] & okm[:, :, None], resid, _BIG)
        score = torch.sum(torch.minimum(resid, max_err_sq[:, None, None]), -1)
        b = torch.argmin(score, dim=-1)
        sb = _take(score, b)
        better = sb < b_score
        b_score = torch.where(better, sb, b_score)
        b_model = torch.where(better[:, None, None], _take(models, b), b_model)
        b_ok = torch.where(better, _take(okm, b), b_ok)
    return b_model, b_ok


# the kernel's constant tables per (card, dtype): _nullspace4's start and
# Durand-Kerner's, made on the card once
_E_TABLES: Dict[Tuple[int, torch.dtype], Tuple[torch.Tensor, ...]] = {}


def _e_tables(dev, dtype):
    key = (dev.index, dtype)
    tables = _E_TABLES.get(key)
    if tables is None:
        start = torch.as_tensor(geometry._NULL4_START, dtype=dtype,
                                device=dev).contiguous()
        dk = torch.view_as_real(geometry.dk_start(10, dev)).contiguous()
        tables = _E_TABLES[key] = (start, dk)
    return tables


def prepare_e_sweep(x1n, x2n, mask, max_err_sq, idx) -> _build.Call:
    """The C call of the E-sweep kernel, prepared: x1n, x2n (P, N, 2)
    float32 or float64, mask (P, N) bool, max_err_sq (P,) of the points'
    dtype, idx (P, D, 5) int64, all contiguous on one card. Its outputs are
    (model (P, 3, 3), ok (P,)). Raises ValueError on anything else."""
    P, n = mask.shape if mask.dim() == 2 else (0, 0)
    D = idx.shape[1] if idx.dim() == 3 else 0
    if (x1n.shape != (P, n, 2) or x2n.shape != (P, n, 2)
            or max_err_sq.shape != (P,) or idx.shape != (P, D, 5)
            or min(P, n, D) == 0 or P > 65535):
        raise ValueError(f"shapes x1n {tuple(x1n.shape)}, x2n "
                         f"{tuple(x2n.shape)}, mask {tuple(mask.shape)}, "
                         f"max_err_sq {tuple(max_err_sq.shape)}, idx "
                         f"{tuple(idx.shape)}: want (P, N, 2) twice, "
                         f"(P, N), (P,), (P, D, 5), none empty, P <= 65535")
    dev = _build.check(x1n=(x1n, None, tuple(_E_DTYPE)),
                       x2n=(x2n, None, x1n.dtype),
                       mask=(mask, None, torch.bool),
                       max_err_sq=(max_err_sq, None, x1n.dtype),
                       idx=(idx, None, torch.int64))
    code, tag = _E_DTYPE[x1n.dtype]
    lib = _build.load_library(_E_SOURCE)
    start, dk = _e_tables(dev, x1n.dtype)
    work = torch.empty((lib.r3d_e_sweep_workspace(code, P, D),),
                       dtype=torch.uint8, device=dev)
    model = torch.empty((P, 3, 3), dtype=x1n.dtype, device=dev)
    ok = torch.empty((P,), dtype=torch.bool, device=dev)
    args = (code, dev.index, x1n.data_ptr(), x2n.data_ptr(), mask.data_ptr(),
            max_err_sq.data_ptr(), idx.data_ptr(), P, n, D, start.data_ptr(),
            dk.data_ptr(), work.data_ptr(), model.data_ptr(), ok.data_ptr(),
            _build.stream(dev))
    return _build.Call(lib.r3d_e_sweep, args,
                       (x1n, x2n, mask, max_err_sq, idx, start, dk, work),
                       (model, ok), f"e_sweep_{tag}")


def prepare_e_solve(x1, x2) -> _build.Call:
    """The C call of the E-sweep kernel's solver alone, prepared: x1, x2
    (S, 5, 2) float32 or float64, contiguous on one card. Its outputs are
    (E (S, 10, 3, 3), ok (S, 10))."""
    S = x1.shape[0] if x1.dim() else 0
    if x1.shape != (S, 5, 2) or x2.shape != x1.shape or S == 0:
        raise ValueError(f"x1, x2 must be two non-empty (S, 5, 2) tensors, "
                         f"got {tuple(x1.shape)}, {tuple(x2.shape)}")
    dev = _build.check(x1=(x1, None, tuple(_E_DTYPE)),
                       x2=(x2, None, x1.dtype))
    code, tag = _E_DTYPE[x1.dtype]
    start, dk = _e_tables(dev, x1.dtype)
    E = torch.empty((S, 10, 3, 3), dtype=x1.dtype, device=dev)
    ok = torch.empty((S, 10), dtype=torch.bool, device=dev)
    args = (code, dev.index, x1.data_ptr(), x2.data_ptr(), S,
            start.data_ptr(), dk.data_ptr(), E.data_ptr(), ok.data_ptr(),
            _build.stream(dev))
    return _build.Call(_build.load_library(_E_SOURCE).r3d_e_solve, args,
                       (x1, x2, start, dk), (E, ok), f"e_solve_{tag}")


def essential_5pt(x1, x2):
    """``geometry.fit_essential_5pt`` (x1, x2 (S, 5, 2) -> E (S, 10, 3, 3),
    ok (S, 10)); on CUDA tensors the E-sweep kernel's solver, one thread a
    sample, launched alone (for tests and the smoke's candidate errors)."""
    if not x1.is_cuda:
        return geometry.fit_essential_5pt(x1, x2)
    return _build.launch(prepare_e_solve(x1.contiguous(), x2.contiguous()))


def e_sweep(x1n, x2n, mask, max_err_sq, idx):
    """The E hypothesis sweep of ``e_sweep_plain`` (same arguments and
    result). CPU tensors take the plain version; CUDA tensors launch the
    kernel of ``csrc/essential5.cu`` (or raise)."""
    if not x1n.is_cuda:
        return e_sweep_plain(x1n, x2n, mask, max_err_sq, idx)
    return _build.launch(prepare_e_sweep(
        x1n.contiguous(), x2n.contiguous(), mask.contiguous(),
        max_err_sq.contiguous(), idx.contiguous()))


def _e_one(generators, x1n, x2n, mask, logalpha0, max_err_sq, iters: int,
           idx=None) -> RansacResult:
    """Essential AC-RANSAC with Nistér 5-point minimal samples: each draw
    yields up to 10 E candidates, all scored (``e_sweep``); the a-contrario
    threshold, weighted 8-point refit and inlier extraction reuse the
    generic steps. The sweep takes the draws of ceil(iters / 64) chunks of
    min(iters, 64)."""
    P = mask.shape[0]
    max_err_sq = _per_pair(max_err_sq, P, x1n)
    logalpha0 = _per_pair(logalpha0, P, x1n)
    idx = _samples(generators, mask, iters, 5, idx)
    chunk = min(iters, 64)
    b_model, b_ok = e_sweep(x1n, x2n, mask, max_err_sq,
                            idx[:, :-(-iters // chunk) * chunk])
    data = {"x1": x1n, "x2": x2n}
    model, inliers, thr_sq, log_nfa = _finish(
        b_model, lambda M: _epi_resid(M[:, None], data)[:, 0], data, mask,
        lambda d, weights=None: geometry.fit_essential_8pt(
            d["x1"], d["x2"], weights),
        _epi_resid, 5, logalpha0, 1.0, max_err_sq, ok_best=b_ok)
    num = inliers.sum(-1)
    valid = (log_nfa < 0.0) & (num >= 6) & b_ok
    return RansacResult(model, inliers, num, thr_sq, log_nfa, valid)


# --- batched variants: one call robust-filters a whole block of pairs. ---
# generators: one torch.Generator per pair (or None with idx (P, iters, s));
# x1, x2: (P, N, 2); mask: (P, N); logalpha0, max_err_sq: (P,).

def acransac_f_batch(generators, x1, x2, mask, logalpha0, max_err_sq,
                     iters: int = 1024, idx=None) -> RansacResult:
    return _f_one(generators, x1, x2, mask, logalpha0, max_err_sq, iters, idx)


def acransac_e_batch(generators, x1, x2, mask, logalpha0, max_err_sq,
                     iters: int = 1024, idx=None) -> RansacResult:
    return _e_one(generators, x1, x2, mask, logalpha0, max_err_sq, iters, idx)


def acransac_h_batch(generators, x1, x2, mask, logalpha0, max_err_sq,
                     iters: int = 1024, idx=None) -> RansacResult:
    return _h_one(generators, x1, x2, mask, logalpha0, max_err_sq, iters, idx)


# ---------------------------------------------------------------------------
# Resection (the incremental engine's add-view step)
# ---------------------------------------------------------------------------

class ResectionResult(NamedTuple):
    R: torch.Tensor             # (P, 3, 3)
    C: torch.Tensor             # (P, 3)
    inliers: torch.Tensor       # (P, N) bool
    num_inliers: torch.Tensor   # (P,) int
    valid: torch.Tensor         # (P,) bool


def acransac_resection(generator, X, xn, mask, focal_px: float = 1.0,
                       iters: int = 512, max_err_px: float = 4.0,
                       solver: str = "p3p", idx=None) -> ResectionResult:
    """Robust resection of one view on normalized camera coords. X (N, 3),
    xn (N, 2), mask (N,); ``idx`` (iters, s) optional precomputed draws.
    Returns a ResectionResult without the leading dimension."""
    max_err = (max_err_px / focal_px) ** 2
    res = acransac_resection_batch(
        None if generator is None else [generator], X[None], xn[None],
        mask[None], torch.full((1,), max_err, dtype=X.dtype,
                               device=X.device),
        iters=iters, solver=solver, idx=None if idx is None else
        torch.as_tensor(idx)[None])
    return ResectionResult(*(t[0] for t in res))


def acransac_resection_batch(generators, X, xn, mask, max_err,
                             iters: int = 512, solver: str = "p3p",
                             idx=None) -> ResectionResult:
    """Resection over a view group (the grouped add-view step): P3P
    minimal samples (all up to 4 Grunert poses of a draw scored) or 6-point
    DLT, a chunked sweep of 128 draws a step, then a Gauss-Newton polish on
    the inliers and a second one on the recounted consensus. ``max_err``:
    (P,) squared normalized-coordinate bounds ((max_err_px / focal)^2).
    Shapes: X (P, N, 3), xn (P, N, 2), mask (P, N); ``generators`` one per
    view, or ``idx`` (P, iters, s) precomputed draws."""
    P, n = mask.shape
    s = 3 if solver == "p3p" else 6
    max_err = _per_pair(max_err, P, X)
    idx = _samples(generators, mask, iters, s, idx)
    chunk = min(iters, 128)
    n_chunks = -(-iters // chunk)

    dt, dev = X.dtype, X.device
    b_score = torch.full((P,), _BIG * n, dtype=dt, device=dev)
    b_R = torch.zeros((P, 3, 3), dtype=dt, device=dev)
    b_C = torch.zeros((P, 3), dtype=dt, device=dev)
    b_ok = torch.zeros((P,), dtype=torch.bool, device=dev)
    for c in range(n_chunks):
        ic = idx[:, c * chunk:(c + 1) * chunk]
        C_ = ic.shape[1]
        Xs = _gather_rows(X, ic).reshape(P * C_, s, 3)
        xs = _gather_rows(xn, ic).reshape(P * C_, s, 2)
        if solver == "p3p":
            Rc, Cc, okc = geometry.p3p_grunert(Xs, xs)
            m = C_ * 4
        else:
            Rc, Cc, okc = geometry.resection_dlt(Xs, xs)
            m = C_
        Rc, Cc, okc = Rc.reshape(P, m, 3, 3), Cc.reshape(P, m, 3), \
            okc.reshape(P, m)
        resid = geometry.reprojection_err_normalized(Rc, Cc, X[:, None],
                                                     xn[:, None])
        resid = torch.where(mask[:, None, :] & okc[:, :, None], resid, _BIG)
        score = torch.sum(torch.minimum(resid, max_err[:, None, None]), -1)
        b = torch.argmin(score, dim=-1)
        sb = _take(score, b)
        better = sb < b_score
        b_score = torch.where(better, sb, b_score)
        b_R = torch.where(better[:, None, None], _take(Rc, b), b_R)
        b_C = torch.where(better[:, None], _take(Cc, b), b_C)
        b_ok = torch.where(better, _take(okc, b), b_ok)

    def resid_of(R, C):
        return geometry.reprojection_err_normalized(
            R[:, None], C[:, None], X[:, None], xn[:, None])[:, 0]
    me = max_err[:, None]
    r_best = torch.where(mask & b_ok[:, None], resid_of(b_R, b_C), _BIG)
    inliers = mask & (r_best <= me)
    Rb, Cb = geometry.refine_pose(b_R, b_C, X, xn, inliers.to(dt), iters=10)
    r2 = torch.where(mask, resid_of(Rb, Cb), _BIG)
    inliers2 = mask & (r2 <= me)
    Rb2, Cb2 = geometry.refine_pose(Rb, Cb, X, xn, inliers2.to(dt), iters=5)
    r3 = torch.where(mask, resid_of(Rb2, Cb2), _BIG)
    inliers3 = mask & (r3 <= me)

    better = inliers3.sum(-1) >= inliers.sum(-1)
    Rf = torch.where(better[:, None, None], Rb2, b_R)
    Cf = torch.where(better[:, None], Cb2, b_C)
    inl = torch.where(better[:, None], inliers3, inliers)
    num = inl.sum(-1)
    valid = b_ok & (num >= 7)
    return ResectionResult(Rf, Cf, inl, num, valid)
