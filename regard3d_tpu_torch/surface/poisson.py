"""Surface reconstruction: FFT Poisson solve on a dense grid.

Counterpart of ``regard3d_tpu/surface/poisson.py``. The reference shells
out to PoissonRecon/SurfaceTrimmer (``src/R3DSurfaceGenProcess.cpp:
105-141``); this module is the in-process equivalent, built around the
Fourier formulation of Poisson surface reconstruction (Kazhdan, SGP 2005):
an oriented point cloud defines a smoothed normal vector field V; the
indicator function chi satisfies ``laplacian(chi) = div V``, which
diagonalizes under the DFT, so the solve is three FFTs, an elementwise
spectral multiply and an inverse FFT (complex64, ``torch.fft``).

Pipeline: normalize points into the unit cube -> trilinear splat of
normals (and a density channel) onto an N^3 grid -> Gaussian smoothing in
the spectral domain -> spectral inverse Laplacian -> isolevel = mean of chi
at the samples -> marching tetrahedra (host,
:mod:`regard3d_tpu_torch.surface.marching`) -> density-based trimming
(SurfaceTrimmer parity).

The splat is a deterministic scatter: the reference's ``.at[idx].add``
would be an atomic ``index_add_`` on the card, whose summation order (and
so whose rounding) changes from run to run. Here every (voxel, weight)
contribution is sorted by flat voxel index (stable) and each voxel's run is
summed by ``torch.segment_reduce``, in the reference's order (corner-major,
then point order), so a reconstruction repeats bit for bit.

Parameter parity with the reference dialog (src/R3DProject.h:155-170):
``depth`` -> grid resolution 2^depth per axis (dense, capped at 256);
``samples_per_node`` -> splat smoothing width scale; ``point_weight`` ->
screening weight (0 = pure gradient fit); ``trim_threshold`` -> density
percentile below which triangles are trimmed.

Profiler spans: ``surface.splat``, ``surface.solve`` (with the isolevel and
the copy of chi to the host), ``surface.marching``, ``surface.trim``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.core.sfm_data import _np


def normalize_points(xyz: np.ndarray, margin: float = 0.1):
    """Map points into [margin, 1-margin]^3 preserving aspect.

    Returns (unit_xyz, scale, offset) with ``xyz = unit * scale + offset``."""
    lo = xyz.min(0)
    hi = xyz.max(0)
    extent = float((hi - lo).max())
    scale = extent / (1.0 - 2.0 * margin)
    center = 0.5 * (lo + hi)
    offset = center - 0.5 * scale
    return (xyz - offset) / scale, scale, offset


def _corners(unit_xyz: torch.Tensor, n: int):
    """Trilinear corner weights and flat voxel indices of unit-cube points,
    corner by corner in the reference's (dx, dy, dz) order."""
    p = unit_xyz * (n - 1)
    p0 = torch.floor(p)
    f = p - p0
    i0 = torch.clamp(p0.long(), 0, n - 2)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                flat = (((i0[:, 0] + dx) * n + (i0[:, 1] + dy)) * n
                        + (i0[:, 2] + dz))
                yield w, flat


def splat_field(unit_xyz: torch.Tensor, normals: torch.Tensor, n: int):
    """Trilinear scatter of (normal, density) onto an n^3 grid, summed in a
    fixed order (see the module notes).

    Returns (V, W): V (n, n, n, 3) normal field, W (n, n, n) density."""
    idx, vals = [], []
    for w, flat in _corners(unit_xyz, n):
        idx.append(flat)
        vals.append(torch.cat([w[:, None] * normals, w[:, None]], 1))
    idx = torch.cat(idx)
    vals = torch.cat(vals)
    order = torch.argsort(idx, stable=True)
    keys, counts = torch.unique_consecutive(idx[order], return_counts=True)
    sums = torch.segment_reduce(vals[order], "sum", lengths=counts, axis=0)
    acc = torch.zeros((n * n * n, 4), dtype=torch.float32,
                      device=unit_xyz.device)
    acc[keys] = sums
    return (acc[:, :3].reshape(n, n, n, 3).contiguous(),
            acc[:, 3].reshape(n, n, n).contiguous())


def _freq_sq(n: int, device) -> torch.Tensor:
    """(|k|^2, (kx, ky, kz)) of the n^3 DFT grid, k = 2 pi fftfreq(n) in
    float32, the axes broadcastable against (n, n, n)."""
    k = torch.fft.fftfreq(n, dtype=torch.float32, device=device) * 2.0 \
        * math.pi
    kx, ky, kz = k[:, None, None], k[None, :, None], k[None, None, :]
    return kx * kx + ky * ky + kz * kz, (kx, ky, kz)


def solve_indicator(V: torch.Tensor, n: int, sigma_vox: float = 1.5,
                    screen: float = 0.0):
    """Spectral solve of ``(laplacian - screen) chi = div V_smooth``.

    All operators diagonalize under the 3D DFT with periodic boundaries
    (the margin in :func:`normalize_points` keeps the surface away from the
    wrap-around seam).  Derivatives use the exact spectral symbols so div
    and the inverse Laplacian are mutually consistent."""
    k2, (kx, ky, kz) = _freq_sq(n, V.device)

    # Gaussian smoothing of the splatted field, fused into the solve; the
    # coefficient in float32 as the reference computes it
    s = np.float32(sigma_vox)
    g = torch.exp(float(np.float32(-0.5) * (s * s)) * k2)

    Vx = torch.fft.fftn(V[..., 0])
    Vy = torch.fft.fftn(V[..., 1])
    Vz = torch.fft.fftn(V[..., 2])
    div = 1j * (kx * Vx + ky * Vy + kz * Vz) * g
    denom = -(k2 + screen)
    denom = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    chi_hat = torch.where(k2 < 1e-12, 0.0, div / denom)
    # sign: with OUTWARD input normals the raw solution is lower inside;
    # negate so chi acts as an indicator (higher inside), which is what
    # the marching step's outward-orientation rule assumes.
    return -torch.real(torch.fft.ifftn(chi_hat)).float()


def sample_trilinear(vol: torch.Tensor, unit_xyz: torch.Tensor):
    """Trilinear sample of an n^3 volume at unit-cube points."""
    flat = vol.reshape(-1)
    out = 0.0
    for w, idx in _corners(unit_xyz, vol.shape[0]):
        out = out + w * flat[idx]
    return out


def _smoothed_density(W: torch.Tensor, n: int) -> torch.Tensor:
    """The density grid smoothed by a Gaussian of 2 voxels (spectral)."""
    k2, _ = _freq_sq(n, W.device)
    return torch.real(torch.fft.ifftn(torch.fft.fftn(W)
                                      * torch.exp(-2.0 * k2)))


def reconstruct(xyz: np.ndarray, normals: np.ndarray, depth: int = 7,
                samples_per_node: float = 1.0, point_weight: float = 0.0,
                trim_threshold: float = 7.0, device=None):
    """Oriented cloud -> triangle mesh (vertices in input coordinates), on
    ``cuda`` unless ``device="cpu"``.

    Args mirror the reference surface dialog: ``depth`` (grid 2^depth,
    capped 256), ``samples_per_node`` (smoothing scale), ``point_weight``
    (screening), ``trim_threshold`` (0..10 density trim, 0 = keep all —
    SurfaceTrimmer --trim parity at the same scale).

    Returns (verts (M, 3) float, faces (T, 3) int32).
    """
    from regard3d_tpu_torch.surface import marching

    dev = runtime.resolve_device(device)
    n = min(2 ** depth, 256)
    unit, scale, offset = normalize_points(np.asarray(xyz, np.float32))
    nrm = np.asarray(normals, np.float32)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    f32 = dict(dtype=torch.float32, device=dev)

    with torch.no_grad():
        unit_t = torch.as_tensor(unit, **f32)
        with record_function("surface.splat"):
            V, W = splat_field(unit_t, torch.as_tensor(nrm, **f32), n)
        sigma = 1.5 * float(np.sqrt(samples_per_node))
        with record_function("surface.solve"):
            chi = solve_indicator(V, n, sigma_vox=sigma,
                                  screen=float(point_weight) * 1e-2)
            del V
            # isolevel: mean of chi at the input samples
            iso = float(torch.mean(sample_trilinear(chi, unit_t)))
            chi_np = _np(chi)
        with record_function("surface.marching"):
            verts_u, faces = marching.marching_tetrahedra(chi_np, iso)

        if trim_threshold > 0 and len(faces):
            # trim triangles lying in low-density space (SurfaceTrimmer
            # role): threshold is a percentile-like 0..10 knob on the
            # smoothed density
            with record_function("surface.trim"):
                Ws = _smoothed_density(W, n)
                cent = verts_u[faces].mean(1)
                dens = _np(sample_trilinear(Ws, torch.as_tensor(cent,
                                                                **f32)))
                ref_dens = np.percentile(_np(sample_trilinear(Ws, unit_t)),
                                         25)
                keep = dens > ref_dens * (trim_threshold / 10.0) * 0.5
                faces = faces[keep]
                verts_u, faces = marching.compact_mesh(verts_u, faces)

    verts = verts_u * scale + offset
    return verts.astype(np.float64), faces
