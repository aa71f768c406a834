"""Frozen copy of ``regard3d_tpu_torch/kernels/scale_space.py`` (commit 794b6e4),
the plain PyTorch path, kept as the benchmark's reference: the precision import dropped (the reference sets its own).
Its arithmetic follows the dtype of its inputs (float64 for the
reference, float32 for the control).

AKAZE nonlinear scale space as batched PyTorch image ops.

Counterpart of ``regard3d_tpu/kernels/scale_space.py``: FED tau schedules
computed on the host from the static config, separable reflect-101
convolutions, Scharr derivatives, the PM-G2 conductivity, explicit
diffusion steps, the contrast percentile, 2x2 halfsampling. Arrays are
(B, H, W) with per-image contrast factors k as (B,) vectors.

The reference's banded-matmul convolution (``conv_sep_matmul``) exists to
stay on the TPU's matrix unit; here every convolution is a reflect-101 pad
followed by two 1-D ``F.conv2d`` passes, which is what the reference's CPU
path computes. cuDNN's TF32 is switched off in ``runtime``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F




@dataclasses.dataclass(frozen=True)
class ScaleSpaceConfig:
    omax: int = 4                 # octaves
    nsublevels: int = 4           # sublevels per octave
    soffset: float = 1.6          # base scale
    derivative_factor: float = 1.5
    dthreshold: float = 0.001     # detector response threshold
    min_dthreshold: float = 1e-5
    kcontrast_percentile: float = 0.7
    kcontrast_nbins: int = 300
    tau_max: float = 0.25
    fed_reordering: bool = True   # parity flag (taus are permuted; sums equal)

    def esigma(self, octave: int, sublevel: int) -> float:
        return self.soffset * 2.0 ** (sublevel / self.nsublevels + octave)

    def etime(self, octave: int, sublevel: int) -> float:
        s = self.esigma(octave, sublevel)
        return 0.5 * s * s


@dataclasses.dataclass(frozen=True)
class LevelMeta:
    """Static metadata for one evolution level."""
    index: int
    octave: int
    sublevel: int
    esigma: float
    etime: float
    ratio: int            # 2**octave
    sigma_size: int       # round(esigma * derivative_factor / ratio)
    taus: tuple           # FED step sizes from the previous level


def fed_tau_by_process_time(T: float, M: int = 1,
                            tau_max: float = 0.25) -> np.ndarray:
    """FED tau schedule (fed.cpp), host-side and static."""
    t = T / float(M)
    n = int(math.ceil(math.sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1e-8) + 0.5)
    if n <= 0:
        return np.zeros((0,), np.float32)
    scale = 3.0 * t / (tau_max * n * (n + 1))
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    k = np.arange(n)
    h = np.cos(math.pi * (2.0 * k + 1.0) * c)
    return (d / (h * h)).astype(np.float32)


def num_octaves(cfg: ScaleSpaceConfig, height: int = 0,
                width: int = 0) -> int:
    """Octave count capped by image size (an octave is dropped when its
    level would be < 80 wide or < 40 tall)."""
    omax = cfg.omax
    if height and width:
        for i in range(1, cfg.omax):
            if (width >> i) < 80 or (height >> i) < 40:
                omax = i
                break
    return omax


def level_metas(cfg: ScaleSpaceConfig, height: int = 0,
                width: int = 0) -> List[LevelMeta]:
    metas = []
    idx = 0
    for o in range(num_octaves(cfg, height, width)):
        for j in range(cfg.nsublevels):
            es = cfg.esigma(o, j)
            et = cfg.etime(o, j)
            ratio = 1 << o
            taus = ()
            if idx > 0:
                prev = metas[-1]
                taus = tuple(fed_tau_by_process_time(et - prev.etime,
                                                     tau_max=cfg.tau_max))
            metas.append(LevelMeta(
                index=idx, octave=o, sublevel=j, esigma=es, etime=et,
                ratio=ratio,
                sigma_size=int(round(es * cfg.derivative_factor / ratio)),
                taus=taus))
            idx += 1
    return metas


# ---------------------------------------------------------------------------
# Convolution helpers (reflect-101 borders, separable)
# ---------------------------------------------------------------------------

def conv_sep(img, kx: np.ndarray, ky: np.ndarray):
    """Separable 2D correlation on (B, H, W) with reflect-101 borders. kx
    applies along width (x), ky along height (y) (OpenCV filter2D parity)."""
    ry, rx = len(ky) // 2, len(kx) // 2
    x = img[:, None]
    if ry or rx:
        x = F.pad(x, (rx, rx, ry, ry), mode="reflect")
    kya = torch.as_tensor(np.asarray(ky, np.float32), dtype=img.dtype,
                          device=img.device).reshape(1, 1, len(ky), 1)
    kxa = torch.as_tensor(np.asarray(kx, np.float32), dtype=img.dtype,
                          device=img.device).reshape(1, 1, 1, len(kx))
    x = F.conv2d(x, kya)
    x = F.conv2d(x, kxa)
    return x[:, 0]


def gaussian_ksize(sigma: float) -> int:
    """OpenCV-parity automatic kernel size."""
    k = int(math.ceil(2.0 * (1.0 + (sigma - 0.8) / 0.3)))
    if k % 2 == 0:
        k += 1
    return max(k, 3)


def gaussian_kernel1d(sigma: float, ksize: int = 0) -> np.ndarray:
    if ksize <= 0:
        ksize = gaussian_ksize(sigma)
    x = np.arange(ksize) - (ksize - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(img, sigma: float, ksize: int = 0):
    k = gaussian_kernel1d(sigma, ksize)
    return conv_sep(img, k, k)


def scharr_kernels(scale: int):
    """Scaled Scharr derivative kernels (AKAZE compute_derivative_kernels)."""
    if scale == 1:
        deriv = np.array([-1.0, 0.0, 1.0], np.float32)
        smooth = np.array([3.0, 10.0, 3.0], np.float32) / 32.0
        return deriv, smooth
    ksize = 3 + 2 * (scale - 1)
    w = 10.0 / 3.0
    norm = 1.0 / (2.0 * scale * (w + 2.0))
    smooth = np.zeros(ksize, np.float32)
    smooth[0] = norm
    smooth[ksize // 2] = w * norm
    smooth[-1] = norm
    deriv = np.zeros(ksize, np.float32)
    deriv[0] = -1.0
    deriv[-1] = 1.0
    return deriv, smooth


def scharr(img, dx: int, dy: int, scale: int = 1):
    """Scharr derivative of order (dx, dy) in {(1,0),(0,1)} at given scale."""
    deriv, smooth = scharr_kernels(scale)
    if dx == 1:
        return conv_sep(img, deriv, smooth)
    return conv_sep(img, smooth, deriv)


def halfsample(img):
    """2x2 area downsample (halfsample_image / INTER_AREA parity)."""
    B, H, W = img.shape
    return img.reshape(B, H // 2, 2, W // 2, 2).mean((2, 4))


# ---------------------------------------------------------------------------
# Diffusion
# ---------------------------------------------------------------------------

def pm_g2(Lx, Ly, k):
    """Perona–Malik g2 conductivity: 1 / (1 + |grad|^2 / k^2). k: (B,)."""
    k2 = (k * k)[:, None, None]
    return 1.0 / (1.0 + (Lx * Lx + Ly * Ly) / k2)


def nld_step(L, g, tau: float):
    """One explicit diffusion step with zero-flux borders."""
    gsum_r = g[:, :, 1:] + g[:, :, :-1]
    diff_r = L[:, :, 1:] - L[:, :, :-1]
    flux_x = gsum_r * diff_r                      # (B, H, W-1)
    gsum_d = g[:, 1:, :] + g[:, :-1, :]
    diff_d = L[:, 1:, :] - L[:, :-1, :]
    flux_y = gsum_d * diff_d                      # (B, H-1, W)
    zx = torch.zeros_like(L[:, :, :1])
    zy = torch.zeros_like(L[:, :1, :])
    div = (torch.cat([flux_x, zx], 2) - torch.cat([zx, flux_x], 2)
           + torch.cat([flux_y, zy], 1) - torch.cat([zy, flux_y], 1))
    return L + (0.5 * tau) * div


def compute_k_percentile(img, cfg: ScaleSpaceConfig):
    """Contrast factor k = gradient-magnitude percentile (smooth sigma=1,
    Scharr, 300-bin histogram, 70th percentile of nonzero magnitudes).
    img: (B, H, W) -> k: (B,). The histogram is a scatter-add of exact
    integer counts (the reference's one-hot sum, without the (B, HW, bins)
    temporary)."""
    smooth = gaussian_blur(img, 1.0)
    lx = scharr(smooth, 1, 0, 1)
    ly = scharr(smooth, 0, 1, 1)
    modg = torch.sqrt(lx * lx + ly * ly)[:, 1:-1, 1:-1]
    B = modg.shape[0]
    flat = modg.reshape(B, -1)
    hmax = torch.amax(flat, dim=1, keepdim=True)
    nbins = cfg.kcontrast_nbins
    scaled = flat / torch.where(hmax > 0, hmax, 1.0)
    nbin = torch.clamp((scaled * nbins).to(torch.int32), 0, nbins - 1)
    valid = flat > 0
    hist = torch.zeros((B, nbins), dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, nbin.long(), valid.to(torch.float32))
    npoints = valid.sum(1).to(torch.float32)
    csum = torch.cumsum(hist, dim=1)
    target = cfg.kcontrast_percentile * npoints
    kbin = torch.argmax((csum > target[:, None]).to(torch.int8),
                        dim=1).to(torch.float32)
    reached = csum[:, -1] > target
    k = torch.where(reached, hmax[:, 0] * kbin / nbins, 0.03)
    return torch.where(k > 0, k, 0.03)


@dataclasses.dataclass
class Evolution:
    """One evolution level's tensors (all (B, H_o, W_o))."""
    meta: LevelMeta
    Lt: torch.Tensor        # diffused image
    Lsmooth: torch.Tensor   # gaussian(sigma=1) of the pre-diffusion Lt


def build_scale_space(img, cfg: ScaleSpaceConfig = ScaleSpaceConfig()):
    """img: (B, H, W) float in [0,1]; H, W divisible by 2**(omax-1).
    Returns (levels: List[Evolution], kcontrast: (B,))."""
    B, H, W = img.shape
    no = num_octaves(cfg, H, W)
    if H % (1 << (no - 1)) or W % (1 << (no - 1)):
        raise ValueError(f"image dims {H}x{W} must be divisible by "
                         f"{1 << (no - 1)}")
    metas = level_metas(cfg, H, W)
    k = compute_k_percentile(img, cfg)

    Lt = gaussian_blur(img, cfg.soffset)
    levels: List[Evolution] = [Evolution(metas[0], Lt, Lt)]
    kcur = k
    for m in metas[1:]:
        prev = levels[-1]
        if m.octave > prev.meta.octave:
            Lt = halfsample(prev.Lt)
            kcur = kcur * 0.75
        else:
            Lt = prev.Lt
        # Lsmooth = blur of the PRE-diffusion Lt (the reference computes
        # Lsmooth/flow before the FED steps advance Lt)
        Lsmooth = gaussian_blur(Lt, 1.0)
        Lx = scharr(Lsmooth, 1, 0, 1)
        Ly = scharr(Lsmooth, 0, 1, 1)
        g = pm_g2(Lx, Ly, kcur)
        for tau in m.taus:
            Lt = nld_step(Lt, g, float(tau))
        levels.append(Evolution(m, Lt, Lsmooth))
    return levels, k
