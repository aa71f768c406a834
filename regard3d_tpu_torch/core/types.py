"""Keypoint / descriptor containers and small array helpers.

Counterpart of ``regard3d_tpu/core/types.py`` (the feature-stage part): the
reference's ``flax.struct`` pytrees become small dataclasses of tensors with
the same fields and layouts. ``Scene`` arrives with the SfM slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --- camera model codes (parity with the reference's 5-model menu) ----------
PINHOLE = 0
RADIAL_K1 = 1
RADIAL_K3 = 2          # default, and unknown-camera fallback
BROWN_T2 = 3
FISHEYE = 4

CAMERA_MODEL_NAMES = {
    PINHOLE: "pinhole",
    RADIAL_K1: "radial_k1",
    RADIAL_K3: "radial_k3",
    BROWN_T2: "brown_t2",
    FISHEYE: "fisheye",
}
CAMERA_MODEL_CODES = {v: k for k, v in CAMERA_MODEL_NAMES.items()}

# number of distortion parameters actually used per model
DISTO_NPARAMS = {PINHOLE: 0, RADIAL_K1: 1, RADIAL_K3: 3, BROWN_T2: 5, FISHEYE: 4}

NUM_INTRINSIC_PARAMS = 9  # f, cx, cy, d0..d5 (padded)


@dataclasses.dataclass
class Keypoints:
    """Padded per-image keypoint batch (x, y, scale, orientation)."""

    xy: torch.Tensor      # (B, N, 2) float
    scale: torch.Tensor   # (B, N) float — patch diameter
    angle: torch.Tensor   # (B, N) float — radians
    score: torch.Tensor   # (B, N) float — detector response
    mask: torch.Tensor    # (B, N) bool

    @property
    def batch(self) -> int:
        return self.xy.shape[0]



@dataclasses.dataclass
class Descriptors:
    """Padded descriptor batch: LIOP's 144 floats, zero-padded to ``dim``."""

    data: torch.Tensor    # (B, N, D) float
    mask: torch.Tensor    # (B, N) bool

    @property
    def dim(self) -> int:
        return self.data.shape[-1]


def _from_numpy(a, dtype, device):
    # a copy: the arrays of another framework may be read-only views
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def keypoints_from_numpy(xy, scale, angle, score, mask,
                         device="cpu") -> Keypoints:
    """Port Keypoints from the arrays of a reference ``Keypoints``
    (``np.asarray`` of each field)."""
    f32 = torch.float32
    return Keypoints(xy=_from_numpy(xy, f32, device),
                     scale=_from_numpy(scale, f32, device),
                     angle=_from_numpy(angle, f32, device),
                     score=_from_numpy(score, f32, device),
                     mask=_from_numpy(mask, torch.bool, device))


def descriptors_from_numpy(data, mask, device="cpu") -> Descriptors:
    """Port Descriptors from the arrays of a reference ``Descriptors``."""
    return Descriptors(data=_from_numpy(data, torch.float32, device),
                       mask=_from_numpy(mask, torch.bool, device))


def pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0):
    """Pad numpy array along `axis` up to length n."""
    pad = n - x.shape[axis]
    if pad < 0:
        raise ValueError(f"cannot pad: {x.shape[axis]} > {n}")
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
