"""Keypoint and descriptor containers of the frozen reference (frozen copy
of the two dataclasses of ``regard3d_tpu_torch/core/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Keypoints:
    xy: torch.Tensor      # (B, N, 2)
    scale: torch.Tensor   # (B, N) patch diameter
    angle: torch.Tensor   # (B, N) radians
    score: torch.Tensor   # (B, N) detector response
    mask: torch.Tensor    # (B, N) bool


@dataclasses.dataclass
class Descriptors:
    data: torch.Tensor    # (B, N, D)
    mask: torch.Tensor    # (B, N) bool
