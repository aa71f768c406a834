"""Feature-extraction stage driver (AKAZE / Fast-AKAZE + LIOP).

Counterpart of ``regard3d_tpu/pipeline/features.py`` for the two shipped
detectors: images are bucketed by padded shape and each bucket runs
detection + description as one batched call on the stage's device.

Artifact contract per image (byte-compatible with the reference, both ways):
* ``imageXXXXXX.feat`` — text, one keypoint per line: ``x y scale
  orientation`` (OpenMVG SIOPointFeature format);
* ``imageXXXXXX.desc`` — binary: uint64 count + float32[count, 144];
* existing files are reused unless ``force`` (resume semantics).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.core.types import Descriptors, Keypoints
from regard3d_tpu_torch.ingest import image_io
from regard3d_tpu_torch.kernels import detect, liop
from regard3d_tpu_torch.kernels.scale_space import ScaleSpaceConfig

LIOP_DIM = liop.LIOP_DIM

# GUI presets (src/gui/Regard3DComputeMatchesDialog.cpp:96-128)
SENSITIVITY_PRESETS = {
    "minimal": 0.001, "normal": 0.0007, "high": 0.0005, "ultra": 0.0001,
}

DETECTORS = ("akaze", "fast-akaze")
_DETECTOR_ALIASES = {
    "classic-a-kaze": "akaze", "classic-akaze": "akaze",
    "fast-a-kaze": "fast-akaze", "fastakaze": "fast-akaze",
}
_FACTOR_KEYS = {"akaze": "AKAZE", "fast-akaze": "Fast-AKAZE"}


def canonical_detector(name: str) -> str:
    n = name.strip().lower().replace("_", "-").replace(" ", "-")
    n = _DETECTOR_ALIASES.get(n, n)
    if n not in DETECTORS:
        raise ValueError(f"unknown or not yet ported detector {name!r}; "
                         f"choose from {DETECTORS}")
    return n


def detector_kp_size_factor(detector: str) -> float:
    return liop.KP_SIZE_FACTORS[_FACTOR_KEYS[canonical_detector(detector)]]


def feat_path(out_dir: str, index: int) -> str:
    return os.path.join(out_dir, f"image{index:06d}.feat")


def desc_path(out_dir: str, index: int) -> str:
    return os.path.join(out_dir, f"image{index:06d}.desc")


def save_features(out_dir: str, index: int, xy: np.ndarray, scale: np.ndarray,
                  angle: np.ndarray, desc: np.ndarray):
    with open(feat_path(out_dir, index), "w") as f:
        for k in range(len(xy)):
            f.write(f"{xy[k,0]:.6g} {xy[k,1]:.6g} {scale[k]:.6g} "
                    f"{angle[k]:.6g}\n")
    with open(desc_path(out_dir, index), "wb") as f:
        f.write(struct.pack("<Q", len(desc)))
        f.write(np.ascontiguousarray(desc[:, :LIOP_DIM],
                                     np.float32).tobytes())


def load_features(out_dir: str, index: int) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray, np.ndarray]:
    """Returns (xy (N,2), scale (N,), angle (N,), desc (N,144))."""
    feats = np.loadtxt(feat_path(out_dir, index), ndmin=2, dtype=np.float32)
    if feats.size == 0:
        feats = np.zeros((0, 4), np.float32)
    with open(desc_path(out_dir, index), "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        desc = np.frombuffer(f.read(n * LIOP_DIM * 4), np.float32)
        desc = desc.reshape(n, LIOP_DIM).copy()
    return feats[:, :2], feats[:, 2], feats[:, 3], desc


def has_features(out_dir: str, index: int) -> bool:
    return (os.path.exists(feat_path(out_dir, index))
            and os.path.exists(desc_path(out_dir, index)))


def load_counts(out_dir: str, num_images: int) -> List[int]:
    """Keypoint counts from the .desc headers (cheap, no payload read)."""
    out = []
    for i in range(num_images):
        with open(desc_path(out_dir, i), "rb") as f:
            out.append(int(struct.unpack("<Q", f.read(8))[0]))
    return out


def extract_features(images: Sequence[np.ndarray], out_dir: str,
                     threshold: float = 0.0007,
                     max_keypoints: int = 4096,
                     kp_size_factor: Optional[float] = None,
                     force: bool = False,
                     detector: str = "fast-akaze",
                     progress=None,
                     subset: Optional[Sequence[int]] = None,
                     device=None) -> List[int]:
    """Detect + describe every image; write artifacts; return keypoint
    counts. Cached images are skipped (resume semantics). ``subset``: only
    these image indices are processed/counted. Runs on ``device``
    (default cuda)."""
    dev = runtime.resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    detector = canonical_detector(detector)
    if kp_size_factor is None:
        kp_size_factor = detector_kp_size_factor(detector)
    my_images = range(len(images)) if subset is None else subset
    todo = [i for i in my_images if force or not has_features(out_dir, i)]
    counts = [0] * len(images)

    cfg = ScaleSpaceConfig(dthreshold=threshold)
    done = 0
    for b in (image_io.bucket_images([images[i] for i in todo])
              if todo else []):
        with torch.no_grad():
            data = torch.as_tensor(b.data, dtype=torch.float32, device=dev)
            sizes = torch.as_tensor(b.true_sizes, device=dev)
            # both GUI entries share the scale-space detector (only the
            # threshold differs in the reference)
            kps = detect.detect_akaze(data, sizes[:, 0], sizes[:, 1], cfg,
                                      max_keypoints)
            descs = liop.describe_liop(data, kps, kp_size_factor)
        m_all = kps.mask.cpu().numpy()
        xy = kps.xy.cpu().numpy()
        sc = kps.scale.cpu().numpy()
        an = kps.angle.cpu().numpy()
        d_np = descs.data.cpu().numpy()
        for bi, orig_local in enumerate(b.indices):
            img_index = todo[orig_local]
            m = m_all[bi]
            save_features(out_dir, img_index, xy[bi][m], sc[bi][m], an[bi][m],
                          d_np[bi][m])
            done += 1
            if progress:
                progress(done, len(todo))

    for i in my_images:
        with open(desc_path(out_dir, i), "rb") as f:
            counts[i] = int(struct.unpack("<Q", f.read(8))[0])
    return counts


def load_all_padded(out_dir: str, num_images: int, pad_to: int = 0,
                    padded_dim: int = liop.PADDED_DIM, device=None):
    """Load every image's features into padded tensors on ``device``
    (default cuda). Returns (Keypoints, Descriptors) with batch=num_images."""
    device = runtime.resolve_device(device)
    counts = np.zeros(num_images, np.int64)
    for i in range(num_images):
        with open(desc_path(out_dir, i), "rb") as f:
            counts[i] = struct.unpack("<Q", f.read(8))[0]
    n_max = max(int(counts.max()) if num_images else 1, 1)
    if pad_to:
        n_max = ((n_max + pad_to - 1) // pad_to) * pad_to
    B = num_images
    xy = np.zeros((B, n_max, 2), np.float32)
    scale = np.zeros((B, n_max), np.float32)
    angle = np.zeros((B, n_max), np.float32)
    desc = np.zeros((B, n_max, padded_dim), np.float32)
    mask = np.zeros((B, n_max), bool)
    for i in range(num_images):
        p, s, a, d = load_features(out_dir, i)
        n = len(p)
        xy[i, :n] = p
        scale[i, :n] = s
        angle[i, :n] = a
        desc[i, :n, :LIOP_DIM] = d
        mask[i, :n] = True
    t = lambda a: torch.as_tensor(a, device=device)
    kps = Keypoints(xy=t(xy), scale=t(scale), angle=t(angle),
                    score=torch.zeros((B, n_max), dtype=torch.float32,
                                      device=device),
                    mask=t(mask))
    return kps, Descriptors(data=t(desc), mask=t(mask))
