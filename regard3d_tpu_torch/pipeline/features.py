"""Feature-extraction stage driver: the detector menu + LIOP.

Counterpart of ``regard3d_tpu/pipeline/features.py``: images are bucketed
by padded shape and each bucket runs detection + description as one
batched call on the stage's device. The device detectors (AKAZE,
Fast-AKAZE, GFTT, ORB, BRISK) detect on the device; the host detectors
(MSER, TBMR) run the native component-tree library image by image and
their keypoints are described on the device with the same LIOP call.

Artifact contract per image (byte-compatible with the reference, both ways):
* ``imageXXXXXX.feat`` — text, one keypoint per line: ``x y scale
  orientation`` (OpenMVG SIOPointFeature format);
* ``imageXXXXXX.desc`` — binary: uint64 count + float32[count, 144];
* existing files are reused unless ``force`` (resume semantics).

With a mesh (axis ``images``), the buckets go round-robin over its devices,
one thread per device: every image is still detected in the batch it has
without a mesh, so the artifacts are the same bytes (a convolution's
algorithm may depend on the batch on the card).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import native, runtime, spans
from regard3d_tpu_torch.core.types import Descriptors, Keypoints
from regard3d_tpu_torch.dist import mesh as meshlib
from regard3d_tpu_torch.ingest import image_io
from regard3d_tpu_torch.kernels import corners, detect, liop
from regard3d_tpu_torch.kernels.scale_space import ScaleSpaceConfig

LIOP_DIM = liop.LIOP_DIM

# GUI presets (src/gui/Regard3DComputeMatchesDialog.cpp:96-128)
SENSITIVITY_PRESETS = {
    "minimal": 0.001, "normal": 0.0007, "high": 0.0005, "ultra": 0.0001,
}

# Detector menu (Regard3DFeatures::detectKeypoints dispatch,
# src/Regard3DFeatures.cpp:574-683). "akaze"/"fast-akaze" are the shipped
# GUI entries; the rest are the experimental paths behind the same dispatch.
DEVICE_DETECTORS = ("akaze", "fast-akaze", "gftt", "orb", "brisk")
HOST_DETECTORS = ("mser", "tbmr")
DETECTORS = DEVICE_DETECTORS + HOST_DETECTORS

_DETECTOR_ALIASES = {
    "classic-a-kaze": "akaze", "classic-akaze": "akaze",
    "fast-a-kaze": "fast-akaze", "fastakaze": "fast-akaze",
}
# kpSizeFactor table keys (src/Regard3DFeatures.cpp:691-717)
_FACTOR_KEYS = {"akaze": "AKAZE", "fast-akaze": "Fast-AKAZE", "mser": "MSER",
                "orb": "ORB", "brisk": "BRISK", "gftt": "GFTT",
                "tbmr": "TBMR"}


def canonical_detector(name: str) -> str:
    n = name.strip().lower().replace("_", "-").replace(" ", "-")
    n = _DETECTOR_ALIASES.get(n, n)
    if n not in DETECTORS:
        raise ValueError(f"unknown detector {name!r}; choose from {DETECTORS}")
    return n


def detector_kp_size_factor(detector: str) -> float:
    return liop.KP_SIZE_FACTORS[_FACTOR_KEYS[canonical_detector(detector)]]


def _detect_host(img: np.ndarray, detector: str,
                 max_keypoints: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]:
    """MSER / TBMR via the native component-tree library. img: (H, W) float
    in [0, 1]. Returns (xy, size, angle, score) numpy arrays, at most
    ``max_keypoints`` rows (the highest scores: region areas)."""
    g8 = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if detector == "mser":
        rows = native.mser(g8)
        xy = rows[:, :2]
        size = rows[:, 2]
        angle = np.full(len(rows), corners.CV_UNDEFINED_ANGLE, np.float32)
        score = rows[:, 3]
    else:  # tbmr
        rows = native.tbmr(g8)
        xy = rows[:, :2]
        # keypoint size = sqrt(l1^2 + l2^2) (src/Regard3DFeatures.cpp:633-637)
        size = np.sqrt(rows[:, 2] ** 2 + rows[:, 3] ** 2)
        angle = rows[:, 4] - np.pi / 2.0     # cv angle -> internal convention
        score = rows[:, 5]
    if len(xy) > max_keypoints:
        order = np.argsort(-score)[:max_keypoints]
        xy, size, angle, score = xy[order], size[order], angle[order], \
            score[order]
    return (xy.astype(np.float32), size.astype(np.float32),
            angle.astype(np.float32), score.astype(np.float32))


def _detect_device(data, widths, heights, detector: str,
                   cfg: ScaleSpaceConfig, max_keypoints: int) -> Keypoints:
    if detector in ("akaze", "fast-akaze"):
        # both GUI entries share the scale-space detector (only the
        # threshold differs in the reference)
        return detect.detect_akaze(data, widths, heights, cfg, max_keypoints)
    fn = {"gftt": corners.detect_gftt, "orb": corners.detect_orb,
          "brisk": corners.detect_brisk}[detector]
    return fn(data, widths, heights, max_keypoints)


def _detect_host_bucket(b, detector: str, max_keypoints: int,
                        dev) -> Keypoints:
    """Host detection over a bucket's images into padded keypoints on
    ``dev`` (capacity ``max_keypoints``)."""
    B, K = b.data.shape[0], max_keypoints
    xy = np.zeros((B, K, 2), np.float32)
    size = np.zeros((B, K), np.float32)
    angle = np.zeros((B, K), np.float32)
    mask = np.zeros((B, K), bool)
    for bi in range(B):
        w, h = b.true_sizes[bi]
        p, s, a, _ = _detect_host(b.data[bi, :h, :w], detector, K)
        n = len(p)
        xy[bi, :n] = p
        size[bi, :n] = s
        angle[bi, :n] = a
        mask[bi, :n] = True
    t = lambda a: torch.as_tensor(a, device=dev)
    return Keypoints(xy=t(xy), scale=t(size), angle=t(angle),
                     score=torch.zeros((B, K), dtype=torch.float32,
                                       device=dev), mask=t(mask))


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
    """Returns (xy (N,2), scale (N,), angle (N,), desc (N,144)); the
    ``.feat`` text goes through the native parser (``np.loadtxt`` gives the
    same rows)."""
    feats = native.parse_feats(feat_path(out_dir, index))
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


def image_buckets(images: Sequence[np.ndarray]) -> List[List[int]]:
    """The image indices of each detector batch, in the order
    ``extract_features`` runs them."""
    return [list(b.indices) for b in image_io.bucket_images(images)]


def _bucket_features(b, detector, cfg, max_keypoints, kp_size_factor, dev):
    """One bucket's keypoints and descriptors, as numpy arrays. Spans
    (under the caller's): ``.upload``, ``.detect``, ``.describe`` and
    ``.readback`` (the host waiting on the device)."""
    with torch.no_grad():
        with spans.span(".upload"):
            data = torch.as_tensor(b.data, dtype=torch.float32, device=dev)
            sizes = (None if detector in HOST_DETECTORS
                     else torch.as_tensor(b.true_sizes, device=dev))
        with spans.span(".detect"):
            if detector in HOST_DETECTORS:
                kps = _detect_host_bucket(b, detector, max_keypoints, dev)
            else:
                kps = _detect_device(data, sizes[:, 0], sizes[:, 1],
                                     detector, cfg, max_keypoints)
        with spans.span(".describe"):
            descs = liop.describe_liop(data, kps, kp_size_factor)
    with spans.span(".readback"):
        return (kps.mask.cpu().numpy(), kps.xy.cpu().numpy(),
                kps.scale.cpu().numpy(), kps.angle.cpu().numpy(),
                descs.data.cpu().numpy())


def extract_features(images: Sequence[np.ndarray], out_dir: str,
                     threshold: float = 0.0007,
                     max_keypoints: int = 4096,
                     kp_size_factor: Optional[float] = None,
                     force: bool = False,
                     detector: str = "fast-akaze",
                     progress=None,
                     subset: Optional[Sequence[int]] = None,
                     device=None, mesh=None) -> List[int]:
    """Detect + describe every image; write artifacts; return keypoint
    counts. Cached images are skipped (resume semantics). ``subset``: only
    these image indices are processed/counted (a process's share of a
    multi-process run: whole buckets of ``image_buckets``). Runs on
    ``device`` (default cuda), or round-robin over the devices of ``mesh``
    by bucket."""
    dev = runtime.resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    detector = canonical_detector(detector)
    if kp_size_factor is None:
        kp_size_factor = detector_kp_size_factor(detector)
    my_images = range(len(images)) if subset is None else subset
    todo = [i for i in my_images if force or not has_features(out_dir, i)]
    counts = [0] * len(images)

    cfg = ScaleSpaceConfig(dthreshold=threshold)
    with spans.span(".upload"):       # the buckets' stacked arrays
        buckets = (image_io.bucket_images([images[i] for i in todo])
                   if todo else [])
    run = lambda b, d: _bucket_features(b, detector, cfg, max_keypoints,
                                        kp_size_factor, d)
    results = (meshlib.run_on_mesh(run, buckets, mesh) if mesh is not None
               else (run(b, dev) for b in buckets))
    done = 0
    for b, (m_all, xy, sc, an, d_np) in zip(buckets, results):
        with spans.span(".write"):
            for bi, orig_local in enumerate(b.indices):
                img_index = todo[orig_local]
                m = m_all[bi]
                save_features(out_dir, img_index, xy[bi][m], sc[bi][m],
                              an[bi][m], d_np[bi][m])
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
