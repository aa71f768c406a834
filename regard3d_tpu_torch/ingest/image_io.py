"""Image loading for the feature stage (host-side ingest).

Numpy copy of ``regard3d_tpu/ingest/image_io.py`` (the port imports nothing
from the reference package).

Replaces the reference's per-worker ``cv::imread`` + gray conversion
(``src/threads/R3DFeaturesThread.cpp:162-195``) with PIL + NumPy, and adds
the batching contract the batched detector needs: images are grouped into
same-shape **buckets** (padded to multiples of the scale-space downsampling
factor) so each bucket runs as one batched call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

# BT.601 luma — cv::cvtColor BGR2GRAY parity
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def load_gray(path: str, max_dim: int = 0) -> np.ndarray:
    """Load an image as float32 gray in [0, 1]; optionally cap max dim."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        if max_dim and max(im.size) > max_dim:
            scale = max_dim / max(im.size)
            im = im.resize((max(1, round(im.width * scale)),
                            max(1, round(im.height * scale))),
                           Image.BILINEAR)
        arr = np.asarray(im, np.float32) / 255.0
    return arr @ _LUMA


def load_rgb(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def pad_to_grid(img: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Edge-pad so H and W are divisible by `multiple` (scale-space needs
    2**(omax-1) divisibility)."""
    h, w = img.shape
    H = ((h + multiple - 1) // multiple) * multiple
    W = ((w + multiple - 1) // multiple) * multiple
    if (H, W) == (h, w):
        return img
    return np.pad(img, ((0, H - h), (0, W - w)), mode="edge")


@dataclasses.dataclass
class ImageBucket:
    """A batch of same-padded-shape images."""
    data: np.ndarray          # (B, H, W) float32
    indices: List[int]        # original image indices
    true_sizes: np.ndarray    # (B, 2) width, height before padding


def bucket_images(images: Sequence[np.ndarray], multiple: int = 8,
                  max_batch: int = 8) -> List[ImageBucket]:
    """Group images by padded shape into fixed batches (static shapes for
    the detector; one batched detector call per bucket)."""
    by_shape: Dict[Tuple[int, int], List[int]] = {}
    padded = []
    for i, img in enumerate(images):
        p = pad_to_grid(img, multiple)
        padded.append(p)
        by_shape.setdefault(p.shape, []).append(i)

    buckets = []
    for shape, idxs in sorted(by_shape.items()):
        for start in range(0, len(idxs), max_batch):
            chunk = idxs[start:start + max_batch]
            data = np.stack([padded[i] for i in chunk])
            sizes = np.asarray([[images[i].shape[1], images[i].shape[0]]
                                for i in chunk], np.int32)
            buckets.append(ImageBucket(data, chunk, sizes))
    return buckets
