"""Scene, keypoint and descriptor containers and small array helpers.

Counterpart of ``regard3d_tpu/core/types.py``: the reference's
``flax.struct`` pytrees become small dataclasses of tensors with the same
fields and layouts (struct-of-arrays with a leading capacity and a ``mask``
of live rows).

Conventions: pose world->camera, ``x_cam = R @ (X - C)``; intrinsics a
padded row ``[f, cx, cy, d0 .. d5]`` per group with a model code selecting
its meaning; observations a flat table, one row per (landmark, view).

The ``*_from_numpy`` converters take the arrays of the reference's values
(``np.asarray`` of each field), so both packages can start from one state.
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


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Views(_Replace):
    """Per-image metadata; row i is view id i."""

    width: torch.Tensor          # (V,) int32
    height: torch.Tensor         # (V,) int32
    intrinsic_id: torch.Tensor   # (V,) int32 — index into Intrinsics
    pose_id: torch.Tensor        # (V,) int32 — index into Poses
    mask: torch.Tensor           # (V,) bool — live view

    @property
    def capacity(self) -> int:
        return self.width.shape[0]


@dataclasses.dataclass
class Intrinsics(_Replace):
    """Shared-camera intrinsic groups."""

    model: torch.Tensor    # (K,) int32 — camera model code
    params: torch.Tensor   # (K, 9) float — [f, cx, cy, d0..d5]
    width: torch.Tensor    # (K,) int32
    height: torch.Tensor   # (K,) int32
    mask: torch.Tensor     # (K,) bool

    @property
    def capacity(self) -> int:
        return self.model.shape[0]


@dataclasses.dataclass
class Poses(_Replace):
    """World->camera extrinsics; row p is pose id p."""

    R: torch.Tensor      # (P, 3, 3) float — x_cam = R (X - C)
    C: torch.Tensor      # (P, 3) float — camera center in world frame
    mask: torch.Tensor   # (P,) bool — pose estimated

    @property
    def capacity(self) -> int:
        return self.R.shape[0]


@dataclasses.dataclass
class Observations(_Replace):
    """Flat observation table: one row per (landmark, view) measurement."""

    landmark_id: torch.Tensor  # (O,) int32
    view_id: torch.Tensor      # (O,) int32
    xy: torch.Tensor           # (O, 2) float — pixel coordinates
    feature_id: torch.Tensor   # (O,) int32 — index into the view's keypoints
    mask: torch.Tensor         # (O,) bool

    @property
    def capacity(self) -> int:
        return self.landmark_id.shape[0]


@dataclasses.dataclass
class Landmarks(_Replace):
    X: torch.Tensor      # (L, 3) float — world points
    color: torch.Tensor  # (L, 3) float — RGB in [0,1]
    mask: torch.Tensor   # (L,) bool

    @property
    def capacity(self) -> int:
        return self.X.shape[0]


_GROUPS = (("views", Views), ("intrinsics", Intrinsics), ("poses", Poses),
           ("landmarks", Landmarks), ("observations", Observations))


@dataclasses.dataclass
class Scene(_Replace):
    """Full reconstruction state (OpenMVG's ``SfM_Data`` role)."""

    views: Views
    intrinsics: Intrinsics
    poses: Poses
    landmarks: Landmarks
    observations: Observations

    @staticmethod
    def empty(num_views: int, num_intrinsics: int, num_landmarks: int,
              num_observations: int, dtype=torch.float32,
              device="cpu") -> "Scene":
        V, K, L, O = num_views, num_intrinsics, num_landmarks, num_observations
        i32 = dict(dtype=torch.int32, device=device)
        fl = dict(dtype=dtype, device=device)
        no = lambda n: torch.zeros((n,), dtype=torch.bool, device=device)
        return Scene(
            views=Views(width=torch.zeros((V,), **i32),
                        height=torch.zeros((V,), **i32),
                        intrinsic_id=torch.zeros((V,), **i32),
                        pose_id=torch.arange(V, **i32), mask=no(V)),
            intrinsics=Intrinsics(
                model=torch.full((K,), RADIAL_K3, **i32),
                params=torch.zeros((K, NUM_INTRINSIC_PARAMS), **fl),
                width=torch.zeros((K,), **i32),
                height=torch.zeros((K,), **i32), mask=no(K)),
            poses=Poses(R=torch.eye(3, **fl).expand(V, 3, 3).clone(),
                        C=torch.zeros((V, 3), **fl), mask=no(V)),
            landmarks=Landmarks(X=torch.zeros((L, 3), **fl),
                                color=torch.zeros((L, 3), **fl), mask=no(L)),
            observations=Observations(
                landmark_id=torch.zeros((O,), **i32),
                view_id=torch.zeros((O,), **i32),
                xy=torch.zeros((O, 2), **fl),
                feature_id=torch.zeros((O,), **i32), mask=no(O)),
        )

    def num_valid_views(self) -> int:
        return int(self.views.mask.sum())

    def num_calibrated(self) -> int:
        return int((self.poses.mask & self.views.mask).sum())

    def num_landmarks(self) -> int:
        return int(self.landmarks.mask.sum())


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


def scene_from_numpy(flat, device="cpu") -> Scene:
    """Port a Scene from ``{"<group>.<field>": array}`` (the layout of
    ``scene_to_numpy`` and of ``scene.npz`` in both packages)."""
    groups = {}
    for name, cls in _GROUPS:
        groups[name] = cls(**{
            f.name: torch.from_numpy(np.array(flat[f"{name}.{f.name}"]))
            .to(device) for f in dataclasses.fields(cls)})
    return Scene(**groups)


def sfm_inputs_from_numpy(xy, track_id, view_id, feature_id, num_tracks,
                          intr_id, intr, models, image_sizes, device="cpu",
                          dtype=torch.float32):
    """Port ``sfm.incremental.SfMInputs`` from the reference's arrays, the
    coordinates and intrinsics in ``dtype`` (float64: the f64 engines)."""
    from regard3d_tpu_torch.sfm.incremental import SfMInputs
    t = lambda a, dt: _from_numpy(a, dt, device)
    return SfMInputs(xy=t(xy, dtype),
                     track_id=t(track_id, torch.int64),
                     view_id=t(view_id, torch.int64),
                     feature_id=t(feature_id, torch.int64),
                     num_tracks=int(num_tracks),
                     intr_id=t(intr_id, torch.int64),
                     intr=t(intr, dtype),
                     models=t(models, torch.int64),
                     image_sizes=np.array(image_sizes))


def ba_state_from_numpy(R, C, intr, X, device="cpu", dtype=torch.float32):
    """Port ``ba.lm.BAState`` from the reference's arrays, in ``dtype``."""
    from regard3d_tpu_torch.ba.lm import BAState
    f = lambda a: _from_numpy(a, dtype, device)
    return BAState(R=f(R), C=f(C), intr=f(intr), X=f(X))


def ba_observations_from_numpy(view_id, intr_id, point_id, model, xy, weight,
                               device="cpu", dtype=torch.float32):
    """Port ``ba.lm.BAObservations`` from the reference's arrays, the
    coordinates and weights in ``dtype``."""
    from regard3d_tpu_torch.ba.lm import BAObservations
    i = lambda a: _from_numpy(a, torch.int64, device)
    f = lambda a: _from_numpy(a, dtype, device)
    return BAObservations(view_id=i(view_id), intr_id=i(intr_id),
                          point_id=i(point_id), model=i(model), xy=f(xy),
                          weight=f(weight))


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
