"""ctypes binding to the repository's host library (``native/r3d_native.cpp``).

Counterpart of ``regard3d_tpu/native.py``: the MSER and TBMR component-tree
detectors (host C++ in the reference too), the ``.feat`` text parser and
the union-find of connected components. The source is compiled with g++ at first use,
with the reference's flags (``-O3 -fPIC -shared -std=c++17``, no
``-march=native``, so float results are the same bits on any x86-64 host),
into :func:`runtime.kernel_build_dir` by ``kernels/_build.compile_library``
(a name that hashes the source and the flags; written to a temporary name,
then renamed). The JAX package's own build product under ``native/`` is
never read or written.

There is no NumPy stand-in: a failed build raises with g++'s output, and a
failed call raises (the reference returns ``None``). The port's
``sfm/tracks.py`` keeps its own array labelling of components; it gives
the same components as :func:`union_find`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.kernels import _build

SOURCE = os.path.join(runtime.repo_root(), "native", "r3d_native.cpp")
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)


def build() -> str:
    """Compile the source unless its library exists; returns its path.
    Raises with the compiler's output if g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's MSER, TBMR and .feat "
                           "parser are built from native/r3d_native.cpp")
    return _build.compile_library(gxx, GXX_FLAGS, SOURCE)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.r3d_union_find.restype = ctypes.c_int64
            lib.r3d_union_find.argtypes = [_i64p, ctypes.c_int64,
                                           ctypes.c_int64, _i64p]
            lib.r3d_parse_feats.restype = ctypes.c_int64
            lib.r3d_parse_feats.argtypes = [ctypes.c_char_p, _f32p,
                                            ctypes.c_int64]
            lib.r3d_mser.restype = ctypes.c_int64
            lib.r3d_mser.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.c_double, _f32p, ctypes.c_int64]
            lib.r3d_tbmr.restype = ctypes.c_int64
            lib.r3d_tbmr.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, _f32p, ctypes.c_int64]
            _lib = lib
        return _lib


def _checked(n: int, what: str) -> int:
    if n < 0:
        raise RuntimeError(f"native {what} failed (allocation or I/O)")
    return n


def union_find(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Connected-component labels of ``num_nodes`` nodes joined by an
    (E, 2) edge list: (num_nodes,) int64, components numbered 0..k-1 in
    order of their first node. Edges with an end outside [0, num_nodes)
    are ignored."""
    edges = np.ascontiguousarray(edges, np.int64).reshape(-1, 2)
    labels = np.empty(num_nodes, np.int64)
    _checked(get_lib().r3d_union_find(
        edges.ctypes.data_as(_i64p), len(edges), num_nodes,
        labels.ctypes.data_as(_i64p)), "union_find")
    return labels


def mser(img_u8: np.ndarray, delta: int = 5, min_area: int = 60,
         max_area: int = 14400, max_variation: float = 0.25,
         min_diversity: float = 0.2, max_out: int = 1 << 16) -> np.ndarray:
    """MSER keypoints over both polarities (cv::MSER::create() defaults).
    img_u8: (H, W) uint8. Returns (N, 4) float32 rows
    (cx, cy, kp_size, area)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w = img_u8.shape
    out = np.empty((max_out, 4), np.float32)
    n = _checked(get_lib().r3d_mser(
        img_u8.ctypes.data_as(_u8p), w, h, delta, min_area, max_area,
        max_variation, min_diversity, out.ctypes.data_as(_f32p), max_out),
        "mser")
    return out[:n].copy()


def _tbmr_one(lib, img_u8, minimum_size, maximum_relative_area, max_out):
    h, w = img_u8.shape
    out = np.empty((max_out, 6), np.float32)
    n = _checked(lib.r3d_tbmr(
        img_u8.ctypes.data_as(_u8p), w, h, minimum_size,
        maximum_relative_area, out.ctypes.data_as(_f32p), max_out), "tbmr")
    return out[:n].copy()


def tbmr(img_u8: np.ndarray, minimum_size: int = 30,
         maximum_relative_area: float = 0.01, both_polarities: bool = True,
         max_out: int = 1 << 16) -> np.ndarray:
    """TBMR affine regions (OpenMVG Extract_tbmr defaults), the bright tree
    and then, with ``both_polarities``, the tree of the inverted image.
    img_u8: (H, W) uint8. Returns (N, 6) float32 rows
    (x, y, l1, l2, orientation_rad, area)."""
    lib = get_lib()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    rows = [_tbmr_one(lib, img_u8, minimum_size, maximum_relative_area,
                      max_out)]
    if both_polarities:
        rows.append(_tbmr_one(lib, np.ascontiguousarray(255 - img_u8),
                              minimum_size, maximum_relative_area, max_out))
    return np.concatenate(rows, 0)


def parse_feats(path: str, max_rows: int = 1 << 20) -> np.ndarray:
    """Parse a ``.feat`` text file -> (N, 4) float32; raises if the file
    cannot be read."""
    out = np.empty((max_rows, 4), np.float32)
    n = _checked(get_lib().r3d_parse_feats(
        os.fsencode(path), out.ctypes.data_as(_f32p), max_rows),
        f"parse_feats({path!r})")
    return out[:n].copy()
