"""Device selection, numeric settings and the kernel build directory.

The reference pins f32 matmuls to "highest" precision (its runtime.setup and
test conftest): the RANSAC normal equations and the matcher's f32 preset
must not silently drop to TF32. On the card both PyTorch switches are
needed: cuBLAS matmuls and cuDNN convolutions (cuDNN defaults to TF32).

Entry points resolve their device with :func:`resolve_device`: ``cuda``
unless the caller asks for the CPU. With no card and no explicit CPU
request they raise instead of running on the CPU quietly.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


set_precision()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as given, else ``cuda``; raises if cuda is asked for (or
    implied) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "regard3d_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_build_dir(create: bool = True) -> str:
    """Where the CUDA sources are compiled to (listed in .gitignore).
    ``R3D_TORCH_BUILD_DIR`` overrides the default ``<repo>/build/torch_kernels``."""
    path = os.environ.get("R3D_TORCH_BUILD_DIR") or os.path.join(
        repo_root(), "build", "torch_kernels")
    if create:
        os.makedirs(path, exist_ok=True)
    return path
