"""TF32 arithmetic for the controls, on any device.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits: the tensor
cores round both operands of a product to it and accumulate in float32.
``emulate()`` does the same to every float32 matrix product, ``einsum`` and
2-D convolution made inside it (operands rounded to nearest even, the
product in float32), so a control reads the same on the card and on the
CPU and cannot fall back to full float32 where a library would choose a
kernel without tensor cores.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def round_tf32(x):
    """``x`` rounded to TF32 (float32 tensors only; others pass through)."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    out = b.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _wrap(fn):
    def op(*args, **kwargs):
        return fn(*[round_tf32(a) if torch.is_tensor(a) else
                    [round_tf32(t) for t in a] if isinstance(a, (list, tuple))
                    and a and torch.is_tensor(a[0]) else a for a in args],
                  **kwargs)
    return op


_SITES = ((torch, "matmul"), (torch, "mm"), (torch, "bmm"), (torch, "einsum"),
          (torch.Tensor, "__matmul__"), (torch.Tensor, "matmul"),
          (torch.Tensor, "__rmatmul__"), (F, "conv2d"))


@contextlib.contextmanager
def emulate():
    saved = [(obj, name, getattr(obj, name)) for obj, name in _SITES]
    try:
        for obj, name, fn in saved:
            setattr(obj, name, _wrap(fn))
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
