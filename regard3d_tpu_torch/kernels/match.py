"""Descriptor matching — fused L2 distances + running top-2 + ratio test.

Counterpart of ``regard3d_tpu/kernels/match.py``. The reference's two Pallas
TPU kernels (``l2_top2_block_pallas`` for a block of pairs, ``l2_top2_pallas``
for one pair) are served by one hand-written CUDA kernel,
``csrc/match_top2.cu``, built with nvcc at first use and called through a
plain C interface. Beside it, :func:`l2_top2_block_plain` computes the same
function the way the reference's CPU path does (``sqdist`` + masked top-2 by
argmin-then-mask): the CPU tests use it and ``chip_smoke.py`` holds the
kernel against it on the card.

The wrappers pick by tensor device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises); there is no fallback.

Matching contract (OpenMVG ``DistanceRatioMatch``): for each query
descriptor a in image I, find its two nearest neighbours in image J under
squared L2; keep (a, nn1) iff d1 < ratio^2 * d2. Ties go to the lowest index.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

_BIG = float(3.0e38)
_SOURCE = "match_top2.cu"

# launches of the CUDA kernel, per wrapper and input dtype (plain integers;
# reset by callers that want to show a run went through the kernel)
LAUNCHES: Dict[str, int] = {f"{w}_{t}": 0
                            for w in ("l2_top2_block", "l2_top2")
                            for t in ("f32", "bf16")}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version — the oracle and the CPU path
# ---------------------------------------------------------------------------

def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix. a: (..., M, D), b: (..., N, D) -> (..., M, N)."""
    aa = torch.sum(a * a, -1, keepdim=True)
    bb = torch.sum(b * b, -1).unsqueeze(-2)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp_min(aa + bb - 2.0 * ab, 0.0)


def top2_ref(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row two smallest distances and the argmin. d: (..., M, N).
    Returns (vals (..., M, 2), idx1 (..., M)). Argmin-then-mask: the lowest
    index wins ties, and an equal second value gives d2 == d1 (the
    semantics of ``lax.top_k`` on the negated row)."""
    i1 = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, i1.unsqueeze(-1))[..., 0]
    masked = d.scatter(-1, i1.unsqueeze(-1), _BIG)
    d2 = torch.min(masked, dim=-1).values
    return torch.stack([d1, d2], -1), i1


def match_pair_ref(desc_a, mask_a, desc_b, mask_b, ratio: float = 0.8):
    """Oracle matcher. Returns (idx (M,), d1 (M,), valid (M,))."""
    d = sqdist(desc_a.float(), desc_b.float())
    d = torch.where(mask_b[None, :], d, _BIG)
    vals, idx1 = top2_ref(d)
    d1, d2 = vals[:, 0], vals[:, 1]
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < _BIG)
    return idx1, d1, ok


_PLAIN_CHUNK = 1 << 28      # distances per chunk of the plain block version


def l2_top2_block_plain(desc, mask, pairs):
    """Plain version of the block kernel. desc: (B, N, D) f32 or bf16;
    mask: (B, N) bool; pairs: (P, 2) int. Returns (d1, i1, d2), each (P, N).
    Pairs are processed in chunks so the (chunk, N, N) distance tensor stays
    bounded (about ``_PLAIN_CHUNK`` distances a chunk)."""
    pairs = pairs.to(desc.device, torch.long)
    P, N = pairs.shape[0], desc.shape[1]
    chunk = max(1, _PLAIN_CHUNK // max(N * N, 1))
    outs = []
    for s in range(0, P, chunk):
        pr = pairs[s:s + chunk]
        d = sqdist(desc[pr[:, 0]].float(), desc[pr[:, 1]].float())
        d = torch.where(mask[pr[:, 1]][:, None, :], d, _BIG)
        vals, i1 = top2_ref(d)
        outs.append((vals[..., 0], i1.to(torch.int32), vals[..., 1]))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def l2_top2_plain(desc_a, desc_b, mask_b):
    """Plain version of the single-pair kernel: (M, D) x (N, D) with mask_b
    (N,). Returns (d1, i1, d2), each (M,)."""
    d = sqdist(desc_a.float(), desc_b.float())
    d = torch.where(mask_b[None, :], d, _BIG)
    vals, i1 = top2_ref(d)
    return vals[:, 0], i1.to(torch.int32), vals[:, 1]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    from regard3d_tpu_torch.kernels import _build
    lib = _build.load_library(_SOURCE)
    fn = lib.r3d_l2_top2
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
    return fn


def _check_desc(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B, N, D) tensor")
    if t.shape[2] % 16 or t.shape[2] == 0:
        raise ValueError(f"{name}: D={t.shape[2]} must be a multiple of 16")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(desc_a, desc_b, bnorm, pairs):
    """One kernel launch: rows of desc_a[pairs[:, 0]] against
    desc_b[pairs[:, 1]]. Returns (d1, i1, d2), each (P, M)."""
    _check_desc("desc_a", desc_a)
    _check_desc("desc_b", desc_b)
    if desc_a.dtype != desc_b.dtype or desc_a.device != desc_b.device:
        raise ValueError("desc_a and desc_b must share dtype and device")
    if desc_a.shape[2] != desc_b.shape[2]:
        raise ValueError("descriptor widths differ")
    dev = desc_a.device
    Ba, M, D = desc_a.shape
    Bb, N, _ = desc_b.shape
    pairs_h = pairs.detach().to("cpu", torch.int32).contiguous()
    if pairs_h.dim() != 2 or pairs_h.shape[1] != 2 or pairs_h.shape[0] == 0:
        raise ValueError("pairs must be a non-empty (P, 2) table")
    if (pairs_h.min() < 0 or pairs_h[:, 0].max() >= Ba
            or pairs_h[:, 1].max() >= Bb):
        raise IndexError("pair index out of range")
    if bnorm.shape != (Bb, N) or bnorm.dtype != torch.float32 \
            or bnorm.device != dev or not bnorm.is_contiguous():
        raise ValueError("bnorm must be a contiguous (B, N) float32 tensor "
                         "on the descriptors' device")
    P = pairs_h.shape[0]
    pairs_d = pairs_h.to(dev)
    d1 = torch.empty((P, M), dtype=torch.float32, device=dev)
    i1 = torch.empty((P, M), dtype=torch.int32, device=dev)
    d2 = torch.empty((P, M), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(0 if desc_a.dtype == torch.float32 else 1,
                 desc_a.data_ptr(), desc_b.data_ptr(), bnorm.data_ptr(),
                 pairs_d.data_ptr(), P, M, N, D,
                 d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"l2_top2 CUDA kernel launch failed (cudaError {err})")
    return d1, i1, d2


def _bnorm(desc, mask):
    """|b|^2 per row with 3e38 on masked rows (from the values the kernel
    sees, i.e. after any bf16 rounding)."""
    return torch.where(mask, torch.sum(desc.float() ** 2, -1),
                       _BIG).contiguous()


def l2_top2_block(desc, mask, pairs):
    """Fused two-NN search for a BLOCK of pairs (K1). desc: (B, N, D) f32 or
    bf16; mask: (B, N) bool; pairs: (P, 2) int. Returns (d1, i1, d2), each
    (P, N). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if not desc.is_cuda:
        return l2_top2_block_plain(desc, mask, pairs)
    out = _launch(desc, desc, _bnorm(desc, mask), pairs)
    LAUNCHES[f"l2_top2_block_{_DTYPE_TAG[desc.dtype]}"] += 1
    return out


def l2_top2(desc_a, desc_b, mask_b):
    """Fused two-NN search for one pair (K2): desc_a (M, D), desc_b (N, D),
    mask_b (N,). Returns (d1, i1, d2), each (M,)."""
    if not desc_a.is_cuda:
        return l2_top2_plain(desc_a, desc_b, mask_b)
    pairs = torch.zeros((1, 2), dtype=torch.int32)
    d1, i1, d2 = _launch(desc_a[None].contiguous(), desc_b[None].contiguous(),
                         _bnorm(desc_b, mask_b)[None].contiguous(), pairs)
    LAUNCHES[f"l2_top2_{_DTYPE_TAG[desc_a.dtype]}"] += 1
    return d1[0], i1[0], d2[0]


# ---------------------------------------------------------------------------
# Matchers
# ---------------------------------------------------------------------------

def match_pair(desc_a, mask_a, desc_b, mask_b, ratio: float = 0.8,
               use_kernel: bool = True):
    """Ratio-test matcher for one image pair. Returns (idx (M,), d1 (M,),
    valid (M,)). ``use_kernel=False`` computes the reference's plain top-2."""
    if use_kernel:
        d1, i1, d2 = l2_top2(desc_a, desc_b, mask_b)
    else:
        d = sqdist(desc_a.float(), desc_b.float())
        d = torch.where(mask_b[None, :], d, _BIG)
        vals, i1 = top2_ref(d)
        d1, d2 = vals[:, 0], vals[:, 1]
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < 1e30)
    return i1, d1, ok


def mutual_filter(idx_ab, ok_ab, idx_ba, ok_ba):
    """Cross-check: keep a->b matches whose b maps back to a. Works on one
    pair (M,) or a block (P, M)."""
    idx_ab = idx_ab.long()
    back = torch.gather(idx_ba.long(), -1, idx_ab)
    ok_b = torch.gather(ok_ba, -1, idx_ab)
    rows = torch.arange(idx_ab.shape[-1], device=idx_ab.device)
    return ok_ab & ok_b & (back == rows)


def match_pair_block(desc, mask, pairs, ratio: float = 0.8,
                     use_kernel: bool = True, bf16: bool = False):
    """Match a block of image pairs in one dispatch. desc: (B, N, D) padded
    descriptors; mask: (B, N); pairs: (P, 2) int image indices.
    Returns (idx (P, N), d1, ok). ``bf16`` rounds the descriptors to bf16
    first (the fast presets; distances still accumulate in f32)."""
    pairs_l = pairs.to(desc.device, torch.long)
    ma = mask[pairs_l[:, 0]]
    if bf16:
        desc = desc.to(torch.bfloat16)
    if use_kernel:
        d1, i1, d2 = l2_top2_block(desc, mask, pairs)
    else:
        d1, i1, d2 = l2_top2_block_plain(desc, mask, pairs)
    ok = ma & (d1 < (ratio * ratio) * d2) & (d1 < 1e30)
    return i1, d1, ok
