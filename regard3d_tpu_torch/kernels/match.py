"""Descriptor matching — fused L2 distances + running top-2 + ratio test.

Counterpart of ``regard3d_tpu/kernels/match.py``. The reference's two Pallas
TPU kernels (``l2_top2_block_pallas`` for a block of pairs, ``l2_top2_pallas``
for one pair) and the ablated kernel of its matcher profile
(``tools/profile_matcher.py:_ablated_block``) are served by one hand-written
CUDA source, ``csrc/match_top2.cu``, built with nvcc at first use and called
through a plain C interface: an f32 FFMA kernel and a bf16 tensor-core
kernel with three epilogue modes. A call with too few row tiles to fill the
card splits its columns over the ranks of a thread-block cluster, which
merge their partial top-2 in shared memory (``cluster_plan``); the
single-pair call (K2) has its own C entry, a fused prologue (|b|^2 under
the mask, the bf16 operands) and one such launch, so its wrapper issues no
torch work of its own. Beside them, the ``*_plain`` functions compute the
same functions the way the reference's CPU path does (``sqdist`` + masked
top-2 by argmin-then-mask): the CPU tests use them and ``chip_smoke.py``
holds the kernels against them on the card.

The wrappers pick by tensor device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises); there is no fallback.

``bf16=True`` has the Pallas kernels' meaning: the descriptors come in as
f32, ``|b|^2`` is summed from the f32 values, the operands of the product
are rounded to bf16 (products exact, f32 accumulation), and ``|a|^2`` is
taken from the rounded A rows. A bf16 tensor passed without the flag is
legal too: the kernel then sees values that were rounded already, and
``|b|^2`` comes from those.

Matching contract (OpenMVG ``DistanceRatioMatch``): for each query
descriptor a in image I, find its two nearest neighbours in image J under
squared L2; keep (a, nn1) iff d1 < ratio^2 * d2. Ties go to the lowest index.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Sequence, Tuple

import torch

from regard3d_tpu_torch.kernels import _build

_BIG = float(3.0e38)
_SOURCE = "match_top2.cu"

# the kernels' block tile: 128 rows of A by 128 columns (rows of B); the
# ablation ``mm_only`` reads the first column of every column tile
TILE_M = TILE_N = 128
# largest D of the bf16 kernel: with D set at run time its A tile and a
# two-stage ring of B tiles (three 128 x D bf16 tiles), their |b|^2, |a|^2
# and the cluster's partials fit in 227 KB of shared memory
MAX_BF16_DIM = 288
# most blocks of a cluster (the portable limit): the ranks a call's columns
# split over
MAX_RANKS = 8

ABLATIONS = ("mm_only", "min_only")
_MODE = {"full": 0, "mm_only": 1, "min_only": 2}

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_DESC_DTYPES = tuple(_DTYPE_TAG)


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


def _operands(desc, bf16: bool):
    """The values the product sees: f32, rounded to bf16 first if asked."""
    return desc.to(torch.bfloat16).float() if bf16 else desc.float()


def _top2_plain(a, b, bnorm, bf16):
    """(d1, i1, d2) over the last two dims: a (..., M, D), b (..., N, D),
    bnorm (..., N) = |b|^2 of the f32 values with 3e38 on masked rows."""
    ar, br = _operands(a, bf16), _operands(b, bf16)
    aa = torch.sum(ar * ar, -1, keepdim=True)
    d = torch.clamp_min(aa + bnorm.unsqueeze(-2) - 2.0 * (ar @ br.transpose(
        -1, -2)), 0.0)
    d = torch.where((bnorm < _BIG).unsqueeze(-2), d, _BIG)
    vals, i1 = top2_ref(d)
    return vals[..., 0], i1.to(torch.int32), vals[..., 1]


_PLAIN_CHUNK = 1 << 28      # distances per chunk of the plain block versions


def _pair_chunks(desc, pairs):
    """(pairs as long, chunk) so one chunk's (chunk, N, N) tensor holds
    about ``_PLAIN_CHUNK`` distances."""
    pairs = pairs.to(desc.device, torch.long)
    N = desc.shape[1]
    return pairs, max(1, _PLAIN_CHUNK // max(N * N, 1))


def l2_top2_block_plain(desc, mask, pairs, bf16: bool = False):
    """Plain version of the block kernel (K1). desc: (B, N, D) f32 or bf16;
    mask: (B, N) bool; pairs: (P, 2) int. Returns (d1, i1, d2), each (P, N).
    Pairs are processed in chunks so the (chunk, N, N) distance tensor stays
    bounded."""
    pairs, chunk = _pair_chunks(desc, pairs)
    bn = _bnorm(desc, mask)
    outs = [_top2_plain(desc[pr[:, 0]], desc[pr[:, 1]], bn[pr[:, 1]], bf16)
            for pr in pairs.split(chunk)]
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def l2_top2_plain(desc_a, desc_b, mask_b, bf16: bool = False):
    """Plain version of the single-pair kernel (K2): (M, D) x (N, D) with
    mask_b (N,). Returns (d1, i1, d2), each (M,)."""
    return _top2_plain(desc_a, desc_b, _bnorm(desc_b, mask_b), bf16)


def merge_top2(a, b):
    """The kernels' merge of two partial top-2 results over disjoint column
    sets, elementwise: a, b = (d1, i1, d2). The lower d1 wins, an exact tie
    goes to the lower column and leaves d2 == d1."""
    d1, i1, d2 = a
    od1, oi1, od2 = b
    take = (od1 < d1) | ((od1 == d1) & (oi1 < i1))
    return (torch.where(take, od1, d1), torch.where(take, oi1, i1),
            torch.where(take, torch.minimum(od2, d1),
                        torch.minimum(d2, od1)))


def l2_top2_ranks_plain(desc_a, desc_b, mask_b, ranks: int, bf16=False):
    """Plain version of the cluster path of the single-pair call: the
    columns in ``ranks`` contiguous ranges of whole ``TILE_N``-wide tiles
    (as ``cluster_plan`` cuts them), the top-2 of each range, merged in
    increasing range order by ``merge_top2``, |a|^2 added and clamped at 0
    at the end. Returns (d1, i1, d2), each (M,)."""
    ar, br = _operands(desc_a, bf16), _operands(desc_b, bf16)
    bn = _bnorm(desc_b, mask_b)
    d = torch.where(bn < _BIG, bn - 2.0 * (ar @ br.T), _BIG)
    per = _cdiv(_cdiv(d.shape[1], TILE_N), ranks) * TILE_N
    out = None
    for c0 in range(0, d.shape[1], per):
        vals, i1 = top2_ref(d[:, c0:c0 + per])
        part = (vals[:, 0], i1.to(torch.int32) + c0, vals[:, 1])
        out = part if out is None else merge_top2(out, part)
    an = torch.sum(ar * ar, -1)
    return (torch.clamp_min(out[0] + an, 0.0), out[1],
            torch.clamp_min(out[2] + an, 0.0))


def l2_top2_block_ablated_plain(desc, mask, pairs, mode: str,
                                tile_n: int = TILE_N):
    """Plain version of the ablated block kernel (K3, bf16 operands, f32
    accumulation, |b|^2 from the f32 values). ``mm_only``: per row, the min
    of a.b over the first column of every ``tile_n``-wide column tile (no
    |b|^2, no mask); ``min_only``: the min over all columns of
    |b|^2 - 2 a.b (3e38 on masked columns, no |a|^2, no clamp). Both start
    from 3e38, as the kernel's accumulator does. Returns d1 (P, N)."""
    if mode not in ABLATIONS:
        raise ValueError(f"mode must be one of {ABLATIONS}, got {mode!r}")
    pairs, chunk = _pair_chunks(desc, pairs)
    bn = _bnorm(desc, mask)
    r = _operands(desc, True)
    outs = []
    for pr in pairs.split(chunk):
        a, b = r[pr[:, 0]], r[pr[:, 1]]
        if mode == "mm_only":
            v = (a @ b[:, ::tile_n].transpose(-1, -2)).amin(-1)
        else:
            v = (bn[pr[:, 1]].unsqueeze(-2)
                 - 2.0 * (a @ b.transpose(-1, -2))).amin(-1)
        outs.append(torch.clamp_max(v, _BIG))
    return torch.cat(outs)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cluster_plan(P: int, M: int, N: int, fits: Sequence[int],
                 granule: int = 1) -> Tuple[int, int]:
    """(ranks, column tiles per rank) of one call. Its ceil(M/128)·P row
    tiles are one block each, or one cluster of ``ranks`` blocks each
    when they fill less than one wave; ``fits[r - 1]`` is how many
    clusters of r blocks the card holds at once (``fits[0]``: blocks, one
    an SM). Every rank takes a contiguous range of whole 128-column tiles,
    none empty (the C side cuts the same ranges from the ranks it is
    given). Of up to ``MAX_RANKS`` ranks the plan takes the least waves x
    ceil(tiles a rank / granule) (``granule`` 2 for the f32 body, which
    walks two column tiles a step), then the fewest waves, then the fewest
    ranks."""
    rows, ntiles = _cdiv(M, TILE_M) * P, _cdiv(N, TILE_N)
    if rows >= fits[0]:
        return 1, ntiles
    best = None
    for r in range(1, min(MAX_RANKS, ntiles, len(fits)) + 1):
        per = _cdiv(ntiles, r)
        if _cdiv(ntiles, per) != r or fits[r - 1] <= 0:
            continue                    # a rank would be empty, or no room
        waves = _cdiv(rows, fits[r - 1])
        key = (waves * _cdiv(per, granule), waves, r)
        if best is None or key < best[0]:
            best = (key, r, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _cluster_fits(index: int, bf16: bool, D: int) -> Tuple[int, ...]:
    """How many clusters of 1..MAX_RANKS blocks of the FULL kernel (of
    dtype bf16 or f32, width D) the card ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``): one 227 KB block an SM, so a
    cluster of r needs r free SMs of one GPC."""
    fn = _build.load_library(_SOURCE).r3d_l2_top2_clusters
    out = []
    with torch.cuda.device(index):
        for r in range(1, MAX_RANKS + 1):
            n = ctypes.c_int(0)
            _build.call_entry(fn, int(bf16), D, r, ctypes.byref(n))
            out.append(n.value)
    return tuple(out)


def plan(dev, bf16: bool, P: int, M: int, N: int, D: int) -> Tuple[int, int]:
    """``cluster_plan`` of a FULL call on card ``dev``."""
    return cluster_plan(P, M, N, _cluster_fits(dev.index, bf16, D),
                        1 if bf16 else 2)


def _check_tma(name, t):
    """What the kernels' tensor maps take beyond ``_build.check``: rows of
    whole k steps of 16 (so a multiple of 16 bytes, as TMA needs), D <=
    MAX_BF16_DIM in bfloat16, 16-byte aligned. Checked before the rest of
    the layout."""
    D = t.shape[-1] if t.dim() else 0
    if D % 16 or D == 0:
        raise ValueError(f"{name}: D={D} must be a multiple of 16")
    if t.dtype == torch.bfloat16 and D > MAX_BF16_DIM:
        raise ValueError(f"{name}: the bf16 kernel takes D <= "
                         f"{MAX_BF16_DIM}, got {D}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _to_device(t, dev):
    """``t`` (on the host) on ``dev``; to a card pinned and non-blocking, as
    a pageable copy waits for the card's queue to drain."""
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _host_pairs(pairs, Ba: int, Bb: int):
    """The (P, 2) pair table on the host as int32, checked against Ba
    images of A and Bb of B."""
    pairs_h = pairs.detach().to("cpu", torch.int32).contiguous()
    if pairs_h.dim() != 2 or pairs_h.shape[1] != 2 or pairs_h.shape[0] == 0:
        raise ValueError("pairs must be a non-empty (P, 2) table")
    if (pairs_h.min() < 0 or pairs_h[:, 0].max() >= Ba
            or pairs_h[:, 1].max() >= Bb):
        raise IndexError("pair index out of range")
    return pairs_h


def _outputs(shape, dev):
    """(d1, i1, d2) of a call: f32, int32, f32 tensors of ``shape``, views
    of one allocation (one allocation costs a third of three on the host,
    where a single-pair call spends most of its time)."""
    d1, i1, d2 = torch.empty((3, *shape), dtype=torch.float32,
                             device=dev).unbind(0)
    return d1, i1.view(torch.int32), d2


def _block_call(desc_a, desc_b, bnorm, pairs_h,
                mode: str = "full") -> _build.Call:
    """One block-kernel call, prepared: rows of desc_a[pairs_h[:, 0]]
    against desc_b[pairs_h[:, 1]] (a table checked by ``_host_pairs``)
    with |b|^2 ``bnorm``. Its outputs are (d1, i1, d2), each (P, M); the
    ablation modes fill and return only d1."""
    _check_tma("desc_a", desc_a)
    _check_tma("desc_b", desc_b)
    dev = _build.check(desc_a=(desc_a, ("Ba", "M", "D"), _DESC_DTYPES),
                       desc_b=(desc_b, ("Bb", "N", "D"), desc_a.dtype),
                       bnorm=(bnorm, ("Bb", "N"), torch.float32))
    tag = _DTYPE_TAG[desc_a.dtype]
    if mode != "full" and tag != "bf16":
        raise TypeError(f"mode {mode!r} runs on bfloat16 operands")
    Ba, M, D = desc_a.shape
    N = desc_b.shape[1]
    pairs_d = _to_device(pairs_h, dev)
    P = pairs_d.shape[0]
    ranks = 1
    if mode == "full":
        ranks = plan(dev, tag == "bf16", P, M, N, D)[0]
    d1, i1, d2 = _outputs((P, M), dev)
    fn = _build.load_library(_SOURCE).r3d_l2_top2
    args = (int(tag == "bf16"), _MODE[mode], desc_a.data_ptr(),
            desc_b.data_ptr(), bnorm.data_ptr(), pairs_d.data_ptr(), P, M, N,
            D, ranks, d1.data_ptr(), i1.data_ptr(), d2.data_ptr(),
            _build.stream(dev))
    key = (f"l2_top2_block_{tag}" if mode == "full"
           else f"l2_top2_block_{mode}_bf16")
    return _build.Call(fn, args, (desc_a, desc_b, bnorm, pairs_d),
                       (d1, i1, d2) if mode == "full" else d1, key)


def _bnorm(desc, mask, images=None):
    """|b|^2 per row with 3e38 on masked rows, from the descriptors as given
    (f32 values; already-rounded values for a bf16 tensor). ``images`` (a
    host index tensor) restricts the sums to the images a pair table reads
    as B; every other row stays 3e38."""
    if images is not None:
        images = torch.unique(images.to(torch.long))
        if len(images) < desc.shape[0]:
            out = torch.full(mask.shape, _BIG, dtype=torch.float32,
                             device=desc.device)
            idx = _to_device(images, desc.device)
            out[idx] = _bnorm(desc[idx], mask[idx])
            return out
    return torch.where(mask, torch.sum(desc.float() ** 2, -1),
                       _BIG).contiguous()


def _kernel_operands(desc, bf16):
    return (desc.to(torch.bfloat16) if bf16 else desc).contiguous()


def prepare_block(desc, mask, pairs, bf16: bool = False,
                  mode: str = "full") -> _build.Call:
    """The C call of ``l2_top2_block`` (``mode`` "full") or of
    ``l2_top2_block_ablated`` on CUDA tensors, prepared: operands, |b|^2
    of the images the table reads as B and the pair table made."""
    ops = _kernel_operands(desc, bf16 or mode != "full")
    pairs_h = _host_pairs(pairs, desc.shape[0], desc.shape[0])
    return _block_call(ops, ops, _bnorm(desc, mask, pairs_h[:, 1]), pairs_h,
                       mode)


def l2_top2_block(desc, mask, pairs, bf16: bool = False):
    """Fused two-NN search for a BLOCK of pairs (K1). desc: (B, N, D) f32 or
    bf16; mask: (B, N) bool; pairs: (P, 2) int. Returns (d1, i1, d2), each
    (P, N). ``bf16``: see the module docstring. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if not desc.is_cuda:
        return l2_top2_block_plain(desc, mask, pairs, bf16)
    return _build.launch(prepare_block(desc, mask, pairs, bf16))


@functools.lru_cache(maxsize=1024)
def _pair_setup(index: int, kernel_bf16: bool, rnd: bool, M: int, N: int,
                D: int):
    """(C entry, ranks, workspace bytes) of a single-pair call of this
    shape on card ``index``, worked out once: the wrapper's host time is
    most of a call's."""
    lib = _build.load_library(_SOURCE)
    ranks = plan(torch.device("cuda", index), kernel_bf16, 1, M, N, D)[0]
    return (lib.r3d_l2_top2_pair, ranks,
            lib.r3d_l2_top2_pair_workspace(M, N, D, int(rnd)))


# K2's workspace (|b|^2, the bf16 operands) per (device, stream), grown on
# demand: calls on one stream run in its order, so one buffer serves them
# all and a call allocates only its outputs. Threads calling on one stream
# take the lock around the workspace and the C call, so that each call's
# prologue and kernel sit next to each other in the stream (another call's
# prologue cannot overwrite the workspace under a kernel still to run)
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
_WORKSPACE_LOCK = threading.Lock()


def _workspace(dev, stream: int, nbytes: int) -> torch.Tensor:
    key = (dev.index, stream)
    w = _WORKSPACE.get(key)
    if w is None or w.numel() < nbytes:
        w = _WORKSPACE[key] = torch.empty((nbytes,), dtype=torch.uint8,
                                          device=dev)
    return w


def prepare_pair(desc_a, desc_b, mask_b, bf16: bool = False) -> _build.Call:
    """The C call of ``l2_top2`` on CUDA tensors, prepared. It uses the
    current stream's workspace: callers on more than one thread hold
    ``_WORKSPACE_LOCK`` from here to its launch."""
    a, b, mb = desc_a.contiguous(), desc_b.contiguous(), mask_b.contiguous()
    _check_tma("desc_a", a)
    _check_tma("desc_b", b)
    dev = _build.check(desc_a=(a, ("M", "D"), _DESC_DTYPES),
                       desc_b=(b, ("N", "D"), a.dtype),
                       mask_b=(mb, ("N",), torch.bool))
    (M, D), N = a.shape, b.shape[0]
    rnd = bf16 and a.dtype == torch.float32
    kernel_bf16 = rnd or a.dtype == torch.bfloat16
    fn, ranks, nbytes = _pair_setup(dev.index, kernel_bf16, rnd, M, N, D)
    stream = _build.stream(dev)
    d1, i1, d2 = _outputs((M,), dev)
    work = _workspace(dev, stream, nbytes)
    args = (int(a.dtype == torch.bfloat16), int(rnd), a.data_ptr(),
            b.data_ptr(), mb.data_ptr(), M, N, D, ranks, work.data_ptr(),
            d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), stream)
    return _build.Call(fn, args, (a, b, mb, work), (d1, i1, d2),
                       "l2_top2_bf16" if kernel_bf16 else "l2_top2_f32")


def l2_top2(desc_a, desc_b, mask_b, bf16: bool = False):
    """Fused two-NN search for one pair (K2): desc_a (M, D), desc_b (N, D)
    of one dtype, mask_b (N,) bool. Returns (d1, i1, d2), each (M,). On a
    card: one C call, the prologue (|b|^2 under the mask; with ``bf16`` on
    f32 descriptors, the rounded operands) and one cluster launch."""
    if not desc_a.is_cuda:
        return l2_top2_plain(desc_a, desc_b, mask_b, bf16)
    with _WORKSPACE_LOCK:
        return _build.launch(prepare_pair(desc_a, desc_b, mask_b, bf16))


def l2_top2_block_ablated(desc, mask, pairs, mode: str):
    """K1's bf16 kernel with the top-2 merge ablated (K3, the matcher
    profile's ``mm_only`` / ``min_only``). desc: (B, N, D); the operands are
    rounded to bf16 and |b|^2 comes from the values as given. Returns d1
    (P, N). CPU tensors take the plain version at the kernel's column-tile
    width."""
    if mode not in ABLATIONS:
        raise ValueError(f"mode must be one of {ABLATIONS}, got {mode!r}")
    if not desc.is_cuda:
        return l2_top2_block_ablated_plain(desc, mask, pairs, mode, TILE_N)
    return _build.launch(prepare_block(desc, mask, pairs, True, mode))


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


def match_pairs_batched(desc_a, mask_a, desc_b, mask_b, ratio: float = 0.8,
                        use_kernel: bool = True):
    """``match_pair`` over a batch of pairs: row p of desc_a (P, M, D)
    against row p of desc_b (P, N, D), masks (P, M) and (P, N). On CUDA
    tensors one launch of the block kernel (K1) over the pair table
    (p, p); CPU tensors and ``use_kernel=False`` take the plain top-2.
    Returns (idx, d1, ok), each (P, M)."""
    if use_kernel and desc_a.is_cuda:
        P = desc_a.shape[0]
        a, b = desc_a.contiguous(), desc_b.contiguous()
        pairs = torch.arange(P, dtype=torch.int32)[:, None].expand(P, 2)
        d1, i1, d2 = _build.launch(_block_call(a, b, _bnorm(b, mask_b),
                                               _host_pairs(pairs, P, P)))
    else:
        d1, i1, d2 = _top2_plain(desc_a, desc_b, _bnorm(desc_b, mask_b),
                                 False)
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < 1e30)
    return i1, d1, ok


def match_pair_block(desc, mask, pairs, ratio: float = 0.8,
                     use_kernel: bool = True, bf16: bool = False):
    """Match a block of image pairs in one dispatch. desc: (B, N, D) padded
    descriptors; mask: (B, N); pairs: (P, 2) int image indices.
    Returns (idx (P, N), d1, ok). ``bf16`` is the fast presets' flag,
    passed through with the f32 descriptors (the product's operands are
    rounded to bf16, distances accumulate in f32, |b|^2 comes from f32)."""
    pairs_l = pairs.to(desc.device, torch.long)
    ma = mask[pairs_l[:, 0]]
    top2 = l2_top2_block if use_kernel else l2_top2_block_plain
    d1, i1, d2 = top2(desc, mask, pairs, bf16)
    ok = ma & (d1 < (ratio * ratio) * d2) & (d1 < 1e30)
    return i1, d1, ok
