"""Compute-matches stage driver.

Counterpart of ``regard3d_tpu/pipeline/compute_matches.py``: features ->
exhaustive pairs -> putative matching (ratio test) -> geometric filtering
(AC-RANSAC F, then E with the overlap prune, then H) -> match files +
adjacency SVGs + statistics + report.

* Pairs are matched in fixed blocks of 64 (the list padded by repeating the
  last pair, as the reference does); on the card each block is one launch
  of the CUDA matcher (``kernels/match.py``).
* The filters run pair blocks bucketed by padded match capacity, with the
  pair block as the leading dimension of every RANSAC tensor.
* Every pair's random draws come from a generator seeded with
  (seed, i, j, filter), so a pair's result does not depend on the block it
  lands in. ``sample_provider`` injects precomputed draws instead (tests
  feed the reference's).

Artifacts: matches.putative.txt, matches.{f,e,h}.txt (OpenMVG text format
``I J\\nN\\ni j`` per pair), Putative/GeometricAdjacencyMatrix.svg,
sfm_data.json + lists.txt, Matching_Report.html.

``retrieval_k`` adds each image's most similar images (pooled-descriptor
retrieval) to a windowed pair list.

Distribution. With a mesh (a list of devices, ``dist/mesh.py``), feature
buckets, matcher blocks of 64 pairs and filter blocks go round-robin over
its devices. With ``proc_count > 1`` (``r3d launch -n N -- matches``) the
work is sharded over processes that share the step directory: whole
feature buckets and the filter's blocks round-robin, the pair list
round-robin; each process writes ``matches.*.part{pid}.txt`` and the
primary merges the parts. Either way every image, pair and filter block is
computed in the batch it has in a one-process run, so the artifacts are the
same bytes (the reference shards single images and pairs; on the card a
batched operation's rounding may follow its batch). The processes meet at
token-stamped marker files (``.stage_ready``, ``.feat{p}.done``,
``.put{p}.done``, ``.part{p}.done``), each wait bounded.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regard3d_tpu_torch import runtime, spans
from regard3d_tpu_torch.core import sfm_data as sd
from regard3d_tpu_torch.core.types import RADIAL_K3, round_up
from regard3d_tpu_torch.dist import launch
from regard3d_tpu_torch.dist import mesh as meshlib
from regard3d_tpu_torch.kernels import match as match_mod
from regard3d_tpu_torch.kernels import ransac
from regard3d_tpu_torch.pipeline import features as feat_mod
from regard3d_tpu_torch.pipeline.report import write_matches_report

# matcher menu parity (src/res/Regard3dMainFrameBase.fbp:9300); every preset
# maps onto the exact matcher
MATCHER_PRESETS = ("flann", "kgraph-fast", "kgraph-medium", "kgraph-precise",
                   "brute-force", "mrpt", "hnsw-fast", "hnsw-medium",
                   "hnsw-precise")

PAIR_BLOCK = 64      # pairs per matcher launch

# descriptor width handed to the matcher: LIOP's 144 columns (a multiple of
# 16, which the CUDA kernel needs). The reference stores 256 (a TPU lane
# width); the extra zero columns change no distance.
MATCH_DIM = round_up(feat_mod.LIOP_DIM, 16)

# Geometric-filter block budget for an 80 GB card. The live set of one
# chunk of the sweep is block * chunk * models * cap f32 residual elements
# times the ~8 temporaries of the residual and score (homogeneous points,
# lines, numerator, denominator, masks). The budget below bounds
# block * chunk * cap at 2^26 (the reference used 2^24 for a 16 GB TPU):
# for the 5-point E sweep (64 draws x 10 models = 640 candidates, five
# times the F/H chunk of 128) that is 2^26 * 5 * 8 * 4 B ~= 10.7 GB at the
# largest block, an eighth of the card; F/H need a fifth of that.
FILTER_BUDGET = 1 << 26
FILTER_MAX_BLOCK = 128

SampleProvider = Callable[[str, int, int, np.ndarray, int, int], np.ndarray]


def matcher_knobs(matcher: str) -> Dict:
    """Map the reference's ANN menu onto the exact matcher's knobs: the
    approximate presets become bfloat16 descriptors (f32 accumulation);
    ``brute-force`` and the ``*-precise`` presets stay f32."""
    m = (matcher or "brute-force").lower()
    precise = m == "brute-force" or m.endswith("-precise")
    return {"bf16": not precise}


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    ratio: float = 0.8                # presets 0.6/0.7/0.8/0.9
    matcher: str = "brute-force"
    mutual: bool = False
    ransac_iters: int = 1024          # reference default 2048 (:2100)
    max_err_px: float = 4.0
    e_min_matches: int = 50           # overlap prune (:2173-2191)
    e_min_survival: float = 0.3
    compute_homography: bool = True


def exhaustive_pairs(n: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def sequential_pairs(n: int, window: int) -> List[Tuple[int, int]]:
    """Ordered-capture pair pruning: each view pairs with its next
    ``window`` successors."""
    return [(i, j) for i in range(n)
            for j in range(i + 1, min(i + 1 + window, n))]


def retrieval_pairs(descs, k: int = 8,
                    exclude: Optional[set] = None) -> List[Tuple[int, int]]:
    """Image-retrieval pair augmentation: top-``k`` most similar images per
    image by pooled-descriptor similarity (one (V, V) product).

    A windowed pair list on a sequential capture never connects temporally
    distant views of the same place, so loop closures are lost; retrieval
    recovers them at the cost of one product of pooled descriptors. The
    pooled descriptor is the L2-normalized mean of an image's LIOP
    descriptors (non-negative histograms, so the mean is a meaningful
    bag-of-features signature). Deterministic given the features."""
    data = descs.data                                   # (V, N, D)
    m = descs.mask[..., None].to(data.dtype)
    pooled = (data * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
    pooled = pooled / torch.clamp_min(
        torch.linalg.norm(pooled, dim=-1, keepdim=True), 1e-12)
    sim = pooled @ pooled.T                             # (V, V)
    V = sim.shape[0]
    sim = sim - 2.0 * torch.eye(V, dtype=sim.dtype, device=sim.device)
    nbr = torch.topk(sim, min(k, V - 1), dim=-1).indices.cpu().numpy()
    out = set()
    for i in range(V):
        for j in nbr[i]:
            pr = (i, int(j)) if i < int(j) else (int(j), i)
            if exclude is None or pr not in exclude:
                out.add(pr)
    return sorted(out)


def save_matches_txt(path: str, matches: Dict[Tuple[int, int], np.ndarray]):
    with open(path, "w") as f:
        for (i, j), m in sorted(matches.items()):
            if len(m) == 0:
                continue
            f.write(f"{i} {j}\n{len(m)}\n")
            for a, b in m:
                f.write(f"{a} {b}\n")


def load_matches_txt(path: str) -> Dict[Tuple[int, int], np.ndarray]:
    out = {}
    with open(path) as f:
        lines = f.read().split()
    pos = 0
    while pos < len(lines):
        i, j = int(lines[pos]), int(lines[pos + 1])
        n = int(lines[pos + 2])
        pos += 3
        arr = np.asarray(lines[pos:pos + 2 * n], np.int64).reshape(n, 2)
        pos += 2 * n
        out[(i, j)] = arr
    return out


def best_validated_pairs(matches_dir: str, kind: str = "f",
                         limit: int = 0) -> List[Dict]:
    """Pairs ranked by geometrically-validated match count (the list the
    reference's triangulation dialog shows for initial-pair selection)."""
    geo = load_matches_txt(os.path.join(matches_dir, f"matches.{kind}.txt"))
    put_path = os.path.join(matches_dir, "matches.putative.txt")
    put = load_matches_txt(put_path) if os.path.exists(put_path) else {}
    rows = []
    for (i, j), m in geo.items():
        n_put = len(put.get((i, j), m))
        rows.append({
            "i": int(i), "j": int(j),
            "geometric": int(len(m)),
            "putative": int(n_put),
            "survival": float(len(m)) / max(n_put, 1),
        })
    rows.sort(key=lambda r: -r["geometric"])
    return rows[:limit] if limit else rows


def adjacency_svg(path: str, n: int,
                  counts: Dict[Tuple[int, int], int], cell: int = 12):
    """Adjacency-matrix SVG (PutativeAdjacencyMatrix.svg parity)."""
    size = (n + 1) * cell
    mx = max(counts.values(), default=1) or 1
    rects = []
    for (i, j), c in counts.items():
        if c <= 0:
            continue
        o = int(255 * (1.0 - min(c / mx, 1.0)))
        for (a, b) in ((i, j), (j, i)):
            rects.append(
                f'<rect x="{(b + 1) * cell}" y="{(a + 1) * cell}" '
                f'width="{cell - 1}" height="{cell - 1}" '
                f'fill="rgb({o},{o},255)"><title>({a},{b}): {c}</title>'
                f'</rect>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
           f'height="{size}">' + "".join(rects) + "</svg>")
    with open(path, "w") as f:
        f.write(svg)


def _match_block(desc, mask, parr, cfg: MatchConfig, bf16: bool):
    """One pair block: f32 descriptors and the preset's bf16 flag go to the
    matcher, which rounds the product's operands itself."""
    idx, _, ok = match_mod.match_pair_block(desc, mask, parr, cfg.ratio,
                                            True, bf16=bf16)
    spans.count("launches", 2 if cfg.mutual else 1)
    if cfg.mutual:
        rev = parr.flip(-1)
        idx_b, _, ok_b = match_mod.match_pair_block(desc, mask, rev,
                                                    cfg.ratio, True,
                                                    bf16=bf16)
        ok = match_mod.mutual_filter(idx, ok, idx_b, ok_b)
    return idx, ok


def match_all_pairs(kps, descs, cfg: MatchConfig,
                    pairs: Optional[List[Tuple[int, int]]] = None,
                    progress=None,
                    mesh=None) -> Dict[Tuple[int, int], np.ndarray]:
    """Putative matching for every pair: fused distance + top-2 + ratio.
    kps/descs: padded (B, N, ...) tensors from ``features.load_all_padded``
    on the stage's device; one matcher call per block of 64 pairs. With
    ``mesh``, blocks of 64 x its size, each split into blocks of 64 that go
    to its devices in turn (descriptors copied to each device once).
    Spans (under the caller's): ``.readback`` (the host waiting on a
    block's results) and ``.unpack`` (the per-pair arrays built from
    them), once a block; counter ``launches`` (matcher calls, pad-filled
    blocks included) on the caller's span."""
    B = descs.data.shape[0]
    if pairs is None:
        pairs = exhaustive_pairs(B)
    bf16 = matcher_knobs(cfg.matcher)["bf16"]
    devs = [descs.data.device] if mesh is None else mesh.device_list
    on = {d: (descs.data.to(d), descs.mask.to(d)) for d in set(devs)}
    block = PAIR_BLOCK * len(devs)
    out = {}
    total = len(pairs)
    padded = pairs + [pairs[-1]] * ((-len(pairs)) % block)
    for start in range(0, len(padded), block):
        chunk = padded[start:start + block]
        # launch every device's block before reading any back
        parts = [_match_block(*on[d], torch.as_tensor(np.asarray(
            chunk[k * PAIR_BLOCK:(k + 1) * PAIR_BLOCK], np.int32)), cfg,
            bf16) for k, d in enumerate(devs)]
        with spans.span(".readback"):
            idx_np = np.concatenate([idx.cpu().numpy() for idx, _ in parts])
            ok_np = np.concatenate([ok.cpu().numpy() for _, ok in parts])
        with spans.span(".unpack"):
            for bi, (i, j) in enumerate(chunk):
                if start + bi >= total:
                    break
                ia = np.where(ok_np[bi])[0]
                out[(i, j)] = np.stack([ia, idx_np[bi][ia]],
                                       -1).astype(np.int64)
                if progress:
                    progress(min(start + bi + 1, total), total)
    return out


def e_overlap_keep(num_geometric: int, num_putative: int,
                   cfg: MatchConfig) -> bool:
    """E-matrix overlap prune: keep a pair only with >= 50 geometric
    matches AND >= 30% putative survival."""
    return (num_geometric >= cfg.e_min_matches
            and num_geometric >= cfg.e_min_survival * num_putative)


@dataclasses.dataclass
class FilterResult:
    f: Dict[Tuple[int, int], np.ndarray]
    e: Dict[Tuple[int, int], np.ndarray]
    h: Dict[Tuple[int, int], np.ndarray]
    stats: Dict


_FILTER_SAMPLE = {"f": 8, "e": 5, "h": 4}
_FILTER_SALT = {"f": 0, "e": 1, "h": 2}


def pair_generator(seed: int, i: int, j: int, kind: str) -> torch.Generator:
    """The CPU generator of one pair's draws for filter ``kind``, seeded from
    (seed, i, j, kind): independent of block composition."""
    ss = np.random.SeedSequence([seed, i, j, _FILTER_SALT[kind]])
    g = torch.Generator()
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    return g


def _block_draws(kind, group, mask_np, iters, seed, provider, dev):
    """Sample indices (block, iters, s) for one filter over one pair block:
    from the provider if given, else from the per-pair generators."""
    s = _FILTER_SAMPLE[kind]
    block = mask_np.shape[0]
    if provider is not None:
        idx = np.zeros((block, iters, s), np.int64)
        for bi, ((i, j), _m) in enumerate(group):
            idx[bi] = provider(kind, i, j, mask_np[bi], iters, s)
        return torch.as_tensor(idx, device=dev)
    gens = [pair_generator(seed, i, j, kind) for (i, j), _m in group]
    if block > len(group):   # empty padding slots: any draws will do
        gens += [torch.Generator().manual_seed(seed)] * (block - len(group))
    return ransac._draw_samples_batch(gens, torch.as_tensor(mask_np,
                                                            device=dev),
                                      iters, s)


def filter_blocks(putative: Dict[Tuple[int, int], np.ndarray],
                  cfg: MatchConfig) -> List[Tuple[int, list]]:
    """The filter's blocks in the order it runs them: pairs with >= 16
    matches, bucketed by padded match capacity, each bucket cut into blocks
    within the memory budget. Returns [(cap, [((i, j), matches), ...])]."""
    items = [(pr, m) for pr, m in sorted(putative.items()) if len(m) >= 16]
    buckets: Dict[int, list] = {}
    for pr, m in items:
        cap = max(64, 1 << int(np.ceil(np.log2(len(m)))))
        buckets.setdefault(cap, []).append((pr, m))
    out = []
    for cap, blist in sorted(buckets.items()):
        chunked_iters = min(cfg.ransac_iters, 128)
        block = max(1, min(FILTER_MAX_BLOCK,
                           FILTER_BUDGET // max(chunked_iters * cap, 1)))
        # eager code needs no static block shape: a short bucket is not
        # padded up to the budget (pairs are independent of their block)
        block = min(block, len(blist))
        out += [(cap, blist[s0:s0 + block])
                for s0 in range(0, len(blist), block)]
    return out


def _filter_block(cap, group, xy, image_sizes, focals, cfg: MatchConfig,
                  seed, sample_provider, dev):
    """AC-RANSAC F, E and H of one block of pairs on ``dev``; returns the
    block's (f, e, h) inlier match dicts. Spans (under the caller's):
    ``.block`` and its steps ``.prep`` (the padded arrays), ``.draws`` (a
    kind's samples, taken before its sweep), ``.f`` / ``.e`` / ``.h`` (each
    sweep as enqueued), ``.readback`` (the host waiting on the device) and
    ``.collect``."""
    block = len(group)
    with spans.span(".block"):
        with spans.span(".prep"):
            max_err_f = np.float32(cfg.max_err_px ** 2)
            x1 = np.zeros((block, cap, 2), np.float32)
            x2 = np.zeros((block, cap, 2), np.float32)
            x1n = np.zeros((block, cap, 2), np.float32)
            x2n = np.zeros((block, cap, 2), np.float32)
            maskb = np.zeros((block, cap), bool)
            la_f = np.zeros((block,), np.float32)
            la_h = np.zeros((block,), np.float32)
            la_e = np.zeros((block,), np.float32)
            me_f = np.full((block,), max_err_f, np.float32)
            me_e = np.full((block,), max_err_f, np.float32)
            has_e = np.zeros((block,), bool)
            for bi, ((i, j), m) in enumerate(group):
                n = len(m)
                p1 = xy[i][m[:, 0]]
                p2 = xy[j][m[:, 1]]
                x1[bi, :n] = p1
                x2[bi, :n] = p2
                maskb[bi, :n] = True
                w = float(max(image_sizes[i][0], image_sizes[j][0]))
                h = float(max(image_sizes[i][1], image_sizes[j][1]))
                la_f[bi] = ransac._logalpha0_line(w, h)
                la_h[bi] = ransac._logalpha0_point(w, h)
                if focals is not None and focals[i] > 0 and focals[j] > 0:
                    has_e[bi] = True
                    x1n[bi, :n] = (p1 - image_sizes[i] / 2.0) / focals[i]
                    x2n[bi, :n] = (p2 - image_sizes[j] / 2.0) / focals[j]
                    fmean = float(np.sqrt(focals[i] * focals[j]))
                    diag = np.sqrt(w * w + h * h)
                    la_e[bi] = np.log10(2.0 * diag / (w * h) * fmean)
                    me_e[bi] = (cfg.max_err_px / fmean) ** 2
            mask_e = maskb & has_e[:, None]
        iters = cfg.ransac_iters
        t = lambda a: torch.as_tensor(a, device=dev)

        def draws(kind, mk):
            with spans.span(".draws"):
                return _block_draws(kind, group, mk, iters, seed,
                                    sample_provider, dev)

        # each kind's inputs, then its draws, then its sweep
        with torch.no_grad():
            a = (t(x1), t(x2), t(maskb), t(la_f), t(me_f))
            idx = draws("f", maskb)
            with spans.span(".f"):
                rf = ransac.acransac_f_batch(None, *a, iters=iters, idx=idx)
            re = None
            if has_e.any():
                a = (t(x1n), t(x2n), t(mask_e), t(la_e), t(me_e))
                idx = draws("e", mask_e)
                with spans.span(".e"):
                    re = ransac.acransac_e_batch(None, *a, iters=iters,
                                                 idx=idx)
            rh = None
            if cfg.compute_homography:
                a = (t(x1), t(x2), t(maskb), t(la_h), t(me_f))
                idx = draws("h", maskb)
                with spans.span(".h"):
                    rh = ransac.acransac_h_batch(None, *a, iters=iters,
                                                 idx=idx)

        with spans.span(".readback"):
            f_valid = rf.valid.cpu().numpy()
            f_inl = rf.inliers.cpu().numpy()
            e_valid = re.valid.cpu().numpy() if re is not None else None
            e_inl = re.inliers.cpu().numpy() if re is not None else None
            h_valid = rh.valid.cpu().numpy() if rh is not None else None
            h_inl = rh.inliers.cpu().numpy() if rh is not None else None
        with spans.span(".collect"):
            out_f, out_e, out_h = {}, {}, {}
            for bi, ((i, j), m) in enumerate(group):
                n = len(m)
                if f_valid[bi]:
                    out_f[(i, j)] = m[f_inl[bi][:n]]
                if e_valid is not None and has_e[bi] and e_valid[bi]:
                    inl = e_inl[bi][:n]
                    if e_overlap_keep(int(inl.sum()), n, cfg):
                        out_e[(i, j)] = m[inl]
                if h_valid is not None and h_valid[bi]:
                    out_h[(i, j)] = m[h_inl[bi][:n]]
    return out_f, out_e, out_h


def _match_stats(putative, f, e, h) -> Dict:
    d = {"putative": putative, "f": f, "e": e, "h": h}
    return {**{f"pairs_{k}": len(v) for k, v in d.items()},
            **{f"matches_{k}": int(sum(len(m) for m in v.values()))
               for k, v in d.items()}}


def geometric_filter(kps, putative: Dict[Tuple[int, int], np.ndarray],
                     image_sizes: np.ndarray,
                     focals: Optional[np.ndarray],
                     cfg: MatchConfig, seed: int = 0,
                     progress=None, device=None,
                     sample_provider: Optional[SampleProvider] = None,
                     mesh=None, block_shard: Tuple[int, int] = (0, 1)
                     ) -> FilterResult:
    """AC-RANSAC F -> E (+overlap prune) -> H over pair blocks.

    Pairs are bucketed by padded match capacity and each bucket is filtered
    in blocks with the pair block as leading dimension (``filter_blocks``).
    ``device``: where the filters run (default: the keypoints' device);
    with ``mesh``, the blocks go round-robin over its devices, one thread
    per device. ``block_shard=(p, n)``: only every n-th block from the
    p-th (process p's share of an n-process run). ``sample_provider``:
    optional ``(kind, i, j, mask (cap,), iters, s) -> (iters, s)`` indices
    that replace the generator draws (kind in "f", "e", "h")."""
    xy = kps.xy.cpu().numpy()
    dev = kps.xy.device if device is None else torch.device(device)
    blocks = filter_blocks(putative, cfg)[block_shard[0]::block_shard[1]]
    run = lambda blk, d: _filter_block(blk[0], blk[1], xy, image_sizes,
                                       focals, cfg, seed, sample_provider, d)
    results = (meshlib.run_on_mesh(run, blocks, mesh) if mesh is not None
               else (run(blk, dev) for blk in blocks))
    out_f, out_e, out_h = {}, {}, {}
    n_done, n_total = 0, sum(len(g) for _, g in blocks)
    spans.count("pairs", n_total)
    for (_, group), (f, e, h) in zip(blocks, results):
        out_f.update(f)
        out_e.update(e)
        out_h.update(h)
        n_done += len(group)
        if progress:
            progress(n_done, n_total)
    stats = _match_stats(putative, out_f, out_e, out_h)
    stats["filter_blocks"] = len(blocks)
    return FilterResult(out_f, out_e, out_h, stats)


def write_stage_sfm_data(out_dir: str, image_sizes: np.ndarray,
                         focals: Optional[np.ndarray],
                         image_names: Optional[Sequence[str]] = None):
    """views+intrinsics sfm_data.json + legacy lists.txt in the matches dir
    (one radial-K3 intrinsic per view, principal point at the center)."""
    V = len(image_sizes)
    f = (np.asarray(focals) if focals is not None
         else 1.1 * image_sizes.max(1))
    params = np.zeros((V, 9), np.float32)
    params[:, 0] = f
    params[:, 1] = image_sizes[:, 0] / 2.0
    params[:, 2] = image_sizes[:, 1] / 2.0
    sd.save_views_json(os.path.join(out_dir, "sfm_data.json"),
                       widths=image_sizes[:, 0].astype(np.int32),
                       heights=image_sizes[:, 1].astype(np.int32),
                       intrinsic_id=np.arange(V),
                       models=np.full((V,), RADIAL_K3), params=params,
                       image_names=image_names)
    with open(os.path.join(out_dir, "lists.txt"), "w") as fh:
        for i in range(V):
            name = image_names[i] if image_names else f"image{i:06d}.jpg"
            fh.write(f"{name};{image_sizes[i, 0]};{image_sizes[i, 1]}\n")


def _job_token() -> str:
    """Unique-per-launch token (the coordinator address), so markers left
    by an earlier run of the same step directory never satisfy a wait."""
    return os.environ.get(launch.ENV_COORD, "local")


def _write_marker(path: str):
    with open(path, "w") as fh:
        fh.write(_job_token())


def _wait_for_marker(path: str, timeout_s: Optional[float] = None):
    """Wait until ``path`` holds this job's token; raises TimeoutError after
    ``timeout_s`` (default ``launch.timeout_s()``)."""
    timeout_s = launch.timeout_s() if timeout_s is None else timeout_s
    t0 = time.time()
    while True:
        try:
            with open(path) as fh:
                if fh.read().strip() == _job_token():
                    return
        except OSError:
            pass
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"timed out waiting for {path}")
        time.sleep(0.2)


def _barrier(out_dir: str, tag: str, proc_id: int, proc_count: int):
    """Every process writes ``.{tag}{p}.done`` and waits for the others'."""
    _write_marker(os.path.join(out_dir, f".{tag}{proc_id}.done"))
    for p in range(proc_count):
        _wait_for_marker(os.path.join(out_dir, f".{tag}{p}.done"))


def _load_parts(out_dir: str, tag: str, proc_count: int):
    d = {}
    for p in range(proc_count):
        d.update(load_matches_txt(
            os.path.join(out_dir, f"matches.{tag}.part{p}.txt")))
    return d


def run_compute_matches(images: Sequence[np.ndarray], out_dir: str,
                        threshold: float = 0.0007,
                        cfg: MatchConfig = MatchConfig(),
                        focals: Optional[np.ndarray] = None,
                        max_keypoints: int = 4096,
                        force: bool = False,
                        image_names: Optional[Sequence[str]] = None,
                        detector: str = "fast-akaze",
                        progress=None,
                        pairs: Optional[List[Tuple[int, int]]] = None,
                        retrieval_k: int = 0,
                        device=None, seed: int = 0,
                        sample_provider: Optional[SampleProvider] = None,
                        mesh=None, proc_id: int = 0, proc_count: int = 1
                        ) -> Dict:
    """Full compute-matches step on a list of gray images. Returns stats,
    with the stage's time split under ``time_features_s``,
    ``time_matching_s`` and ``time_filter_s`` (the seconds of the spans
    ``compute_matches.{features,matching,filter}``) and every span's
    summary under ``spans`` (``regard3d_tpu_torch/spans.py``). Runs on
    ``device`` (default cuda; raises if no card and the CPU was not asked
    for), or over the devices of ``mesh`` (default: every card when more
    than one is visible). ``retrieval_k`` with a ``pairs`` list adds each
    image's top-k most similar images as pairs (stats key
    ``pairs_retrieval``).

    ``proc_count > 1``: this is process ``proc_id`` of a sharded run over
    the same ``out_dir`` (module docstring); every process must call it.
    The primary (0) writes the stage's artifacts and returns the stats;
    a secondary returns ``{"role", "pairs_matched", "spans"}``."""
    dev = runtime.resolve_device(device)
    mesh = meshlib.local_mesh("pairs", mesh, dev)
    with spans.collect() as col:
        # every span of the step carries its prefix: the profiler mirrors a
        # span onto the device's timeline, where a reader that keeps the
        # step's spans by prefix must not take it for device work
        with spans.span("compute_matches.step") as step:
            stats = _compute_matches(
                step, images, out_dir, threshold=threshold, cfg=cfg,
                focals=focals, max_keypoints=max_keypoints, force=force,
                image_names=image_names, detector=detector,
                progress=progress, pairs=pairs, retrieval_k=retrieval_k,
                dev=dev, seed=seed, sample_provider=sample_provider,
                mesh=mesh, proc_id=proc_id, proc_count=proc_count)
        stats["spans"] = col.summary()
    return stats


def _compute_matches(step, images, out_dir, threshold, cfg, focals,
                     max_keypoints, force, image_names, detector, progress,
                     pairs, retrieval_k, dev, seed, sample_provider, mesh,
                     proc_id, proc_count) -> Dict:
    """``run_compute_matches`` inside its step span ``step``."""
    os.makedirs(out_dir, exist_ok=True)
    sizes = np.asarray([[im.shape[1], im.shape[0]] for im in images])
    sharded = proc_count > 1

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # one span per phase, each ending in a device synchronize, so a trace
    # attributes every device operation to its phase
    with spans.span("compute_matches.features") as t_features:
        if proc_id == 0:
            if sharded:
                # markers of an earlier run of this step directory go first
                for fn in os.listdir(out_dir):
                    if fn.startswith((".feat", ".put", ".part")) \
                            and fn.endswith(".done"):
                        os.remove(os.path.join(out_dir, fn))
            write_stage_sfm_data(out_dir, sizes, focals, image_names)
            if sharded:
                _write_marker(os.path.join(out_dir, ".stage_ready"))
        else:
            _wait_for_marker(os.path.join(out_dir, ".stage_ready"))
        subset = None
        if sharded:      # whole buckets, round-robin over the processes
            subset = sorted(i for b in feat_mod.image_buckets(images)[
                proc_id::proc_count] for i in b)
        counts = feat_mod.extract_features(images, out_dir, threshold,
                                           max_keypoints, force=force,
                                           detector=detector,
                                           progress=progress, subset=subset,
                                           device=dev, mesh=mesh)
        sync()
        if sharded:
            _barrier(out_dir, "feat", proc_id, proc_count)
            counts = feat_mod.load_counts(out_dir, len(images))
    with spans.span("compute_matches.matching") as t_matching:
        with spans.span(".load"):
            kps, descs = feat_mod.load_all_padded(out_dir, len(images),
                                                  pad_to=256,
                                                  padded_dim=MATCH_DIM,
                                                  device=dev)
        n_retrieval = 0
        if retrieval_k and pairs is not None:
            # deterministic from the features: every process derives the
            # same list
            base = set(pairs)
            extra = retrieval_pairs(descs, retrieval_k, exclude=base)
            n_retrieval = len(extra)
            pairs = sorted(base | set(extra))
        my_pairs = pairs
        if sharded:
            my_pairs = (pairs if pairs is not None
                        else exhaustive_pairs(len(images)))[
                proc_id::proc_count]
        with spans.span(".match"):
            putative = match_all_pairs(kps, descs, cfg, pairs=my_pairs,
                                       progress=progress, mesh=mesh)
        sync()
        n_matched = len(putative)
        if sharded:
            # every process needs every pair's matches to cut the filter's
            # blocks as a one-process run does
            save_matches_txt(os.path.join(
                out_dir, f"matches.putative.part{proc_id}.txt"), putative)
            _barrier(out_dir, "put", proc_id, proc_count)
            putative = _load_parts(out_dir, "putative", proc_count)
    with spans.span("compute_matches.filter") as t_filter:
        filt = geometric_filter(kps, putative, sizes, focals, cfg, seed=seed,
                                progress=progress,
                                sample_provider=sample_provider, mesh=mesh,
                                block_shard=(proc_id, proc_count))
        sync()

    if sharded:
        for tag, d in (("f", filt.f), ("e", filt.e), ("h", filt.h)):
            save_matches_txt(os.path.join(
                out_dir, f"matches.{tag}.part{proc_id}.txt"), d)
        _write_marker(os.path.join(out_dir, f".part{proc_id}.done"))
        if proc_id != 0:
            return {"role": f"secondary {proc_id}/{proc_count}",
                    "pairs_matched": n_matched}
        for p in range(proc_count):
            _wait_for_marker(os.path.join(out_dir, f".part{p}.done"))
        merged = {tag: _load_parts(out_dir, tag, proc_count)
                  for tag in ("f", "e", "h")}
        filt = FilterResult(merged["f"], merged["e"], merged["h"], dict(
            _match_stats(putative, merged["f"], merged["e"], merged["h"]),
            filter_blocks=len(filter_blocks(putative, cfg)),
            processes=proc_count))

    with spans.span("compute_matches.artifacts"):
        save_matches_txt(os.path.join(out_dir, "matches.putative.txt"),
                         putative)
        save_matches_txt(os.path.join(out_dir, "matches.f.txt"), filt.f)
        save_matches_txt(os.path.join(out_dir, "matches.e.txt"), filt.e)
        save_matches_txt(os.path.join(out_dir, "matches.h.txt"), filt.h)
        n = len(images)
        adjacency_svg(os.path.join(out_dir, "PutativeAdjacencyMatrix.svg"),
                      n, {k: len(v) for k, v in putative.items()})
        adjacency_svg(os.path.join(out_dir, "GeometricAdjacencyMatrix.svg"),
                      n, {k: len(v) for k, v in filt.f.items()})

        stats = dict(filt.stats)
        stats["keypoints"] = counts
        if n_retrieval:
            stats["pairs_retrieval"] = n_retrieval
        stats["elapsed_s"] = step.seconds
        stats["time_features_s"] = t_features.seconds
        stats["time_matching_s"] = t_matching.seconds
        stats["time_filter_s"] = t_filter.seconds

        pair_rows = [{"i": int(i), "j": int(j),
                      "putative": int(len(putative.get((i, j), ()))),
                      "geometric": int(len(m)),
                      "survival": (len(m)
                                   / max(len(putative.get((i, j), ())), 1))}
                     for (i, j), m in sorted(filt.f.items(),
                                             key=lambda kv: -len(kv[1]))]
        write_matches_report(
            os.path.join(out_dir, "Matching_Report.html"),
            {k: v for k, v in stats.items()
             if isinstance(v, (int, float, str))},
            pair_rows, keypoint_counts=counts, image_names=image_names)
    return stats
