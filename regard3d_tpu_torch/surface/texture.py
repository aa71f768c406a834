"""Mesh texturing — the in-process ``texrecon`` equivalent.

Counterpart of ``regard3d_tpu/surface/texture.py``. The reference can only
texture through the external ``texrecon`` binary
(``src/R3DSurfaceGenProcess.cpp:172-197``: outlier-removal modes
none/gauss-clamping/gauss-damping, a visibility test, and global/local seam
leveling). The stages:

1. **Projection** — every face sample is projected into every posed view in
   one batched call (``core.cameras.project`` over a view axis, with the
   view's distortion model, so sampling happens in the *original* images).
2. **Visibility** — point-splat z-buffers: each face is sampled at a fixed
   barycentric pattern, the samples are scatter-min'ed into a per-view depth
   buffer (``scatter_reduce_(..., "amin")``: order-free, so deterministic),
   and a face's visible fraction in a view is the share of its samples that
   win the depth test (the ``texrecon`` visibility check).
3. **View selection** — per (face, view) score = visible fraction ×
   projected area × viewing-angle cosine, matching texrecon's data term.
4. **Photometric outlier removal** (host) — per-face mean colors across
   candidate views; ``gauss_damping`` multiplies scores by a Gaussian of the
   Mahalanobis distance from the robust mean, ``gauss_clamping`` zeroes
   outliers, ``none`` disables the term (the reference's three menu modes).
5. **Seam leveling (global, host)** — a per-(vertex, view-label) additive
   color correction that pulls every label's vertex color to the
   cross-label mean, interpolated barycentrically over each face —
   texrecon's global adjustment with the smoothness term dropped.
6. **Atlas** — one square block per face (lower-left triangle + 1px gutter),
   colors bilinearly gathered from the winning view on the device in
   chunks of faces; OBJ + MTL + PNG export on the host.

Profiler spans: ``texture.visibility`` (projection, z-buffers, scores and
mean colors) and ``texture.sample`` (the atlas texels). Not ported yet: the
project-store entry point ``texture_project_mesh`` (with the project store).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch.profiler import record_function

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.core import cameras
from regard3d_tpu_torch.core.sfm_data import _np
from regard3d_tpu_torch.core.types import Scene

_BIG = 3.0e38

# fixed barycentric sampling pattern for visibility / mean color:
# 3 corners (pulled slightly inward), 3 edge midpoints, centroid
_BARY = np.array([
    [0.90, 0.05, 0.05], [0.05, 0.90, 0.05], [0.05, 0.05, 0.90],
    [0.475, 0.475, 0.05], [0.05, 0.475, 0.475], [0.475, 0.05, 0.475],
    [1 / 3, 1 / 3, 1 / 3]], np.float32)


@dataclass
class TexturedMesh:
    verts: np.ndarray    # (V, 3)
    faces: np.ndarray    # (F, 3) int
    uvs: np.ndarray      # (F, 3, 2) per-corner atlas coords in [0, 1]
    atlas: np.ndarray    # (A, A, 3) float in [0, 1]
    labels: np.ndarray   # (F,) int — winning view per face (-1 = none)


def _as_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def _stack_images(images: Sequence[np.ndarray]):
    """Pad to a common (H, W) and stack to (Nv, H, W, 3)."""
    rgb = [_as_rgb(np.asarray(i, np.float32)) for i in images]
    H = max(i.shape[0] for i in rgb)
    W = max(i.shape[1] for i in rgb)
    out = np.zeros((len(rgb), H, W, 3), np.float32)
    sizes = np.zeros((len(rgb), 2), np.int32)
    for k, im in enumerate(rgb):
        out[k, :im.shape[0], :im.shape[1]] = im
        sizes[k] = im.shape[:2]
    return out, sizes


def _bilinear_rgb(img, x, y, w, h):
    """img: (H, W, 3); x, y: (...) pixel coords; w, h: valid extent."""
    x = torch.clamp(torch.nan_to_num(x), 0.0, w - 1.001)
    y = torch.clamp(torch.nan_to_num(y), 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    p00 = img[y0, x0]
    p01 = img[y0, x0 + 1]
    p10 = img[y0 + 1, x0]
    p11 = img[y0 + 1, x0 + 1]
    return ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p01
            + (1 - fx) * fy * p10 + fx * fy * p11)


def _view_cameras(scene: Scene, view_ids: np.ndarray, device):
    """(R, C, model, params) of each view, on ``device``. Views index the
    pose table directly, as in the reference."""
    vid = torch.as_tensor(np.asarray(view_ids, np.int64))
    iid = torch.as_tensor(_np(scene.views.intrinsic_id)).long()[vid]
    return tuple(t.to(device) for t in (
        torch.as_tensor(_np(scene.poses.R))[vid],
        torch.as_tensor(_np(scene.poses.C))[vid],
        torch.as_tensor(_np(scene.intrinsics.model))[iid],
        torch.as_tensor(_np(scene.intrinsics.params))[iid]))


def _project_points(scene: Scene, view_ids: np.ndarray, P: torch.Tensor):
    """Project points (N, 3) into each view, on P's device. Returns
    (uv (Nv, N, 2), z (Nv, N))."""
    R, C, model, params = _view_cameras(scene, view_ids, P.device)
    return cameras.project(R[:, None], C[:, None], model[:, None],
                           params[:, None], P[None])


def _posed_view_ids(scene: Scene) -> np.ndarray:
    vm = _np(scene.views.mask)
    m = vm & _np(scene.poses.mask)[_np(scene.views.pose_id)]
    return np.nonzero(m)[0].astype(np.int32)


def _zbuffer(ix, iy, z, valid, buf_h: int, buf_w: int):
    """Scatter-min point-splat depth buffer (buf_h, buf_w). ix/iy/z: flat
    tensors of one device."""
    z = torch.where(valid, z, _BIG)
    buf = torch.full((buf_h * buf_w,), _BIG, dtype=torch.float32,
                     device=z.device)
    buf.scatter_reduce_(0, iy * buf_w + ix, z, "amin")
    return buf.reshape(buf_h, buf_w)


def face_view_data(scene: Scene, images_stacked, sizes, view_ids,
                   verts: np.ndarray, faces: np.ndarray,
                   zbuf_scale: int = 4, depth_tol: float = 0.01,
                   device=None):
    """Per-(view, face) visibility, geometric score and mean color, on
    ``cuda`` unless ``device="cpu"`` (views looped on the host).

    Returns (score (Nv, F), mean_color (Nv, F, 3)) as numpy. Score already
    contains visible-fraction × projected-area × cosine; zero where
    invisible."""
    dev = runtime.resolve_device(device)
    Nv = len(view_ids)
    F = len(faces)
    fv = verts[faces]                              # (F, 3, 3)
    e1 = fv[:, 1] - fv[:, 0]
    e2 = fv[:, 2] - fv[:, 0]
    n = np.cross(e1, e2)
    n_norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n_unit = torch.as_tensor(n / np.maximum(n_norm, 1e-12), device=dev)
    centroid = torch.as_tensor(fv.mean(1), device=dev)

    # barycentric sample points (F*S, 3)
    S = len(_BARY)
    samples = np.einsum("sk,fkd->fsd", _BARY, fv).reshape(-1, 3)
    Pj = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    imgs = torch.as_tensor(images_stacked, device=dev)

    uv, z = _project_points(scene, view_ids, Pj)   # (Nv, F*S, 2), (Nv, F*S)

    scores = torch.zeros((Nv, F), dtype=torch.float32, device=dev)
    means = torch.zeros((Nv, F, 3), dtype=torch.float32, device=dev)
    H, W = imgs.shape[1:3]
    buf_h = -(-H // zbuf_scale)
    buf_w = -(-W // zbuf_scale)

    Cs = torch.as_tensor(_np(scene.poses.C)[view_ids], device=dev)
    for k in range(Nv):
        w_k, h_k = int(sizes[k, 1]), int(sizes[k, 0])
        x = uv[k, :, 0]
        y = uv[k, :, 1]
        zs = z[k]
        inside = (zs > 1e-6) & (x >= 0) & (x <= w_k - 1) \
            & (y >= 0) & (y <= h_k - 1)
        # clamp before truncating: equal to the reference's truncate-then-
        # clip wherever it matters (inside samples), and no int overflow
        ix = torch.clamp(torch.nan_to_num(x / zbuf_scale), 0,
                         buf_w - 1).long()
        iy = torch.clamp(torch.nan_to_num(y / zbuf_scale), 0,
                         buf_h - 1).long()
        zb = _zbuffer(ix, iy, zs, inside, buf_h, buf_w)
        vis = inside & (zs <= zb[iy, ix] * (1.0 + depth_tol) + 1e-6)
        # visible share in float64, as numpy's mean of a bool array
        vis_frac = vis.reshape(F, S).sum(1, dtype=torch.float64) / S

        # geometric terms
        view_dir = Cs[k] - centroid
        dist = torch.linalg.norm(view_dir, dim=-1, keepdim=True)
        cosang = torch.sum(n_unit * (view_dir / torch.clamp_min(dist, 1e-12)),
                           -1)
        # projected triangle area (2D cross product of projected edges)
        p = uv[k].reshape(F, S, 2)
        e1p = p[:, 1] - p[:, 0]
        e2p = p[:, 2] - p[:, 0]
        a2d = torch.abs(e1p[:, 0] * e2p[:, 1] - e1p[:, 1] * e2p[:, 0]) * 0.5
        scores[k] = (vis_frac * torch.clamp_min(cosang, 0.0).double()
                     * a2d.double()).float()
        # mean color over visible samples
        col = _bilinear_rgb(imgs[k], x, y, w_k, h_k)
        wgt = vis.float()[:, None]
        csum = (col.reshape(F, S, 3) * wgt.reshape(F, S, 1)).sum(1)
        cnum = torch.clamp_min(wgt.reshape(F, S).sum(1), 1e-12)[:, None]
        means[k] = csum / cnum
    return _np(scores), _np(means)


def photometric_outlier_weights(scores: np.ndarray, means: np.ndarray,
                                mode: str = "gauss_damping",
                                clamp_sigma: float = 1.0,
                                rounds: int = 3) -> np.ndarray:
    """texrecon's photometric outlier removal over candidate views.

    The mean/variance is re-estimated iteratively with high-distance views
    rejected each round (texrecon's behaviour), so a strong outlier cannot
    inflate the statistics enough to mask itself.

    scores: (Nv, F); means: (Nv, F, 3). Returns per-(view, face) weight."""
    if mode in (None, "none"):
        return np.ones_like(scores)
    cand = scores > 0                                  # (Nv, F)
    keep = cand.copy()
    for _ in range(rounds):
        wsum = np.maximum(keep.sum(0), 1)              # (F,)
        mu = (means * keep[..., None]).sum(0) / wsum[:, None]
        d2 = ((means - mu[None]) ** 2).sum(-1)         # (Nv, F)
        var = np.maximum((d2 * keep).sum(0) / wsum, 1e-8)
        m2 = d2 / var
        # reject views beyond the clamp radius, but never drop below 2
        # survivors per face (the statistics would degenerate)
        new_keep = keep & (m2 <= clamp_sigma ** 2 * 3.0)
        enough = new_keep.sum(0) >= 2
        keep = np.where(enough[None, :], new_keep, keep)
    if mode == "gauss_clamping":
        return np.where(m2 <= clamp_sigma ** 2 * 3.0, 1.0, 0.0)
    if mode == "gauss_damping":
        return np.exp(-0.5 * m2).astype(np.float32)
    raise ValueError(f"unknown outlier-removal mode {mode}")


def select_views(scores: np.ndarray) -> np.ndarray:
    """Winning view index per face, -1 where no view sees the face."""
    lbl = scores.argmax(0).astype(np.int64)
    lbl[scores.max(0) <= 0] = -1
    return lbl


def _seam_pairs(verts, faces, labels, means, view_count: int):
    """Compact (vertex, label) seam-leveling corrections.

    Only the (vertex, label) pairs actually present in the mesh are
    materialized (a vertex touches a handful of labels, never all Nv), so
    memory is O(3F), not O(V*Nv). Returns (sorted unique keys (P,) with
    key = vertex*view_count + label, adjustment (P, 3))."""
    F = len(faces)
    ok = labels >= 0
    lbl = np.where(ok, labels, 0)
    fcol = means[lbl, np.arange(F)]                    # (F, 3) winning color
    keys = (faces.astype(np.int64) * view_count
            + lbl[:, None])[ok].reshape(-1)            # (3*F_ok,)
    fcol3 = np.repeat(fcol[ok], 3, axis=0)             # matching colors
    uniq, inv = np.unique(keys, return_inverse=True)
    P = len(uniq)
    csum = np.zeros((P, 3), np.float32)
    cnum = np.zeros((P,), np.float32)
    np.add.at(csum, inv, fcol3)
    np.add.at(cnum, inv, 1.0)
    cvl = csum / cnum[:, None]                         # color per (v, l)
    # cross-label mean per vertex over the pairs present
    vidx = uniq // view_count
    vuniq, vinv = np.unique(vidx, return_inverse=True)
    vsum = np.zeros((len(vuniq), 3), np.float32)
    vnum = np.zeros((len(vuniq),), np.float32)
    np.add.at(vsum, vinv, cvl)
    np.add.at(vnum, vinv, 1.0)
    target = vsum / vnum[:, None]                      # (Vu, 3)
    adj = target[vinv] - cvl                           # (P, 3)
    return uniq, adj.astype(np.float32)


def seam_level_global(verts, faces, labels, scores, means,
                      view_count: int):
    """Per-(vertex, label) additive correction (global seam leveling).

    For each vertex, the set of labels of its incident faces each get a
    correction pulling that label's local color to the cross-label mean.
    Returns the dense (V, view_count, 3) array — convenient for small
    scenes/tests; the texturing pipeline uses the compact ``_seam_pairs``
    representation directly."""
    uniq, adj_pairs = _seam_pairs(verts, faces, labels, means, view_count)
    adj = np.zeros((len(verts) * view_count, 3), np.float32)
    adj[uniq] = adj_pairs
    return adj.reshape(len(verts), view_count, 3)


def _sample_face_texels(images_stacked, fv, lbl, R, C, model, params,
                        sizes, adj_corners, bary):
    """Gather texel colors for a chunk of faces (tensors of one device).

    fv: (Fc, 3, 3) face verts; lbl: (Fc,) view per face; bary: (B, B, 3).
    Returns (Fc, B, B, 3)."""
    P = torch.einsum("xys,fsd->fxyd", bary, fv)        # (Fc, B, B, 3)
    uv, _ = cameras.project(R[lbl][:, None], C[lbl][:, None],
                            model[lbl][:, None], params[lbl][:, None],
                            P.reshape(P.shape[0], -1, 3))
    uv = torch.nan_to_num(uv.reshape(P.shape[:3] + (2,)))
    w = sizes[lbl, 1].float()
    h = sizes[lbl, 0].float()
    x = torch.minimum(torch.clamp_min(uv[..., 0], 0.0),
                      (w - 1.001)[:, None, None])
    y = torch.minimum(torch.clamp_min(uv[..., 1], 0.0),
                      (h - 1.001)[:, None, None])
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    li = lbl[:, None, None]
    p00 = images_stacked[li, y0, x0]
    p01 = images_stacked[li, y0, x0 + 1]
    p10 = images_stacked[li, y0 + 1, x0]
    p11 = images_stacked[li, y0 + 1, x0 + 1]
    col = ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p01
           + (1 - fx) * fy * p10 + fx * fy * p11)
    # seam-leveling: barycentric interpolation of per-corner adjustments
    col = col + torch.einsum("xys,fsd->fxyd", bary, adj_corners)
    return torch.clamp(col, 0.0, 1.0)


def _block_barycentrics(block: int, pad: int) -> np.ndarray:
    """(B, B, 3) barycentric coords of each texel in a face block; texels in
    the gutter / upper triangle are clamped onto the triangle (gutter fill)."""
    B = block
    T = B - 2 * pad - 1
    xs = (np.arange(B) - pad) / max(T, 1)
    b1, b2 = np.meshgrid(xs, xs, indexing="xy")        # b1 → v1, b2 → v2
    b1 = np.clip(b1, 0.0, 1.0)
    b2 = np.clip(b2, 0.0, 1.0)
    s = b1 + b2
    over = s > 1.0
    scale = np.where(over, 1.0 / np.maximum(s, 1e-12), 1.0)
    b1, b2 = b1 * scale, b2 * scale
    b0 = 1.0 - b1 - b2
    return np.stack([b0, b1, b2], -1).astype(np.float32)


def texture_mesh(scene: Scene, images: Sequence[np.ndarray],
                 verts: np.ndarray, faces: np.ndarray,
                 texel_res: int = 8, outlier_removal: str = "gauss_damping",
                 seam_leveling: str = "global", zbuf_scale: int = 4,
                 depth_tol: float = 0.01, chunk: int = 4096,
                 fallback_color=(0.5, 0.5, 0.5),
                 device=None) -> TexturedMesh:
    """Full texturing pipeline: mesh + posed views -> atlas-textured mesh,
    on ``cuda`` unless ``device="cpu"``."""
    dev = runtime.resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    view_ids = _posed_view_ids(scene)
    if len(view_ids) == 0 or len(faces) == 0:
        raise ValueError("texture_mesh needs posed views and faces")
    images_stacked, sizes = _stack_images(images)

    with torch.no_grad():
        imgs = torch.as_tensor(images_stacked, device=dev)
        with record_function("texture.visibility"):
            scores, means = face_view_data(
                scene, imgs, sizes, view_ids, verts, faces,
                zbuf_scale=zbuf_scale, depth_tol=depth_tol, device=dev)
    scores = scores * photometric_outlier_weights(scores, means,
                                                  outlier_removal)
    labels = select_views(scores)                      # index into view_ids

    Nv = len(view_ids)

    # --- atlas layout: one square block per face ------------------------
    pad = 1
    B = texel_res + 2 * pad + 1
    F = len(faces)
    nb = int(np.ceil(np.sqrt(F)))
    A = nb * B

    atlas = np.empty((A, A, 3), np.float32)
    atlas[:] = np.asarray(fallback_color, np.float32)
    ok = labels >= 0
    lbl_safe = np.where(ok, labels, 0)
    # per-face per-corner adjustment for its winning label, looked up in
    # the compact (vertex, label) pair table (no dense V*Nv array)
    adj_corners = np.zeros((F, 3, 3), np.float32)
    if seam_leveling == "global" and ok.any():
        uniq, adj_pairs = _seam_pairs(verts, faces, labels, means, Nv)
        keys = (faces.astype(np.int64) * Nv
                + lbl_safe[:, None]).reshape(-1)       # (3F,)
        pos = np.clip(np.searchsorted(uniq, keys), 0, len(uniq) - 1)
        hit = uniq[pos] == keys
        adj_corners = np.where(hit[:, None], adj_pairs[pos],
                               0.0).reshape(F, 3, 3).astype(np.float32)

    with torch.no_grad(), record_function("texture.sample"):
        bary = torch.as_tensor(_block_barycentrics(B, pad), device=dev)
        cams = _view_cameras(scene, view_ids, dev)
        sizes_t = torch.as_tensor(sizes, device=dev)
        fv_all = torch.as_tensor(verts[faces], device=dev)
        lbl_all = torch.as_tensor(lbl_safe, device=dev)
        adj_all = torch.as_tensor(adj_corners, device=dev)
        for s0 in range(0, F, chunk):
            s1 = min(s0 + chunk, F)
            cols = _np(_sample_face_texels(
                imgs, fv_all[s0:s1], lbl_all[s0:s1], *cams, sizes_t,
                adj_all[s0:s1], bary))
            fidx = np.arange(s0, s1)[ok[s0:s1]]
            if len(fidx):
                by, bx = np.divmod(fidx, nb)
                blocks = atlas.reshape(nb, B, nb, B, 3)
                blocks[by, :, bx] = cols[ok[s0:s1]]

    # per-corner uv coords (v0 at (pad,pad), v1 +x, v2 +y), atlas origin at
    # top-left, OBJ vt origin at bottom-left — flip on write, not here.
    T = texel_res
    fi = np.arange(F)
    by, bx = np.divmod(fi, nb)
    ox = (bx * B + pad).astype(np.float32)
    oy = (by * B + pad).astype(np.float32)
    uvs = np.stack([np.stack([ox, oy], -1),
                    np.stack([ox + T, oy], -1),
                    np.stack([ox, oy + T], -1)], 1)
    uvs = (uvs + 0.5) / A

    # map labels back to original view ids
    out_labels = np.where(ok, view_ids[lbl_safe], -1)
    return TexturedMesh(verts=verts, faces=faces, uvs=uvs, atlas=atlas,
                        labels=out_labels)


def write_textured_obj(prefix: str, mesh: TexturedMesh) -> str:
    """Write <prefix>.obj / .mtl / .png. Returns the OBJ path."""
    obj_path = prefix + ".obj"
    mtl_path = prefix + ".mtl"
    png_path = prefix + ".png"
    name = os.path.basename(prefix)

    from PIL import Image
    img = (np.clip(mesh.atlas, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(img).save(png_path)

    with open(mtl_path, "w") as f:
        f.write(f"newmtl {name}\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                f"map_Kd {os.path.basename(png_path)}\n")
    with open(obj_path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\nusemtl {name}\n")
        for v in mesh.verts:
            f.write("v %.6f %.6f %.6f\n" % tuple(v))
        for fuv in mesh.uvs:
            for uv in fuv:
                f.write("vt %.6f %.6f\n" % (uv[0], 1.0 - uv[1]))
        for i, face in enumerate(mesh.faces):
            t = 3 * i
            f.write("f %d/%d %d/%d %d/%d\n" % (
                face[0] + 1, t + 1, face[1] + 1, t + 2, face[2] + 1, t + 3))
    return obj_path
