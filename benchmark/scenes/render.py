"""Textured-quad scenes ray-cast on the run's device.

A scene is a few textured parallelograms and cameras on an arc, with exact
poses. Textures are random fields with detail at every octave, down to
about one and a half pixels of the nearest view, drawn on the host from the
seed; the rays, the hits and the bilinear lookups run in float64 on the
device, a block of rows at a time, with ``SS`` x ``SS`` rays a pixel
averaged (a pixel integrates its area, so the finest octave does not alias
where a plane is seen at a slant). The layout follows the port's synthetic
stand-ins (``ingest/synth.py``), widened to a 3:2 frame.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

SS = 2                       # rays a pixel along each axis
BLOCK_RAYS = 1 << 22         # rays a device block holds


def rng_of(seed: int) -> np.random.Generator:
    """The scene's generator: any whole number is a seed."""
    return np.random.default_rng(int(seed) & ((1 << 64) - 1))


def _smooth(t: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of a (H, W) field, reflected borders."""
    r = max(1, int(3 * sigma))
    x = torch.arange(-r, r + 1, dtype=t.dtype)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    t = torch.nn.functional.pad(t[None, None], (r, r, r, r), mode="reflect")
    t = torch.nn.functional.conv2d(t, k.view(1, 1, -1, 1))
    return torch.nn.functional.conv2d(t, k.view(1, 1, 1, -1))[0, 0]


def detail_texture(rng: np.random.Generator, h: int, w: int,
                   octaves: int = 6, sigma: float = 0.6) -> np.ndarray:
    """An (h, w) texture in [0, 1]: smoothed uniform noise at ``octaves``
    sizes, each coarser octave at half the size and 1.25 times the weight,
    upsampled bilinearly and summed (detail at every scale, as in a photo).
    """
    out = torch.zeros((h, w), dtype=torch.float64)
    for k in range(octaves):
        hh, ww = max(h >> k, 4), max(w >> k, 4)
        t = torch.from_numpy(rng.uniform(0.0, 1.0, size=(hh, ww)))
        t = _smooth(t, sigma) - 0.5
        if (hh, ww) != (h, w):
            t = torch.nn.functional.interpolate(
                t[None, None], size=(h, w), mode="bilinear",
                align_corners=True)[0, 0]
        out += (1.25 ** k) * t
    out = (out - out.min()) / (out.max() - out.min())
    return out.to(torch.float32).numpy()


def look_at(C: np.ndarray, target: np.ndarray,
            up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-to-camera rotation whose +z axis points at ``target``."""
    z = np.asarray(target, np.float64) - C
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _bilinear(tex: torch.Tensor, s: torch.Tensor, t: torch.Tensor):
    H, W = tex.shape
    x = s * (W - 1)
    y = t * (H - 1)
    x0 = torch.clamp(x.long(), 0, W - 2)
    y0 = torch.clamp(y.long(), 0, H - 2)
    fx = x - x0
    fy = y - y0
    return ((1 - fx) * (1 - fy) * tex[y0, x0] + fx * (1 - fy) * tex[y0, x0 + 1]
            + (1 - fx) * fy * tex[y0 + 1, x0] + fx * fy * tex[y0 + 1, x0 + 1])


def _shade(quads, texs, d_world, C: np.ndarray):
    """The nearest quad's texture value along each ray from ``C`` (0 where
    none)."""
    dt = d_world.dtype
    dev = d_world.device
    Ct = torch.as_tensor(C, dtype=dt, device=dev)
    img = torch.zeros(d_world.shape[:-1], dtype=dt, device=dev)
    zbuf = torch.full(d_world.shape[:-1], float("inf"), dtype=dt, device=dev)
    for (o, u, v, _), texd in zip(quads, texs):
        n = np.cross(u, v)
        n /= np.linalg.norm(n)
        g = np.linalg.inv(np.array([[u @ u, u @ v], [u @ v, v @ v]]))
        denom = d_world @ torch.as_tensor(n, dtype=dt, device=dev)
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        t_hit = float((o - C) @ n) / denom
        rel = Ct + t_hit[..., None] * d_world - torch.as_tensor(
            o, dtype=dt, device=dev)
        s_ = rel @ torch.as_tensor(g[0, 0] * u + g[0, 1] * v, dtype=dt,
                                   device=dev)
        t_ = rel @ torch.as_tensor(g[1, 0] * u + g[1, 1] * v, dtype=dt,
                                   device=dev)
        ok = ((t_hit > 1e-6) & (s_ >= 0) & (s_ <= 1) & (t_ >= 0) & (t_ <= 1)
              & (t_hit < zbuf))
        val = _bilinear(texd, torch.clamp(s_, 0, 1), torch.clamp(t_, 0, 1))
        img = torch.where(ok, val, img)
        zbuf = torch.where(ok, t_hit, zbuf)
    return img


def render(quads: Sequence[tuple], R: np.ndarray, C: np.ndarray, f: float,
           size: Tuple[int, int], device, texs=None) -> np.ndarray:
    """One pinhole view, ``size`` = (width, height), focal ``f``, principal
    point at (width / 2, height / 2), of ``quads`` = [(origin, u, v,
    texture)]; the nearest hit wins. Pixel (x, y) is the mean of ``SS`` x
    ``SS`` rays spread evenly over the pixel around (x, y)."""
    dt = torch.float64
    w, h = size
    if texs is None:
        texs = [torch.as_tensor(q[3], dtype=dt, device=device) for q in quads]
    Rt = torch.as_tensor(R, dtype=dt, device=device)
    C = np.asarray(C, np.float64)
    sub = (torch.arange(SS, dtype=dt, device=device) + 0.5) / SS - 0.5
    rows = max(1, BLOCK_RAYS // (w * SS * SS))
    xs = (torch.arange(w, dtype=dt, device=device)[:, None] + sub).reshape(-1)
    out = torch.empty((h, w), dtype=torch.float32, device=device)
    for y0 in range(0, h, rows):
        y1 = min(h, y0 + rows)
        ys = (torch.arange(y0, y1, dtype=dt, device=device)[:, None]
              + sub).reshape(-1)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        d_cam = torch.stack([(gx - w / 2.0) / f, (gy - h / 2.0) / f,
                             torch.ones_like(gx)], -1)
        img = _shade(quads, texs, d_cam @ Rt, C)
        img = img.view(y1 - y0, SS, w, SS).mean(dim=(1, 3))
        out[y0:y1] = img.to(torch.float32)
    return out.cpu().numpy()


def shuffled(scene: Dict, seed: int) -> Dict:
    """The scene's views in an order drawn from ``seed``: every seed hands
    the step the same photos, so the work of a step does not follow the
    seed, while the pairs' orientation and every draw of the step do."""
    order = rng_of(seed).permutation(len(scene["images"]))
    return dict(scene, images=[scene["images"][k] for k in order],
                Rs=scene["Rs"][order], Cs=scene["Cs"][order])


def render_arc(quads: List[tuple], Cs: np.ndarray, target: np.ndarray,
               f: float, size: Tuple[int, int], device) -> Dict:
    """Every camera of ``Cs`` looking at ``target``: the scene dict the steps
    take (images, exact rotations and centres, focal, (width, height), and
    the planes as (origin, u, v) for the reference's exact geometry)."""
    Rs = np.stack([look_at(C, target) for C in Cs])
    texs = [torch.as_tensor(q[3], dtype=torch.float64, device=device)
            for q in quads]
    images = [render(quads, R, C, f, size, device, texs)
              for R, C in zip(Rs, Cs)]
    return dict(images=images, Rs=Rs, Cs=np.asarray(Cs, np.float64),
                f=float(f), size=(int(size[0]), int(size[1])),
                planes=[(o, u, v) for o, u, v, _ in quads])


def texels(size: Tuple[int, int], extent: float) -> int:
    """Texels along a plane's side of ``extent`` units: 205 a unit in a
    frame 2048 pixels high (the nearest planes then show about 1.4 pixels
    a texel), scaled with the frame's height."""
    return max(16, int(round(extent * 205.0 * size[1] / 2048.0)))
