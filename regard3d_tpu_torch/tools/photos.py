"""Write a synthetic dataset as camera photos: JPEGs with EXIF and GPS.

The input of the command line's quick start (``init`` -> ``import`` -> ...)
on a scene with exact ground truth. Each view of an ``ingest.synth`` dataset
becomes ``view_XX.jpg`` with:

* ``Make`` / ``Model`` of a body in ``ingest.sensor_db.BUILTIN_SENSORS``
  and ``FocalLength`` in mm, so that ``import`` derives ``FOCAL_SCALE``
  times the true focal in pixels from the sensor width (the focal error
  the accuracy runs start from);
* GPS at the true camera centre: one scene unit is one metre in a local
  East-North-Up frame at ``ORIGIN`` (latitude, longitude, altitude), mapped
  through ECEF to latitude / longitude / altitude with ``ingest.geodesy``.
  Seconds are rationals over 10^5 (0.3 mm of latitude) and the altitude a
  rational over 10^4, so the positions read back within a millimetre.

JPEG quality 95.

Usage: ``python -m regard3d_tpu_torch.tools.photos OUT_DIR [--dataset
fountain] [--views 11] [--hw 1024] [--seed 0]``; the images are rendered on
the host (no device needed).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
from PIL import ExifTags, Image
from PIL.TiffImagePlugin import IFDRational

from regard3d_tpu_torch.ingest import geodesy

CAMERA = ("Canon", "Canon EOS 5D Mark III", 36.0)   # maker, model, width mm
ORIGIN = (47.3769, 8.5417, 408.0)                   # lat, lon (deg), alt (m)
FOCAL_SCALE = 1.03
SEC_DEN = 100_000
ALT_DEN = 10_000


def enu_to_ecef(enu: np.ndarray) -> np.ndarray:
    """Points of the East-North-Up frame at ``ORIGIN`` in ECEF."""
    _, o, R = geodesy.local_enu_frame([geodesy.lla_to_ecef(*ORIGIN)])
    return o + np.asarray(enu, np.float64) @ R


def _dms(v: float) -> Tuple[IFDRational, IFDRational, IFDRational]:
    v = abs(v)
    d = int(v)
    m = int((v - d) * 60)
    s = (v - d - m / 60.0) * 3600.0
    return (IFDRational(d, 1), IFDRational(m, 1),
            IFDRational(int(round(s * SEC_DEN)), SEC_DEN))


def write_exif_jpeg(path: str, img: np.ndarray, make: str, model: str,
                    focal_mm: float, gps=None):
    """``img``: (H, W) or (H, W, 3) floats in [0, 1]; ``gps``: (lat, lon,
    alt) or None."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    im = Image.fromarray(arr)
    exif = Image.Exif()
    exif[ExifTags.Base.Make] = make
    exif[ExifTags.Base.Model] = model
    sub = exif.get_ifd(ExifTags.IFD.Exif)
    sub[ExifTags.Base.FocalLength] = IFDRational(
        int(round(focal_mm * 10_000)), 10_000)
    if gps is not None:
        lat, lon, alt = gps
        g = exif.get_ifd(ExifTags.IFD.GPSInfo)
        g[ExifTags.GPS.GPSLatitude] = _dms(lat)
        g[ExifTags.GPS.GPSLatitudeRef] = "N" if lat >= 0 else "S"
        g[ExifTags.GPS.GPSLongitude] = _dms(lon)
        g[ExifTags.GPS.GPSLongitudeRef] = "E" if lon >= 0 else "W"
        g[ExifTags.GPS.GPSAltitude] = IFDRational(
            int(round(abs(alt) * ALT_DEN)), ALT_DEN)
        g[ExifTags.GPS.GPSAltitudeRef] = 0 if alt >= 0 else 1
    im.save(path, exif=exif, quality=95)


def write_dataset(ds, out_dir: str) -> List[str]:
    """Every view of ``ds`` (``synth.make_dataset``) as a JPEG with EXIF
    focal and GPS at its true centre; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    make, model, width_mm = CAMERA
    ecef = enu_to_ecef(ds["Cs"])
    paths = []
    for v, img in enumerate(ds["images"]):
        h, w = np.asarray(img).shape[:2]
        focal_mm = FOCAL_SCALE * ds["f"] * width_mm / max(w, h)
        path = os.path.join(out_dir, f"view_{v:02d}.jpg")
        write_exif_jpeg(path, img, make, model, focal_mm,
                        gps=geodesy.ecef_to_lla(*ecef[v]))
        paths.append(path)
    return paths


def main(argv=None):
    from regard3d_tpu_torch.ingest import synth
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--dataset", default="fountain")
    ap.add_argument("--views", type=int, default=11)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    ds = synth.make_dataset(args.dataset, n_cams=args.views, hw=args.hw,
                            seed=args.seed)
    for p in write_dataset(ds, args.out):
        print(p)


if __name__ == "__main__":
    main()
