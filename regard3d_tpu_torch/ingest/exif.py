"""EXIF metadata extraction (host-side ingest).

Equivalent of the reference's easyexif-based ``ExifParser``
(``src/utils/ExifParser.h:29-40``): camera maker/model, focal length (mm),
image dimensions, GPS latitude/longitude/altitude.  Uses PIL's EXIF decoding
instead of a vendored C parser.

Copy of ``regard3d_tpu/ingest/exif.py`` (the port imports nothing from the
reference package).
"""

from __future__ import annotations

import dataclasses

from PIL import ExifTags, Image


@dataclasses.dataclass
class ExifInfo:
    width: int = 0
    height: int = 0
    maker: str = ""
    model: str = ""
    focal_length_mm: float = 0.0
    focal_35mm: float = 0.0          # FocalLengthIn35mmFilm, 0 = absent
    sensor_width_mm: float = 0.0     # derived from FocalPlane*Resolution
    has_gps: bool = False
    latitude: float = 0.0     # degrees (+N)
    longitude: float = 0.0    # degrees (+E)
    altitude: float = 0.0     # meters


def _rational(v) -> float:
    try:
        return float(v)
    except (TypeError, ZeroDivisionError, ValueError):
        # some vendors store rationals as (num, den) tuples
        try:
            num, den = v
            return float(num) / float(den) if float(den) else 0.0
        except Exception:
            return 0.0


def _dms_to_deg(dms, ref: str) -> float:
    """GPS coordinate to degrees; tolerates the vendor variants easyexif
    handles: 3-part D/M/S, 2-part D/M, and single decimal-degree
    rationals."""
    try:
        parts = [_rational(x) for x in dms]
    except TypeError:
        parts = [_rational(dms)]
    d = sum(p / (60.0 ** i) for i, p in enumerate(parts[:3]))
    if ref in ("S", "W"):
        d = -d
    return d


def read_exif(path: str) -> ExifInfo:
    info = ExifInfo()
    with Image.open(path) as im:
        info.width, info.height = im.size
        try:
            exif = im.getexif()
        except Exception:
            return info
        if not exif:
            return info
        info.maker = str(exif.get(ExifTags.Base.Make, "")).strip("\x00 ")
        info.model = str(exif.get(ExifTags.Base.Model, "")).strip("\x00 ")
        try:
            sub = exif.get_ifd(ExifTags.IFD.Exif)
        except Exception:
            sub = {}
        fl = sub.get(ExifTags.Base.FocalLength, exif.get(ExifTags.Base.FocalLength))
        if fl is not None:
            info.focal_length_mm = _rational(fl)
        # 35mm-equivalent focal: lets the focal prior work even when the
        # body is missing from the sensor-width DB (f_px from crop factor)
        f35 = sub.get(ExifTags.Base.FocalLengthIn35mmFilm,
                      exif.get(ExifTags.Base.FocalLengthIn35mmFilm))
        if f35 is not None:
            info.focal_35mm = _rational(f35)
        # sensor width from the focal-plane resolution tags (px per unit):
        # sensor_mm = image_width_px / (xres * unit_to_mm)
        xres = sub.get(ExifTags.Base.FocalPlaneXResolution)
        runit = sub.get(ExifTags.Base.FocalPlaneResolutionUnit, 2)
        if xres is not None and _rational(xres) > 0:
            unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(
                int(_rational(runit)) or 2, 25.4)
            px_w = sub.get(ExifTags.Base.ExifImageWidth, info.width)
            try:
                px_w = int(_rational(px_w)) or info.width
            except Exception:
                px_w = info.width
            info.sensor_width_mm = px_w / _rational(xres) * unit_mm
        # pixel dims from EXIF override only if present & sane
        try:
            gps = exif.get_ifd(ExifTags.IFD.GPSInfo)
        except Exception:
            gps = {}
        if gps:
            lat = gps.get(ExifTags.GPS.GPSLatitude)
            lat_ref = str(gps.get(ExifTags.GPS.GPSLatitudeRef, "N"))
            lon = gps.get(ExifTags.GPS.GPSLongitude)
            lon_ref = str(gps.get(ExifTags.GPS.GPSLongitudeRef, "E"))
            if lat is not None and lon is not None:
                info.latitude = _dms_to_deg(lat, lat_ref)
                info.longitude = _dms_to_deg(lon, lon_ref)
                alt = gps.get(ExifTags.GPS.GPSAltitude)
                if alt is not None:
                    info.altitude = _rational(alt)
                    ref = gps.get(ExifTags.GPS.GPSAltitudeRef, 0)
                    try:
                        if int(ref) == 1:
                            info.altitude = -info.altitude
                    except (TypeError, ValueError):
                        pass
                info.has_gps = True
    return info
