"""Port parity: host ingest (``ingest/{geodesy,exif,sensor_db,intrinsics,
image_io}.py``) and the photo writer (``tools/photos.py``) against the JAX
package, on the CPU.

Tolerances: geodesy within 1e-12 relative (the same float64 formulas);
everything else identical: ``ExifInfo`` field by field on JPEG fixtures
written with the reference tests' EXIF pattern, ``lookup_sensor_width`` on
exact and fuzzy maker/model strings (built-in table, a CSV and a user
sqlite DB), ``focal_prior`` and ``build_intrinsics`` array-equal,
``load_rgb`` array-equal.
"""

import dataclasses
import os

import numpy as np
import pytest

from regard3d_tpu.core.types import PINHOLE, RADIAL_K3
from regard3d_tpu.ingest import exif as jexif
from regard3d_tpu.ingest import geodesy as jgeo
from regard3d_tpu.ingest import image_io as jio
from regard3d_tpu.ingest import intrinsics as jintr
from regard3d_tpu.ingest import sensor_db as jsdb
from regard3d_tpu_torch.ingest import exif as texif
from regard3d_tpu_torch.ingest import geodesy as tgeo
from regard3d_tpu_torch.ingest import image_io as tio
from regard3d_tpu_torch.ingest import intrinsics as tintr
from regard3d_tpu_torch.ingest import sensor_db as tsdb
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.tools import photos
from tests.test_ingest import _write_exif_jpeg


def test_geodesy_matches_reference():
    rng = np.random.default_rng(0)
    lla = np.stack([rng.uniform(-89, 89, 32), rng.uniform(-180, 180, 32),
                    rng.uniform(-400, 9000, 32)], 1)
    for p in lla:
        ej, et = np.array(jgeo.lla_to_ecef(*p)), np.array(tgeo.lla_to_ecef(*p))
        np.testing.assert_allclose(et, ej, rtol=1e-12)
        np.testing.assert_allclose(tgeo.ecef_to_lla(*et),
                                   jgeo.ecef_to_lla(*ej), rtol=1e-12)
    ecef = np.array([jgeo.lla_to_ecef(47.3 + 1e-4 * i, 8.5, 400.0 + i)
                     for i in range(6)])
    for a, b in zip(tgeo.local_enu_frame(ecef), jgeo.local_enu_frame(ecef)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def _fixtures(d):
    """JPEGs in the reference tests' EXIF pattern: DB body + GPS, 35 mm
    focal, focal-plane resolution, southern / western GPS, no EXIF."""
    from PIL import Image
    out = {}
    specs = {
        "db_gps": dict(gps=(47.3769, 8.5417, 408.2)),
        "f35": dict(make="Foo", model="Bar 9", f35=50),
        "fplane": dict(make="Foo", model="Bar 9",
                       fpxres=(320 * 254, 224)),     # 22.4 mm over 320 px
        "south_west": dict(gps=(-33.86, -151.2, 12.5)),
        "nikon": dict(make="NIKON CORPORATION", model="NIKON D800",
                      focal_mm=35.0),
    }
    for name, kw in specs.items():
        out[name] = str(d / f"{name}.jpg")
        _write_exif_jpeg(out[name], **kw)
    out["plain"] = str(d / "plain.png")
    Image.new("RGB", (64, 48), (10, 20, 30)).save(out["plain"])
    return out


def test_exif_and_focal_priors_match_reference(tmp_path):
    paths = _fixtures(tmp_path)
    views_j, views_t = [], []
    for name, p in paths.items():
        ij, it = jexif.read_exif(p), texif.read_exif(p)
        assert dataclasses.asdict(it) == dataclasses.asdict(ij), name
        for w in (None, 0.0, 36.0, 6.16):
            vj, vt = jintr.focal_prior(ij, w), tintr.focal_prior(it, w)
            assert dataclasses.asdict(vt) == dataclasses.asdict(vj), (name, w)
            views_j.append(vj)
            views_t.append(vt)
    assert {v.from_exif for v in views_t} == {True, False}
    for model in (PINHOLE, RADIAL_K3):
        for a, b in zip(tintr.build_intrinsics(views_t, model),
                        jintr.build_intrinsics(views_j, model)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for v in ([(1, 2), (3, 0)], [2.5], ["x"], None, (7, 2)):
        assert texif._rational(v) == jexif._rational(v)
    for dms, ref in (((47, 22, 36.84), "N"), ((8, 32.5), "W"), (33.2, "S")):
        assert texif._dms_to_deg(dms, ref) == jexif._dms_to_deg(dms, ref)


QUERIES = [
    ("Canon", "Canon EOS 5D Mark III"), ("canon", "canon eos 5d mark iii"),
    ("Canon", "CanonEOS5D Mark III"), ("Canon", "Canon EOS 550D"),
    ("Canon", "EOS 550D"), ("Canon", "Canon EOS 7D"), ("Canon", "7D"),
    ("NIKON CORPORATION", "NIKON D800"), ("Nikon", "D90"),
    ("NIKON", "COOLPIX P7000"), ("SONY", "NEX-7"), ("Sony", "ILCE-7M3"),
    ("Apple", "iPhone 7"), ("Apple", "iPhone 8 Plus"),
    ("samsung", "SM-G930F"), ("Google", "Pixel 3"), ("Fujifilm", "X-T2"),
    ("Unknown", "Camera 1"), ("", ""), ("Canon", ""), ("Olympus", "E-M5"),
    ("Panasonic", "DMC GH2"),
]


def test_sensor_width_lookup_matches_reference(tmp_path):
    csv = tmp_path / "sensors.csv"
    csv.write_text("Acme;Acme Shot 100;6.2\nAcme;Acme Shot 200;7.5\n"
                   "Canon;Canon EOS 7D;22.3\nbad line\nX;Y;notanumber\n")
    user = str(tmp_path / "user.db")
    udb_t = tsdb.UserCameraDB(user)
    udb_t.add("Apple", "iPhone 7", 5.0)
    udb_t.close()
    udb_j, udb_t = jsdb.UserCameraDB(user), tsdb.UserCameraDB(user)
    assert udb_t.all_entries() == udb_j.all_entries()
    got = []
    for q in QUERIES + [("Acme", "Acme Shot 100"), ("Acme", "Shot 200")]:
        for kw_j, kw_t in (({}, {}),
                           ({"sensor_db": jsdb.SensorDB(str(csv))},
                            {"sensor_db": tsdb.SensorDB(str(csv))}),
                           ({"user_db": udb_j}, {"user_db": udb_t})):
            wj = jsdb.lookup_sensor_width(*q, **kw_j)
            wt = tsdb.lookup_sensor_width(*q, **kw_t)
            assert wt == wj, (q, kw_t)
            got.append(wt)
    assert sum(w is not None for w in got) >= 30
    assert tsdb.BUILTIN_SENSORS == jsdb.BUILTIN_SENSORS
    udb_j.close()
    udb_t.close()


def test_photos_round_trip_through_both_readers(tmp_path):
    """The photo writer: both packages read the same EXIF; the focal prior
    gives the written focal scale, the GPS reads back within a millimetre
    after ENU."""
    ds = tsynth.make_dataset("fountain", n_cams=11, hw=96, seed=0)
    ds = dict(ds, images=ds["images"][:3], Cs=ds["Cs"][:3])
    paths = photos.write_dataset(ds, str(tmp_path))
    ecef = []
    for p in paths:
        it = texif.read_exif(p)
        assert dataclasses.asdict(it) == dataclasses.asdict(jexif.read_exif(p))
        w = tsdb.lookup_sensor_width(it.maker, it.model)
        assert w == photos.CAMERA[2]
        f = tintr.focal_prior(it, w).focal_px
        assert f == pytest.approx(1.03 * ds["f"], rel=1e-6)
        ecef.append(tgeo.lla_to_ecef(it.latitude, it.longitude, it.altitude))
        np.testing.assert_array_equal(tio.load_rgb(p), jio.load_rgb(p))
        np.testing.assert_array_equal(tio.load_gray(p), jio.load_gray(p))
    local, origin, R = tgeo.local_enu_frame(np.array(ecef))
    true = (photos.enu_to_ecef(ds["Cs"]) - origin) @ R.T
    assert np.abs(local - true).max() < 1e-3
    assert os.path.basename(paths[0]) == "view_00.jpg"
