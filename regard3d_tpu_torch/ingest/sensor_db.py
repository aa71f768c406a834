"""Camera sensor-width databases.

Two tiers, matching the reference:

* **CSV database** (``CameraDBLookup``, src/utils/CameraDBLookup.cpp):
  ``maker;model;sensor_width_mm`` lines, exact then fuzzy token matching
  (``:131-147``: blank-stripped exact match, else maker-token match + all
  digit-bearing model tokens present).
* **User database** (``UserCameraDB``, src/utils/UserCameraDB.cpp:70):
  sqlite table ``CameraDB(cameraMaker, cameraModel, sensorWidth)`` consulted
  *before* the CSV (src/threads/ImageInfoThread.cpp behaviour).

A small built-in table covers common cameras when no CSV is installed.

Copy of ``regard3d_tpu/ingest/sensor_db.py`` (the port imports nothing
from the reference package).
"""

from __future__ import annotations

import os
import re
import sqlite3
from typing import List, Optional, Tuple

# A starter database (maker, model, sensor width mm). The full OpenMVG
# sensor_database.csv can be dropped in via `SensorDB(csv_path=...)`.
BUILTIN_SENSORS: List[Tuple[str, str, float]] = [
    ("Canon", "Canon EOS 5D Mark III", 36.0),
    ("Canon", "Canon EOS 5D Mark II", 35.8),
    ("Canon", "Canon EOS 6D", 35.8),
    ("Canon", "Canon EOS 7D", 22.3),
    ("Canon", "Canon EOS 70D", 22.5),
    ("Canon", "Canon EOS 600D", 22.3),
    ("Canon", "Canon EOS 550D", 22.3),
    ("Canon", "Canon PowerShot S95", 7.6),
    ("Canon", "Canon PowerShot G12", 7.6),
    ("Canon", "Canon IXUS 220HS", 6.16),
    ("Nikon", "NIKON D800", 35.9),
    ("Nikon", "NIKON D700", 36.0),
    ("Nikon", "NIKON D90", 23.6),
    ("Nikon", "NIKON D5100", 23.6),
    ("Nikon", "NIKON D3200", 23.2),
    ("Nikon", "COOLPIX P7000", 7.6),
    ("Sony", "NEX-5N", 23.4),
    ("Sony", "NEX-7", 23.5),
    ("Sony", "ILCE-7M3", 35.8),
    ("Sony", "DSC-RX100", 13.2),
    ("Fujifilm", "X-T2", 23.6),
    ("Fujifilm", "FinePix F600EXR", 6.4),
    ("Olympus", "E-M5", 17.3),
    ("Panasonic", "DMC-GH2", 17.3),
    ("Apple", "iPhone 6", 4.89),
    ("Apple", "iPhone 7", 4.8),
    ("Apple", "iPhone 8", 4.8),
    ("Apple", "iPhone X", 5.6),
    ("Google", "Pixel 3", 5.76),
    ("samsung", "SM-G930F", 5.76),
]

_DIGIT_RE = re.compile(r"\d")


def _norm(s: str) -> str:
    return s.strip().lower()


def _tokens(s: str) -> List[str]:
    return [t for t in re.split(r"[ \-]+", s.lower()) if t]


class SensorDB:
    """CSV-backed sensor width lookup with the reference's fuzzy matching."""

    def __init__(self, csv_path: Optional[str] = None):
        self.entries: List[Tuple[str, str, float]] = []
        if csv_path and os.path.exists(csv_path):
            with open(csv_path, errors="replace") as f:
                for line in f:
                    parts = line.rstrip("\n").split(";")
                    if len(parts) >= 3:
                        try:
                            self.entries.append(
                                (parts[0], parts[1], float(parts[2])))
                        except ValueError:
                            continue
        else:
            self.entries = list(BUILTIN_SENSORS)

    def lookup(self, maker: str, model: str) -> Optional[float]:
        """Exact match first; else the reference's partial matching — succeeds
        only when exactly one entry matches partially."""
        if not maker and not model:
            return None
        for mk, md, wmm in self.entries:
            if _norm(mk) == _norm(maker) and _norm(md) == _norm(model):
                return wmm

        partial = []
        for mk, md, wmm in self.entries:
            if self._matches_partly(maker, model, mk, md):
                partial.append(wmm)
        if len(partial) == 1:
            return partial[0]
        return None

    @staticmethod
    def _matches_partly(maker, model, db_maker, db_model) -> bool:
        # blank-stripped exact
        if (maker.replace(" ", "").lower() == db_maker.replace(" ", "").lower()
                and model.replace(" ", "").lower()
                == db_model.replace(" ", "").lower()):
            return True
        # maker word match + all digit-bearing model tokens present in DB model
        db_model_tokens = _tokens(db_model)
        for token in _tokens(maker):
            if token == db_maker.lower():
                ok = True
                for mt in _tokens(model):
                    if _DIGIT_RE.search(mt) and mt not in db_model_tokens:
                        ok = False
                        break
                if ok:
                    return True
        return False


class UserCameraDB:
    """SQLite-backed user overrides (schema parity with UserCameraDB.cpp:70)."""

    def __init__(self, path: str):
        self.path = path
        self._conn = sqlite3.connect(path)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS CameraDB ("
            "cameraMaker TEXT, cameraModel TEXT, sensorWidth REAL)")
        self._conn.commit()

    def lookup(self, maker: str, model: str) -> Optional[float]:
        cur = self._conn.execute(
            "SELECT sensorWidth FROM CameraDB WHERE cameraMaker = ? COLLATE "
            "NOCASE AND cameraModel = ? COLLATE NOCASE", (maker, model))
        row = cur.fetchone()
        return float(row[0]) if row else None

    def add(self, maker: str, model: str, sensor_width_mm: float):
        self._conn.execute("DELETE FROM CameraDB WHERE cameraMaker = ? "
                           "COLLATE NOCASE AND cameraModel = ? COLLATE NOCASE",
                           (maker, model))
        self._conn.execute("INSERT INTO CameraDB VALUES (?, ?, ?)",
                           (maker, model, sensor_width_mm))
        self._conn.commit()

    def all_entries(self):
        return list(self._conn.execute("SELECT * FROM CameraDB"))

    def remove(self, maker: str, model: str):
        self._conn.execute("DELETE FROM CameraDB WHERE cameraMaker = ? "
                           "COLLATE NOCASE AND cameraModel = ? COLLATE NOCASE",
                           (maker, model))
        self._conn.commit()

    def close(self):
        self._conn.close()


def lookup_sensor_width(maker: str, model: str,
                        user_db: Optional[UserCameraDB] = None,
                        sensor_db: Optional[SensorDB] = None
                        ) -> Optional[float]:
    """User DB first, then CSV DB (ImageInfoThread order)."""
    if user_db is not None:
        w = user_db.lookup(maker, model)
        if w:
            return w
    if sensor_db is None:
        sensor_db = SensorDB()
    return sensor_db.lookup(maker, model)
