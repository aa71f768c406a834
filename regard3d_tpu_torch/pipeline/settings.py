"""User settings store (Regard3DSettings parity).

The reference persists UI/user preferences through wxConfig
(``src/utils/Regard3DSettings.h:52-63``: camera-DB path, external-programs
path, default project path, mouse prefs).  Here: a JSON file at
``~/.config/regard3d_tpu/settings.json`` (or ``$R3D_SETTINGS_PATH``).

Copy of ``regard3d_tpu/pipeline/settings.py``: the same file, keys and
defaults, so both packages share one settings store.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "default_project_path": "",
    "sensor_db_path": "",            # CSV camera database
    "user_camera_db_path": "",       # sqlite user overrides
    "external_programs_dir": "",     # MVS/surface executables
    "max_image_dim": 0,              # 0 = native resolution
    "max_keypoints": 4096,
    "default_camera_model": "radial_k3",
}


def settings_path() -> str:
    p = os.environ.get("R3D_SETTINGS_PATH")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".config", "regard3d_tpu",
                        "settings.json")


class Settings:
    def __init__(self, path: str = ""):
        self.path = path or settings_path()
        self.values = dict(DEFAULTS)
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.values.update(json.load(f))
            except (json.JSONDecodeError, OSError):
                pass

    def get(self, key: str, default=None):
        return self.values.get(key, DEFAULTS.get(key, default))

    def set(self, key: str, value):
        self.values[key] = value

    def save(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.values, f, indent=1)
        os.replace(tmp, self.path)
