"""Project store — persistent object tree + step-directory lifecycle.

Rebuilds ``R3DProject`` (src/R3DProject.h:71-425, src/R3DProject.cpp):

* object tree ``Project -> PictureSet -> ComputeMatches -> Triangulation ->
  Densification -> Surface`` with integer ids and parent links;
* per-step state machine ``invalid | running | failed | finished``
  (src/R3DProject.h:94-98);
* JSON persistence after every mutation (the reference uses boost XML,
  src/R3DProject.cpp:120-202) — every stage's artifacts live in its own
  directory so each stage is a resume point (SURVEY.md §5 checkpointing);
* path bundle equivalent to ``R3DProjectPaths`` (src/R3DProject.h:39-65).

Copy of ``regard3d_tpu/pipeline/project.py``: ``project.json`` keeps the
reference's schema, so a project written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

STATE_INVALID = "invalid"
STATE_RUNNING = "running"
STATE_FAILED = "failed"
STATE_FINISHED = "finished"

PROJECT_FILE = "project.json"


@dataclasses.dataclass
class ProjectObject:
    id: int
    kind: str                      # pictureset | matches | triangulation |
                                   # densification | surface
    parent_id: int                 # -1 for roots
    name: str = ""
    state: str = STATE_INVALID
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    results: Dict[str, Any] = dataclasses.field(default_factory=dict)
    running_time_s: float = 0.0


@dataclasses.dataclass
class Paths:
    """Step-directory bundle (R3DProjectPaths parity)."""
    project_dir: str
    matches_dir: str = ""
    triangulation_dir: str = ""
    densification_dir: str = ""
    surface_dir: str = ""

    @property
    def sfm_data_json(self):
        return os.path.join(self.matches_dir, "sfm_data.json")

    @property
    def matches_putative(self):
        return os.path.join(self.matches_dir, "matches.putative.txt")

    def matches_filtered(self, kind: str):
        return os.path.join(self.matches_dir, f"matches.{kind}.txt")

    @property
    def scene_npz(self):
        return os.path.join(self.triangulation_dir, "scene.npz")


class Project:
    """A photogrammetry project rooted at a directory."""

    def __init__(self, project_dir: str):
        self.project_dir = os.path.abspath(project_dir)
        self.objects: Dict[int, ProjectObject] = {}
        self.next_id = 0
        self.image_lists: Dict[int, List[str]] = {}   # pictureset id -> paths

    # ---- persistence ---------------------------------------------------
    @classmethod
    def create(cls, project_dir: str) -> "Project":
        os.makedirs(project_dir, exist_ok=True)
        p = cls(project_dir)
        p.save()
        return p

    @classmethod
    def load(cls, project_dir: str) -> "Project":
        p = cls(project_dir)
        path = os.path.join(p.project_dir, PROJECT_FILE)
        with open(path) as f:
            d = json.load(f)
        p.next_id = d["next_id"]
        for od in d["objects"]:
            p.objects[od["id"]] = ProjectObject(**od)
        p.image_lists = {int(k): v for k, v in d["image_lists"].items()}
        return p

    def save(self):
        d = {
            "version": 1,
            "saved_at": time.time(),
            "next_id": self.next_id,
            "objects": [dataclasses.asdict(o) for o in self.objects.values()],
            "image_lists": self.image_lists,
        }
        tmp = os.path.join(self.project_dir, PROJECT_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1)
        os.replace(tmp, os.path.join(self.project_dir, PROJECT_FILE))

    # ---- tree ----------------------------------------------------------
    def _add(self, kind: str, parent_id: int, name: str,
             params: Dict) -> ProjectObject:
        obj = ProjectObject(id=self.next_id, kind=kind, parent_id=parent_id,
                            name=name, params=params)
        self.objects[obj.id] = obj
        self.next_id += 1
        self.save()
        return obj

    def add_picture_set(self, name: str, image_paths: List[str]
                        ) -> ProjectObject:
        obj = self._add("pictureset", -1, name, {})
        self.image_lists[obj.id] = list(image_paths)
        self.save()
        return obj

    def add_compute_matches(self, pictureset_id: int,
                            params: Optional[Dict] = None) -> ProjectObject:
        assert self.objects[pictureset_id].kind == "pictureset"
        return self._add("matches", pictureset_id, "matches", params or {})

    def add_triangulation(self, matches_id: int,
                          params: Optional[Dict] = None) -> ProjectObject:
        assert self.objects[matches_id].kind == "matches"
        return self._add("triangulation", matches_id, "triangulation",
                         params or {})

    def add_densification(self, triangulation_id: int,
                          params: Optional[Dict] = None) -> ProjectObject:
        assert self.objects[triangulation_id].kind == "triangulation"
        return self._add("densification", triangulation_id, "densification",
                         params or {})

    def add_surface(self, densification_id: int,
                    params: Optional[Dict] = None) -> ProjectObject:
        assert self.objects[densification_id].kind == "densification"
        return self._add("surface", densification_id, "surface", params or {})

    def children(self, obj_id: int) -> List[ProjectObject]:
        return [o for o in self.objects.values() if o.parent_id == obj_id]

    def ancestors(self, obj_id: int) -> List[ProjectObject]:
        out = []
        cur = self.objects[obj_id]
        while cur.parent_id >= 0:
            cur = self.objects[cur.parent_id]
            out.append(cur)
        return out

    def remove(self, obj_id: int, delete_files: bool = True):
        """Remove an object and its whole subtree (delete* parity)."""
        for c in self.children(obj_id):
            self.remove(c.id, delete_files)
        obj = self.objects.pop(obj_id)
        if delete_files:
            d = self._step_dir(obj)
            if d and os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
        self.image_lists.pop(obj_id, None)
        self.save()

    # ---- step dirs -----------------------------------------------------
    def _step_dir(self, obj: ProjectObject) -> str:
        return os.path.join(self.project_dir, f"{obj.kind}_{obj.id}")

    def prepare(self, obj_id: int) -> str:
        """Create (wiping previous content) the step directory —
        prepareComputeMatches/prepareTriangulation parity
        (src/R3DProject.cpp:1322-1482)."""
        obj = self.objects[obj_id]
        d = self._step_dir(obj)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.makedirs(d)
        obj.state = STATE_RUNNING
        self.save()
        return d

    def paths(self, obj_id: int) -> Paths:
        """Path bundle for a leaf object, resolving ancestor step dirs."""
        chain = [self.objects[obj_id]] + self.ancestors(obj_id)
        p = Paths(project_dir=self.project_dir)
        for o in chain:
            d = self._step_dir(o)
            if o.kind == "matches":
                p.matches_dir = d
            elif o.kind == "triangulation":
                p.triangulation_dir = d
            elif o.kind == "densification":
                p.densification_dir = d
            elif o.kind == "surface":
                p.surface_dir = d
        return p

    def finish(self, obj_id: int, results: Dict, running_time_s: float):
        obj = self.objects[obj_id]
        obj.state = STATE_FINISHED
        obj.results = results
        obj.running_time_s = running_time_s
        self.save()

    def fail(self, obj_id: int, message: str):
        obj = self.objects[obj_id]
        obj.state = STATE_FAILED
        obj.results = {"error": message}
        self.save()

    def ensure_images_present(self, pictureset_id: int) -> List[str]:
        """ensureImageFilesArePresent parity (src/R3DProject.cpp:213)."""
        missing = [p for p in self.image_lists.get(pictureset_id, [])
                   if not os.path.exists(p)]
        return missing
