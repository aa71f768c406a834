"""Multi-process runs of the port's command line (``r3d launch``), on the
CPU: gloo ranks started by ``launch -n 2`` (``dist/launch.py``), each
bounded by the launcher's timeout (every rank is killed when one fails or
time runs out).

The project: 4 fountain views at 192 px written as camera JPEGs with EXIF
focal and GPS (``tools/photos.py``), imported once and copied.

* ``launch -n 2 -- matches`` (512 keypoints, 64 RANSAC iterations, high
  sensitivity) writes ``.feat``, ``.desc`` and ``matches.{putative,f,e,h}
  .txt`` byte-identical to a one-process ``matches`` with the same
  arguments, plus each rank's ``matches.*.part{p}.txt``;
* ``launch -n 2 -- sfm --dist-ba`` on those matches finishes: one new
  triangulation step, ``finished``, its artifacts in its directory and
  nothing else added to the project, its parameters those the reference
  CLI stores for the same command, every camera posed;
* a secondary skips a subcommand that is not distributed (``info``).
"""

import functools
import os
import shutil

import pytest
import torch

from regard3d_tpu import cli as jcli
from regard3d_tpu_torch.dist import launch as dlaunch
from regard3d_tpu_torch.pipeline.project import Project as TProject
from regard3d_tpu_torch.tools import photos
from tests.test_torch_project_cli import _dataset, port

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS = 4
MATCH_ARGS = ["--max-keypoints", "512", "--ransac-iters", "64",
              "--sensitivity", "high"]
ARTIFACTS = [f"image{i:06d}.{e}" for i in range(N_VIEWS)
             for e in ("feat", "desc")] + [
    f"matches.{k}.txt" for k in ("putative", "f", "e", "h")]


def launch(tmp, *argv):
    """``r3d --device cpu launch -n 2 ... -- <argv>`` in this process; the
    ranks are child processes, killed after 600 s (the launcher's
    ``timeout``). Returns the launcher's exit code."""
    with pytest.MonkeyPatch.context() as m, \
            pytest.raises(SystemExit) as e:
        m.setattr(dlaunch, "launch_local",
                  functools.partial(dlaunch.launch_local, timeout=600))
        port("launch", "-n", "2", "--log-dir", str(tmp / "logs"), "--",
             *argv)
    return e.value.code


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    base = tmp_path_factory.mktemp("mp")
    ds = _dataset()
    ds = dict(ds, images=ds["images"][:N_VIEWS], Cs=ds["Cs"][:N_VIEWS],
              Rs=ds["Rs"][:N_VIEWS])
    paths = photos.write_dataset(ds, str(base / "photos"))
    one, two = str(base / "one"), str(base / "two")
    port("init", one)
    port("import", one, *paths)
    shutil.copytree(one, two)
    port("matches", one, *MATCH_ARGS)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("PYTHONPATH", os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        m.setenv("OMP_NUM_THREADS", "2")     # as every test worker
        m.setenv(dlaunch.ENV_TIMEOUT, "300")  # every wait of a rank
        rc = launch(base, "matches", two, *MATCH_ARGS)
        assert rc == 0, (base / "logs" / "proc1.log").read_text()
        before = set(os.listdir(two))
        rc_sfm = launch(base, "sfm", two, "--dist-ba")
        logs_sfm = (base / "logs" / "proc1.log").read_text()
        rc_info = launch(base, "info", two)
        logs_info = (base / "logs" / "proc1.log").read_text()
    return dict(base=base, one=one, two=two, before=before, rc_sfm=rc_sfm,
                logs_sfm=logs_sfm, rc_info=rc_info, logs_info=logs_info)


def test_two_process_matches_byte_identical(projects):
    d1 = TProject.load(projects["one"]).paths(1).matches_dir
    d2 = TProject.load(projects["two"]).paths(1).matches_dir
    for name in ARTIFACTS:
        with open(os.path.join(d1, name), "rb") as a, \
                open(os.path.join(d2, name), "rb") as b:
            assert a.read() == b.read(), name
    for p in (0, 1):
        for k in ("putative", "f", "e", "h"):
            assert os.path.exists(os.path.join(d2,
                                               f"matches.{k}.part{p}.txt"))
    p2 = TProject.load(projects["two"])
    assert p2.objects[1].state == "finished"
    assert p2.objects[1].params == TProject.load(
        projects["one"]).objects[1].params


def test_two_process_sfm_dist_ba(projects):
    assert projects["rc_sfm"] == 0, projects["logs_sfm"][-4000:]
    two = projects["two"]
    p = TProject.load(two)
    tri = [o for o in p.objects.values() if o.kind == "triangulation"]
    assert len(tri) == 1 and tri[0].state == "finished"
    full = ["sfm", two, "--dist-ba"]
    assert tri[0].params == jcli._params(jcli.build_parser()
                                         .parse_args(full))
    assert tri[0].results["num_cameras"] == N_VIEWS
    tdir = p.paths(tri[0].id).triangulation_dir
    for name in ("scene.npz", "sfm_data.json", "cloud_and_poses.ply",
                 "FinalColorized.ply", "Reconstruction_Report.html"):
        assert os.path.getsize(os.path.join(tdir, name)) > 0, name
    added = set(os.listdir(two)) - projects["before"]
    assert added == {os.path.basename(tdir)}, added


def test_secondary_skips_info(projects):
    assert projects["rc_info"] == 0
    assert ("secondary process skipping non-distributed subcommand 'info'"
            in projects["logs_info"])
