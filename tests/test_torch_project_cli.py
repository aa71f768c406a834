"""Port parity: the project store (``pipeline/{project,settings}.py``) and the
command line (``cli.py``) against the JAX package, on the CPU.

The README's quick start runs through the port's CLI (``--device cpu``) on
5 views of the synthetic fountain at 192 px written as camera JPEGs with
EXIF focal and GPS (``tools/photos.py``): init -> import -> matches (512
keypoints, 64 RANSAC iterations, ``--profile``) -> pairs -> sfm ->
``sfm --engine incremental --initial-pair <best pair> --use-gps`` -> export
(all nine formats) -> densify / surface (``--method tpu``, vertex colors
and textures) -> preview -> info. Checked:

* every step finishes; import takes every focal from EXIF at 1.03x the
  truth (1e-3 relative) and the GPS back within 1 cm after ENU; both sfm
  runs pose every camera, and the GPS run's centres lie within 0.08 of
  the truth in the priors' ENU frame with no alignment;
* ``matches`` writes the same bytes as ``run_compute_matches`` called
  directly with the same arguments (the HTML report holds timings);
* the reference CLI run on the port's project gives byte-identical
  exports in all nine formats, ``pairs --json``, ``info`` and previews;
* the port's CLI reads and extends a project the reference CLI wrote;
  ``project.json`` after the same ``init`` + ``import`` is equal in both
  (``saved_at`` is the save's time stamp), and every subcommand stores the
  same parameters (``_params`` drops ``--device``);
* ``sfm --engine global`` and ``sfm --initializer stellar`` run on the
  quick-start project and store the reference CLI's parameters;
* ``sfm --f64`` and ``matches --detector orb|mser`` run on the quick-start
  project and store the reference CLI's parameters;
* ``retrieval_pairs`` gives the reference's pair list (``launch``, multi-
  process runs and ``--dist-ba``: ``tests/test_torch_multiprocess.py``).
"""

import contextlib
import filecmp
import io
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu import cli as jcli
from regard3d_tpu import runtime as jruntime
from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core.types import Descriptors as JDescriptors
from regard3d_tpu.pipeline import compute_matches as jcm
from regard3d_tpu.pipeline.project import Project as JProject
from regard3d_tpu_torch import cli as tcli
from regard3d_tpu_torch.core.sfm_data import load_npz
from regard3d_tpu_torch.core.types import Descriptors as TDescriptors
from regard3d_tpu_torch.ingest import geodesy, image_io, synth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline.features import SENSITIVITY_PRESETS
from regard3d_tpu_torch.pipeline.project import Project as TProject
from regard3d_tpu_torch.tools import photos
from tests.test_torch_mvs import _same_tree

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS = 5
MATCH_ARGS = ["--max-keypoints", "512", "--ransac-iters", "64",
              "--sensitivity", "high"]
FORMATS = ["bundler", "pmvs", "nvm", "meshlab", "mve", "openmvs",
           "sfmoutput", "externalmvs", "mvstexturing"]


def _call(main, argv):
    """Run a CLI's ``main`` in process; returns its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as m:
        m.setattr(jruntime, "setup", lambda *a, **k: None)
        main(argv)
    return buf.getvalue()


def port(*argv):
    return _call(tcli.main, ["--device", "cpu", *argv])


def ref(*argv):
    return _call(jcli.main, list(argv))


def _dataset():
    ds = synth.make_dataset("fountain", n_cams=11, hw=192, seed=0)
    return dict(ds, images=ds["images"][:N_VIEWS], Cs=ds["Cs"][:N_VIEWS],
                Rs=ds["Rs"][:N_VIEWS])


@pytest.fixture(scope="module")
def qs(tmp_path_factory):
    """The quick start through the port's CLI."""
    base = tmp_path_factory.mktemp("qs")
    ds = _dataset()
    paths = photos.write_dataset(ds, str(base / "photos"))
    proj = str(base / "proj")
    out = {"base": base, "proj": proj, "ds": ds, "paths": paths}
    port("init", proj)
    port("import", proj, *paths)
    out["matches"] = json.loads(port("matches", proj, *MATCH_ARGS,
                                     "--profile", str(base / "prof")))
    out["pairs"] = port("pairs", proj, "--json")
    top = json.loads(out["pairs"])[0]
    out["pair"] = f"{top['i']},{top['j']}"
    out["sfm"] = json.loads(port("sfm", proj))
    out["sfm_gps"] = json.loads(port(
        "sfm", proj, "--engine", "incremental", "--initial-pair",
        out["pair"], "--use-gps", "--id", "1"))
    for fmt in FORMATS:
        port("export", proj, "--id", "2", "--format", fmt, "--out",
             str(base / "port_export" / fmt))
    out["densify"] = json.loads(port("densify", proj, "--id", "2",
                                     "--method", "tpu", "--level", "0",
                                     "--num-planes", "32"))
    out["surface"] = json.loads(port("surface", proj, "--method", "tpu",
                                     "--depth", "5"))
    out["textured"] = json.loads(port("surface", proj, "--id", "4",
                                      "--method", "tpu", "--depth", "5",
                                      "--colorize", "textures"))
    for tag, argv in (("view", ["--view", "0"]), ("pair", ["--pair",
                                                           out["pair"]])):
        out[f"preview_{tag}"] = port("preview", proj, *argv, "--out",
                                     str(base / "port_preview"))
    out["info"] = port("info", proj)
    return out


def test_quickstart_through_the_port_cli(qs):
    p = TProject.load(qs["proj"])
    steps = [o for o in p.objects.values() if o.kind != "pictureset"]
    assert [o.kind for o in steps] == ["matches", "triangulation",
                                       "triangulation", "densification",
                                       "surface", "surface"]
    assert all(o.state == "finished" for o in steps)
    assert "device" not in json.dumps([o.params for o in steps])
    ds = qs["ds"]
    infos = p.objects[0].params["image_info"]
    assert all(i["from_exif"] for i in infos) and len(infos) == N_VIEWS
    for i in infos:
        assert i["focal_px"] == pytest.approx(1.03 * ds["f"], rel=1e-3)
    ecef = np.array([geodesy.lla_to_ecef(*i["gps"]) for i in infos])
    local, origin, R = geodesy.local_enu_frame(ecef)
    true = (photos.enu_to_ecef(ds["Cs"]) - origin) @ R.T
    assert np.abs(local - true).max() < 0.01
    assert qs["matches"]["pairs_f"] * 2 >= qs["matches"]["pairs_putative"]
    assert qs["sfm"]["num_cameras"] == qs["sfm_gps"]["num_cameras"] == N_VIEWS
    assert qs["sfm_gps"]["init_pair"] == [int(v) for v in
                                          qs["pair"].split(",")]
    # GPS-anchored centres against the truth, both in the priors' frame
    scene = load_npz(os.path.join(p.paths(3).triangulation_dir, "scene.npz"))
    C = scene.poses.C.numpy()
    assert np.sqrt(((C - true) ** 2).sum(1).mean()) <= 0.08
    assert qs["densify"]["num_points"] > 0
    assert qs["densify"]["num_depth_maps"] == N_VIEWS
    assert qs["surface"]["surface"].endswith("surface_colored.ply")
    prefix = qs["textured"]["surface"][:-len(".obj")]
    assert all(os.path.exists(prefix + e) for e in (".obj", ".mtl", ".png"))
    with open(qs["base"] / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "compute_matches.filter"
               for e in trace["traceEvents"])


def test_matches_artifacts_equal_a_direct_call(qs, tmp_path):
    infos = TProject.load(qs["proj"]).objects[0].params["image_info"]
    images = [image_io.load_gray(i["path"]) for i in infos]
    stats = tcm.run_compute_matches(
        images, str(tmp_path), threshold=SENSITIVITY_PRESETS["high"],
        cfg=tcm.MatchConfig(ransac_iters=64),
        focals=np.asarray([i["focal_px"] for i in infos]),
        max_keypoints=512, device="cpu")
    cli_dir = TProject.load(qs["proj"]).paths(1).matches_dir
    names = sorted(set(os.listdir(cli_dir)) - {"Matching_Report.html"})
    assert names == sorted(set(os.listdir(tmp_path))
                           - {"Matching_Report.html"})
    assert len(names) > 2 * N_VIEWS
    for n in names:
        assert filecmp.cmp(os.path.join(cli_dir, n), tmp_path / n,
                           shallow=False), n
    timing = ("elapsed_s", "time_features_s", "time_matching_s",
              "time_filter_s")
    assert {k: v for k, v in stats.items() if k not in timing} == \
        {k: v for k, v in qs["matches"].items() if k not in timing}


def test_reference_cli_reads_the_port_project(qs):
    base, proj = qs["base"], qs["proj"]
    for fmt in FORMATS:
        ref("export", proj, "--id", "2", "--format", fmt, "--out",
            str(base / "ref_export" / fmt))
    assert _same_tree(str(base / "ref_export"), str(base / "port_export")) \
        > 15 * N_VIEWS
    assert ref("pairs", proj, "--json") == qs["pairs"]
    assert ref("info", proj) == qs["info"]
    for tag, argv in (("view", ["--view", "0"]), ("pair", ["--pair",
                                                           qs["pair"]])):
        said = ref("preview", proj, *argv, "--out", str(base / "ref_preview"))
        assert said.replace("ref_preview", "port_preview") == \
            qs[f"preview_{tag}"]
    assert _same_tree(str(base / "ref_preview"),
                      str(base / "port_preview")) == 3


def test_projects_cross_between_the_two_clis(qs, tmp_path):
    """init + import by each CLI give equal project.json dicts; each
    package loads the other's; the port's CLI runs matches on the
    reference's project and the reference reads the result."""
    paths = qs["paths"]
    dicts = {}
    for tag, run in (("ref", ref), ("port", port)):
        proj = str(tmp_path / tag)
        run("init", proj)
        run("import", proj, *paths, "--name", "set")
        with open(os.path.join(proj, "project.json")) as f:
            d = json.load(f)
        assert isinstance(d.pop("saved_at"), float)
        dicts[tag] = d
        for Project in (JProject, TProject):
            p = Project.load(proj)
            assert p.next_id == 1 and p.image_lists == {0: paths}
    assert dicts["ref"] == dicts["port"]
    assert port("info", str(tmp_path / "ref")) == ref("info", str(tmp_path /
                                                                  "ref"))
    stats = json.loads(port("matches", str(tmp_path / "ref"), *MATCH_ARGS))
    assert stats["pairs_putative"] == N_VIEWS * (N_VIEWS - 1) // 2
    jp = JProject.load(str(tmp_path / "ref"))
    assert jp.objects[1].state == "finished"
    assert jp.objects[1].params == TProject.load(
        qs["proj"]).objects[1].params | {"profile": None}
    assert ref("pairs", str(tmp_path / "ref"), "--json") == \
        port("pairs", str(tmp_path / "ref"), "--json")


ARGVS = [
    ["init", "p"], ["import", "p", "a.jpg", "b.jpg", "--name", "x"],
    ["matches", "p", "--ratio", "0.7", "--window", "3", "--retrieval-k", "2"],
    ["sfm", "p", "--engine", "incremental", "--initial-pair", "0,1",
     "--use-gps", "--camera-model", "pinhole"],
    ["export", "p", "--format", "openmvs"],
    ["densify", "p", "--method", "tpu", "--level", "2"],
    ["surface", "p", "--colorize", "textures", "--no-visibility-test"],
    ["info", "p"], ["delete", "p", "3"], ["preview", "p", "--pair", "0,1"],
    ["pairs", "p", "--json"], ["camera-db", "list"],
    ["image-info", "a.jpg"], ["launch", "-n", "2", "--", "info", "p"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[a[0] for a in ARGVS])
def test_subcommands_options_and_stored_params_match_reference(argv):
    j = jcli.build_parser().parse_args(argv)
    t = tcli.build_parser().parse_args(["--device", "cpu", *argv])
    assert t.device == "cpu"
    vj = {k: v for k, v in vars(j).items() if k != "fn"}
    vt = {k: v for k, v in vars(t).items() if k not in ("fn", "device")}
    assert vt == vj
    assert tcli._params(t) == jcli._params(j)
    assert t.fn.__name__ == j.fn.__name__


@pytest.mark.parametrize("argv", [["--engine", "global"],
                                  ["--initializer", "stellar"]],
                         ids=["global", "stellar"])
def test_engine_menu_through_the_cli(qs, tmp_path, argv):
    """``sfm --engine global`` and ``sfm --initializer stellar`` on a copy
    of the quick-start project: the step finishes with every camera posed
    and the scene within 0.08 of the truth after Sim3, and project.json
    stores what the reference CLI stores for the same command (the
    reference's Project loads it)."""
    proj = str(tmp_path / "proj")
    shutil.copytree(qs["proj"], proj)
    full = ["sfm", proj, "--id", "1", *argv]
    stats = json.loads(port(*full))
    p = TProject.load(proj)
    obj = p.objects[max(p.objects)]
    assert obj.kind == "triangulation" and obj.state == "finished"
    assert stats["num_cameras"] == N_VIEWS
    assert obj.params == jcli._params(jcli.build_parser().parse_args(full))
    jobj = JProject.load(proj).objects[obj.id]
    assert (jobj.kind, jobj.state, jobj.params) == (obj.kind, obj.state,
                                                    obj.params)
    scene = load_npz(os.path.join(p.paths(obj.id).triangulation_dir,
                                  "scene.npz"))
    pm = scene.poses.mask.numpy()
    assert pm.all()
    assert jmet.ate_rmse(scene.poses.C.numpy(), qs["ds"]["Cs"]) <= 0.08


@pytest.mark.parametrize("argv", [
    ["sfm", "--id", "1", "--f64"],
    ["matches", *MATCH_ARGS, "--detector", "orb"],
    ["matches", *MATCH_ARGS, "--detector", "mser"],
], ids=["sfm_f64", "matches_orb", "matches_mser"])
def test_f64_and_detector_menu_through_the_cli(qs, tmp_path, argv):
    """``sfm --f64`` and ``matches --detector orb|mser`` on a copy of the
    quick-start project: the step finishes and project.json stores what the
    reference CLI stores for the same command (the reference's Project
    loads it). The f64 run poses every camera within 0.08 of the truth
    after Sim3 with float64 state in scene.npz; the matches steps write
    every view's features and putative matches (at 192 px the corner
    detectors' small LIOP patches F-validate few pairs or none, in the
    reference as in the port)."""
    proj = str(tmp_path / "proj")
    shutil.copytree(qs["proj"], proj)
    full = [argv[0], proj, *argv[1:]]
    stats = json.loads(port(*full))
    p = TProject.load(proj)
    obj = p.objects[max(p.objects)]
    assert obj.state == "finished"
    assert obj.params == jcli._params(jcli.build_parser().parse_args(full))
    jobj = JProject.load(proj).objects[obj.id]
    assert (jobj.kind, jobj.state, jobj.params) == (obj.kind, obj.state,
                                                    obj.params)
    if argv[0] == "sfm":
        assert stats["num_cameras"] == N_VIEWS
        scene = load_npz(os.path.join(p.paths(obj.id).triangulation_dir,
                                      "scene.npz"))
        assert scene.poses.C.dtype == scene.landmarks.X.dtype == torch.float64
        assert jmet.ate_rmse(scene.poses.C.numpy(), qs["ds"]["Cs"]) <= 0.08
    else:
        assert obj.kind == "matches" and obj.params["detector"] == argv[-1]
        assert min(stats["keypoints"]) > 0 and stats["matches_putative"] > 0


def test_cli_runs_as_a_module_from_any_directory(qs, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "regard3d_tpu_torch.cli",
                        "info", qs["proj"]], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == qs["info"]


def test_retrieval_pairs_match_reference(qs, tmp_path):
    rng = np.random.default_rng(0)
    data = rng.uniform(size=(9, 64, 16)).astype(np.float32)
    data[3] = data[7] * 0.5                 # a near-duplicate image
    mask = rng.uniform(size=(9, 64)) > 0.2
    for k, exclude in ((2, None), (4, set(tcm.sequential_pairs(9, 1)))):
        a = tcm.retrieval_pairs(TDescriptors(torch.as_tensor(data),
                                             torch.as_tensor(mask)), k,
                                exclude)
        b = jcm.retrieval_pairs(JDescriptors(jnp.asarray(data),
                                             jnp.asarray(mask)), k, exclude)
        assert a == b and len(a) > 0
    # the stage: a window of 1 plus retrieval
    infos = TProject.load(qs["proj"]).objects[0].params["image_info"]
    images = [image_io.load_gray(i["path"]) for i in infos]
    stats = tcm.run_compute_matches(
        images, str(tmp_path), threshold=SENSITIVITY_PRESETS["high"],
        cfg=tcm.MatchConfig(ransac_iters=64), max_keypoints=512,
        pairs=tcm.sequential_pairs(N_VIEWS, 1), retrieval_k=2, device="cpu")
    assert stats["pairs_putative"] == N_VIEWS - 1 + stats["pairs_retrieval"]
    assert stats["pairs_retrieval"] > 0
