"""Port parity: the external-tool runners (``pipeline/external.py``)
against the JAX package, on the CPU.

* Discovery (``ExternalPrograms``) and the command builders
  (``smvs_command``, ``fssr_commands``, ``texrecon_command``) give equal
  results on the same arguments.
* ``run_densification`` and ``run_surface`` drive stub executables
  (scripts under ``R3D_EXTERNAL_PROGRAMS_DIR`` that copy a small PLY to
  where each real tool writes its output) for every external method: pmvs
  with and without CMVS, mve, smvs, poisson with and without
  SurfaceTrimmer, fssr, texrecon texturing. Both packages run on one
  project (written by the reference's project store) with the arguments
  their own CLI parsers give; the result dicts, the step logs and every
  file they write are equal once each step directory's path is replaced
  by a placeholder. ``surface --method tpu`` runs both in-process chains on
  the same oriented cloud: equal dicts, meshes within 2% in face count.
* A tool that was asked for and is missing raises in both.
"""

import filecmp
import os
import stat
import sys

import numpy as np
import pytest
import torch

from regard3d_tpu import cli as jcli
from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.pipeline import external as jext
from regard3d_tpu.pipeline.project import Project as JProject
from regard3d_tpu_torch import cli as tcli
from regard3d_tpu_torch.export.ply import PlyData, read_ply, write_ply
from regard3d_tpu_torch.pipeline import external as text
from regard3d_tpu_torch.pipeline.project import Project as TProject
from tests.test_export import make_scene

torch.set_num_threads(min(2, torch.get_num_threads()))

STUB = """#!{python}
import os, shutil, sys
name, a = os.path.basename(sys.argv[0]), sys.argv[1:]
print("stub", name, len(a))
cloud, mesh = os.environ["STUB_CLOUD"], os.environ["STUB_MESH"]
if name == "pmvs2":
    os.makedirs(os.path.join(a[0], "models"), exist_ok=True)
    shutil.copy(cloud, os.path.join(a[0], "models", a[1] + ".ply"))
elif name == "genOption":
    for k in range(2):
        open(os.path.join(a[0], "option-%04d" % k), "w").write("x")
elif name == "scene2pset":
    shutil.copy(cloud, a[-1])
elif name == "smvsrecon":
    shutil.copy(cloud, os.path.join(a[-1], "smvs-B2.ply"))
elif name == "PoissonRecon":
    shutil.copy(mesh, a[a.index("--out") + 1])
elif name == "SurfaceTrimmer":
    shutil.copy(a[a.index("--in") + 1], a[a.index("--out") + 1])
elif name == "fssrecon":
    shutil.copy(mesh, a[-1])
elif name == "meshclean":
    shutil.copy(a[-2], a[-1])
elif name == "texrecon":
    open(a[-1] + ".obj", "w").write("o stub\\n")
"""


def _stubs(d, names):
    os.makedirs(d, exist_ok=True)
    for n in names:
        p = os.path.join(d, n)
        with open(p, "w") as f:
            f.write(STUB.format(python=sys.executable))
        os.chmod(p, os.stat(p).st_mode | stat.S_IEXEC)
    return d


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """A project (pictureset -> matches -> triangulation -> densification)
    with 4 RGB images and the reference tests' 4-view scene; stub clouds;
    nothing on PATH."""
    from PIL import Image
    rng = np.random.default_rng(0)
    sphere = rng.normal(size=(300, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    cloud = str(tmp_path / "cloud.ply")
    write_ply(cloud, PlyData(xyz=sphere.astype(np.float32),
                             rgb=rng.integers(0, 255, (300, 3)).astype(
                                 np.uint8), normals=sphere.astype(np.float32)))
    mesh = str(tmp_path / "mesh.ply")
    write_ply(mesh, PlyData(
        xyz=np.eye(3, dtype=np.float32).repeat(2, 0)[[0, 2, 4, 1]],
        faces=np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]],
                       np.int32)))
    monkeypatch.setenv("STUB_CLOUD", cloud)
    monkeypatch.setenv("STUB_MESH", mesh)
    empty = tmp_path / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("R3D_EXTERNAL_PROGRAMS_DIR", raising=False)

    proj = str(tmp_path / "proj")
    p = JProject.create(proj)
    infos = []
    for i in range(4):
        path = str(tmp_path / f"img_{i}.png")
        Image.fromarray(rng.integers(0, 255, (480, 640, 3)).astype(
            np.uint8)).save(path)
        infos.append({"path": path, "width": 640, "height": 480})
    ps = p.add_picture_set("pictures", [i["path"] for i in infos])
    ps.params["image_info"] = infos
    m = p.add_compute_matches(ps.id, {})
    t = p.add_triangulation(m.id, {})
    os.makedirs(p.paths(t.id).triangulation_dir)
    jsd.save_npz(p.paths(t.id).scene_npz, make_scene(n_views=4, n_lm=25))
    d = p.add_densification(t.id, {})
    p.finish(d.id, {"dense_cloud": cloud}, 1.0)
    p.save()
    return dict(tmp=tmp_path, proj=proj, t=t.id, d=d.id, cloud=cloud,
                monkeypatch=monkeypatch)


def _args(cmd, proj, *rest):
    j = jcli.build_parser().parse_args([cmd, proj, *rest])
    t = tcli.build_parser().parse_args(["--device", "cpu", cmd, proj, *rest])
    return j, t


def _normalize(obj, out_dir):
    if isinstance(obj, dict):
        return {k: _normalize(v, out_dir) for k, v in obj.items()}
    return obj.replace(out_dir, "<out>") if isinstance(obj, str) else obj


def _compare_runs(env, fn_name, parent, cmd, rest, log_name):
    """Both packages' runner on one project; returns the two out dirs."""
    ja, ta = _args(cmd, env["proj"], *rest)
    outs, res = [], []
    for mod, project, args, kw in (
            (jext, JProject.load(env["proj"]), ja, {}),
            (text, TProject.load(env["proj"]), ta, {"device": "cpu"})):
        out = str(env["tmp"] / f"{cmd}_{mod.__name__.split('.')[0]}_"
                  f"{'_'.join(rest).replace('-', '')}")
        os.makedirs(out)
        r = getattr(mod, fn_name)(project, parent, out, args, **kw)
        res.append(_normalize(r, out))
        log = os.path.join(out, log_name)
        with open(log) if os.path.exists(log) else open(os.devnull) as f:
            res.append(f.read().replace(out, "<out>"))
        outs.append(out)
    assert res[0] == res[2] and res[1] == res[3], res
    return outs


def _same_files(a, b, names):
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("method", ["pmvs", "pmvs_cmvs", "pmvs_nocmvs", "mve",
                                    "smvs"])
def test_run_densification_matches_reference(env, method):
    names = {"pmvs": ["pmvs2"], "pmvs_cmvs": ["pmvs2", "cmvs", "genOption"],
             "pmvs_nocmvs": ["pmvs2"], "mve": ["dmrecon", "scene2pset"],
             "smvs": ["smvsrecon"]}[method]
    env["monkeypatch"].setenv("R3D_EXTERNAL_PROGRAMS_DIR",
                              _stubs(str(env["tmp"] / "bin"), names))
    rest = {"pmvs": ["--method", "pmvs", "--level", "2"],
            "pmvs_cmvs": ["--method", "pmvs", "--use-cmvs",
                          "--max-cluster-size", "50"],
            "pmvs_nocmvs": ["--method", "pmvs", "--use-cmvs"],
            "mve": ["--method", "mve", "--scale", "3"],
            "smvs": ["--method", "smvs", "--shading", "--no-sgm",
                     "--alpha", "0.5", "--input-scale", "1"]}[method]
    ref, port = _compare_runs(env, "run_densification", env["t"], "densify",
                              rest, "densification.log")
    _same_files(ref, port, ["dense.ply"])
    assert len(read_ply(os.path.join(port, "dense.ply")).xyz) == \
        (600 if method == "pmvs_cmvs" else 300)
    sub = "PMVS" if method.startswith("pmvs") else "MVE"
    ref_files = sorted(os.path.relpath(os.path.join(d, f), ref)
                       for d, _, fs in os.walk(os.path.join(ref, sub))
                       for f in fs)
    assert ref_files
    _same_files(ref, port, ref_files)


@pytest.mark.parametrize("method", ["poisson", "poisson_notrim", "fssr",
                                    "texrecon", "tpu"])
def test_run_surface_matches_reference(env, method):
    names = {"poisson": ["PoissonRecon", "SurfaceTrimmer"],
             "poisson_notrim": ["PoissonRecon"],
             "fssr": ["fssrecon", "meshclean"],
             "texrecon": ["PoissonRecon", "texrecon"], "tpu": []}[method]
    env["monkeypatch"].setenv("R3D_EXTERNAL_PROGRAMS_DIR",
                              _stubs(str(env["tmp"] / "bin"), names))
    rest = {"poisson": ["--method", "poisson", "--depth", "7",
                        "--trim-threshold", "5"],
            "poisson_notrim": ["--method", "poisson"],
            "fssr": ["--method", "fssr", "--scale-factor", "2",
                     "--refine-octree-levels", "1", "--color-neighbors", "5"],
            "texrecon": ["--method", "poisson", "--colorize", "textures",
                         "--texture-method", "texrecon",
                         "--no-visibility-test", "--outlier-removal",
                         "gauss_clamping"],
            "tpu": ["--method", "tpu", "--depth", "5"]}[method]
    ref, port = _compare_runs(env, "run_surface", env["d"], "surface", rest,
                              "surface.log")
    if method == "tpu":
        a, b = (read_ply(os.path.join(d, "surface_colored.ply"))
                for d in (ref, port))
        assert len(b.faces) == pytest.approx(len(a.faces), rel=0.02)
        assert len(b.faces) > 100
    elif method == "texrecon":
        _same_files(ref, port, ["surface.ply", "textured.obj"])
    else:
        _same_files(ref, port, ["surface.ply", "surface_colored.ply"])


def test_discovery_commands_and_missing_tools(env, tmp_path):
    names = ["pmvs2", "texrecon", "meshclean"]
    env["monkeypatch"].setenv("R3D_EXTERNAL_PROGRAMS_DIR",
                              _stubs(str(tmp_path / "bin"), names))
    extra = _stubs(str(tmp_path / "extra"), ["cmvs"])
    pj = jext.ExternalPrograms([extra])
    pt = text.ExternalPrograms([extra])
    assert pt.paths == pj.paths and sorted(pt.paths) == sorted(names +
                                                               ["cmvs"])
    assert text.EXTERNAL_PROGRAMS == jext.EXTERNAL_PROGRAMS
    for rest in ([], ["--input-scale", "3", "--shading", "--no-sgm",
                      "--alpha", "0.25"]):
        ja, ta = _args("densify", "p", *rest)
        assert text.smvs_command("smvs", "scene", ta) == \
            jext.smvs_command("smvs", "scene", ja)
    for rest in ([], ["--scale-factor", "2.5", "--refine-octree-levels", "2",
                      "--conf-threshold", "3", "--min-component-size", "9",
                      "--no-visibility-test", "--seam-leveling", "none",
                      "--no-local-seam-leveling", "--outlier-removal",
                      "none"]):
        ja, ta = _args("surface", "p", *rest)
        assert text.fssr_commands("f", "m", "d", "r", "s", ta) == \
            jext.fssr_commands("f", "m", "d", "r", "s", ja)
        assert text.texrecon_command("t", "MVE", "s", "o", ta) == \
            jext.texrecon_command("t", "MVE", "s", "o", ja)
    # asked for and missing: both raise
    env["monkeypatch"].delenv("R3D_EXTERNAL_PROGRAMS_DIR")
    for mod, project, kw in ((jext, JProject.load(env["proj"]), {}),
                             (text, TProject.load(env["proj"]),
                              {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="pmvs2"):
            mod.run_densification(project, env["t"], str(tmp_path), _args(
                "densify", "p")[0], **kw)
        with pytest.raises(RuntimeError, match="PoissonRecon"):
            mod.run_surface(project, env["d"], str(tmp_path), _args(
                "surface", "p")[0], **kw)
