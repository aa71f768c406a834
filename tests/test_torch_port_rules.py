"""Rules of the PyTorch/CUDA port that hold on any machine.

* The port imports ``torch``, never ``jax``, ``flax`` or the JAX package
  ``regard3d_tpu``: checked statically over every module and
  ``chip_smoke.py``, and dynamically by importing every module in a fresh
  interpreter.
* Entry points run on ``cuda`` unless the caller asks for the CPU, and
  raise rather than fall back to the CPU when there is no card; so do the
  command line's compute subcommands (``--device``), and ``launch`` of a
  compute subcommand raises before it starts a process.
* The CUDA kernel wrappers take the plain version only for CPU tensors;
  anything else goes to the kernel or raises.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from regard3d_tpu_torch import cli as tcli
from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.ba import lm as tlm
from regard3d_tpu_torch.ba import sharded as tsh
from regard3d_tpu_torch.core.types import Scene
from regard3d_tpu_torch.export import formats as tfmt
from regard3d_tpu_torch.kernels import match as tm
from regard3d_tpu_torch.mvs import driver as tdrv
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import features as tfeat
from regard3d_tpu_torch.pipeline import triangulation_step as ttri
from regard3d_tpu_torch.sfm import incremental as tinc
from regard3d_tpu_torch.surface import poisson as tpo
from regard3d_tpu_torch.surface import texture as ttx
from regard3d_tpu_torch.sfm import global_sfm as tglob
from regard3d_tpu_torch.tools import accuracy as tacc
from regard3d_tpu_torch.tools import dense_normals as tnorm
from regard3d_tpu_torch.tools import profile_sfm as tprof
from regard3d_tpu_torch.tools import scale as tscale

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "regard3d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "regard3d_tpu")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules():
    mods = []
    for path in port_sources()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_port_sources_import_no_jax():
    """(f) static check: no import statement of the port or chip_smoke.py
    names jax, flax or regard3d_tpu, and no dynamic import names them."""
    bad = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _forbidden(node.module):
                    bad.append((path, node.module))
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id",
                                                         "")) in
                  ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and _forbidden(str(node.args[0].value))):
                bad.append((path, node.args[0].value))
    assert len(port_sources()) > 15
    assert not bad, bad


def test_port_modules_load_without_jax():
    """(f) dynamic check: every module of the port imports in a fresh
    interpreter without pulling jax, flax or regard3d_tpu into it."""
    code = ("import importlib, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    # the command line, the project store, host ingest and the sinks
    assert {"regard3d_tpu_torch.cli", "regard3d_tpu_torch.pipeline.project",
            "regard3d_tpu_torch.pipeline.settings",
            "regard3d_tpu_torch.pipeline.preview",
            "regard3d_tpu_torch.pipeline.external",
            "regard3d_tpu_torch.ingest.exif",
            "regard3d_tpu_torch.ingest.sensor_db",
            "regard3d_tpu_torch.ingest.intrinsics",
            "regard3d_tpu_torch.ingest.geodesy",
            "regard3d_tpu_torch.export.openmvs",
            "regard3d_tpu_torch.export.sfm_output",
            "regard3d_tpu_torch.export.external_mvs",
            "regard3d_tpu_torch.tools.photos"} <= set(port_modules())
    # the detector menu and the port's binding to the host library
    assert {"regard3d_tpu_torch.kernels.corners",
            "regard3d_tpu_torch.native"} <= set(port_modules())
    # the engine menu and the scale axis
    assert {"regard3d_tpu_torch.sfm.global_sfm",
            "regard3d_tpu_torch.tools.scale",
            "regard3d_tpu_torch.tools.profile_sfm",
            "regard3d_tpu_torch.tools.dense_normals"} <= set(port_modules())
    # distribution
    assert {"regard3d_tpu_torch.dist.mesh", "regard3d_tpu_torch.dist.launch",
            "regard3d_tpu_torch.ba.sharded",
            "regard3d_tpu_torch.ba.dossier"} <= set(port_modules())


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    """(g) with no GPU and no device="cpu", the entry points raise."""
    img = [np.zeros((64, 64), np.float32)] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.run_compute_matches(img, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfeat.extract_features(img, str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device("cuda")
    assert not os.path.exists(tmp_path / "a" / "sfm_data.json")
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    # the triangulation stage: its driver, engine, BA and accuracy tool
    intr = np.zeros((1, 9), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttri.run_triangulation(str(tmp_path / "a"), str(tmp_path / "t"),
                               img, np.zeros(2, np.int32), intr,
                               np.zeros(1, np.int32))
    assert not os.path.exists(tmp_path / "t")
    inputs = tinc.SfMInputs(
        xy=torch.zeros((0, 2)), track_id=torch.zeros(0, dtype=torch.long),
        view_id=torch.zeros(0, dtype=torch.long),
        feature_id=torch.zeros(0, dtype=torch.long), num_tracks=0,
        intr_id=torch.zeros(2, dtype=torch.long), intr=torch.zeros((1, 9)),
        models=torch.zeros(1, dtype=torch.long),
        image_sizes=np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinc.run_incremental(inputs)
    state = tlm.BAState(R=torch.eye(3)[None], C=torch.zeros((1, 3)),
                        intr=torch.zeros((1, 9)), X=torch.zeros((1, 3)))
    obs = tlm.BAObservations(*(torch.zeros(1, dtype=torch.long),) * 4,
                             xy=torch.zeros((1, 2)), weight=torch.ones(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.bundle_adjust(state, obs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.bundle_adjust_sharded(state, obs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tacc.run_dataset("fountain")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tacc.run_dataset("fountain", engine="global")
    # the global engine and its averaging, the scale, engine and normals
    # tools
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglob.run_global(inputs)
    motion = tglob.RelativeMotion(0, 1, np.eye(3), np.array([1.0, 0, 0]),
                                  50, np.zeros(0), np.zeros(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglob.average_rotations([motion], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglob.average_translations([motion], np.eye(3)[None].repeat(2, 0), 2)
    for fn in (tscale.run_scale, tprof.run_profile, tnorm.run_normals):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(views=2)


@pytest.mark.parametrize("cmd", tcli.COMPUTE_COMMANDS)
def test_cli_compute_subcommands_raise_without_a_card(cmd, no_card,
                                                      tmp_path):
    """(g) with no GPU and no ``--device cpu``, every compute subcommand
    raises before it reads or writes the project, and so does ``launch``
    of it, before it starts a process."""
    proj = str(tmp_path / "proj")
    extra = ["--format", "nvm"] if cmd == "export" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([cmd, proj, *extra])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--device", "cuda", cmd, proj, *extra])
    assert not os.path.exists(proj)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["launch", "-n", "2", "--", cmd, proj, *extra])
    assert not os.path.exists(proj)


def _posed_scene(n=2):
    s = Scene.empty(n, 1, 1, 1)
    params = torch.zeros_like(s.intrinsics.params)
    params[0, :3] = torch.tensor([8.0, 4.0, 4.0])
    return s.replace(
        views=s.views.replace(mask=torch.ones(n, dtype=bool),
                              width=torch.full((n,), 8, dtype=torch.int32),
                              height=torch.full((n,), 8, dtype=torch.int32)),
        intrinsics=s.intrinsics.replace(params=params),
        poses=s.poses.replace(mask=torch.ones(n, dtype=bool)))


DENSE_ENTRY_POINTS = {
    "densify_scene": lambda sc, im, d: tdrv.densify_scene(sc, im, **d),
    "compute_depth_maps": lambda sc, im, d: tdrv.compute_depth_maps(
        sc, im, tdrv.PlaneSweepParams(), **d),
    "fuse_depth_maps": lambda sc, im, d: tdrv.fuse_depth_maps(
        sc, im, {}, tdrv.PlaneSweepParams(), **d),
    "undistort_image": lambda sc, im, d: tfmt.undistort_image(im[0], sc, 0,
                                                              **d),
    "export_pmvs": lambda sc, im, d: tfmt.export_pmvs(d.pop("out"), sc, im,
                                                      **d),
    "export_mve2": lambda sc, im, d: tfmt.export_mve2(
        d.pop("out"), sc, im, ["a.png", "b.png"], **d),
    "reconstruct": lambda sc, im, d: tpo.reconstruct(
        np.random.default_rng(0).normal(size=(64, 3)),
        np.ones((64, 3)), depth=4, **d),
    "face_view_data": lambda sc, im, d: ttx.face_view_data(
        sc, np.zeros((2, 8, 8, 3), np.float32), np.full((2, 2), 8),
        np.arange(2), np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]),
        **d),
    "texture_mesh": lambda sc, im, d: ttx.texture_mesh(
        sc, im, np.eye(3, dtype=np.float32), np.array([[0, 1, 2]]), **d),
}


@pytest.mark.parametrize("name", sorted(DENSE_ENTRY_POINTS))
def test_dense_entry_points_resolve_to_cuda(name, monkeypatch, tmp_path):
    """(g) the dense slice's entry points: with no GPU and no device="cpu"
    they raise; with device="cpu" they run on the CPU."""
    call = DENSE_ENTRY_POINTS[name]
    img = [np.zeros((8, 8), np.float32)] * 2
    takes_out = name.startswith("export_")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(_posed_scene(), img,
                 {"out": str(tmp_path / "a")} if takes_out else {})
    call(_posed_scene(), img, dict(device="cpu", **(
        {"out": str(tmp_path / "b")} if takes_out else {})))


def test_kernel_wrappers_never_fall_back(rng):
    """The launch path refuses CPU tensors and unsupported inputs; only the
    public wrappers, and only for CPU tensors, take the plain version."""
    desc = torch.tensor(rng.normal(size=(2, 32, 16)).astype(np.float32))
    bnorm = torch.zeros((2, 32))
    pairs = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tm._launch(desc, desc, bnorm, pairs)
    before = dict(tm.LAUNCHES)
    d1, i1, d2 = tm.l2_top2_block(desc, torch.ones((2, 32), dtype=bool),
                                  pairs)
    assert tm.LAUNCHES == before and d1.shape == (1, 32)


def test_runtime_numerics_and_build_dir():
    """Full-f32 matmuls and convolutions (no TF32), and the kernel build
    directory under a path .gitignore lists."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    rel = os.path.relpath(runtime.kernel_build_dir(create=False), ROOT)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert rel.split(os.sep)[0] + "/" in ignored, rel
