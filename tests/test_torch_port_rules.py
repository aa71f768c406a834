"""Rules of the PyTorch/CUDA port that hold on any machine.

* The port imports ``torch``, never ``jax``, ``flax`` or the JAX package
  ``regard3d_tpu``: checked statically over every module and
  ``chip_smoke.py``, and dynamically by importing every module in a fresh
  interpreter.
* Entry points run on ``cuda`` unless the caller asks for the CPU, and
  raise rather than fall back to the CPU when there is no card.
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

from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.kernels import match as tm
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import features as tfeat

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
