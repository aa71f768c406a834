"""Port parity: the OpenMVS, SfM_output and external-MVS exporters
(``export/{openmvs,sfm_output,external_mvs}.py``) against the JAX package,
on the CPU: the same scene, built from the same numpy arrays, gives
byte-identical files (undistorted images included), with and without lens
distortion.
"""

import os

import numpy as np
import pytest
import torch

from regard3d_tpu.export import external_mvs as jext
from regard3d_tpu.export import openmvs as jomvs
from regard3d_tpu.export import sfm_output as jsfmo
from regard3d_tpu_torch.export import external_mvs as text
from regard3d_tpu_torch.export import openmvs as tomvs
from regard3d_tpu_torch.export import sfm_output as tsfmo
from tests.test_export import make_scene
from tests.test_torch_mvs import _distorted_scene, _same_tree, port_scene

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("distorted", [False, True])
def test_sinks_byte_identical(tmp_path, distorted):
    js = make_scene(n_views=4, n_lm=25)
    # one unposed view and one dead landmark, so the posed/live filters act
    js = js.replace(
        poses=js.poses.replace(mask=js.poses.mask.at[2].set(False)),
        landmarks=js.landmarks.replace(mask=js.landmarks.mask.at[3].set(
            False)))
    if distorted:
        js = _distorted_scene(js)
    ts = port_scene(js)
    rng = np.random.default_rng(0)
    images = [rng.uniform(size=(480, 640, 3)).astype(np.float32)
              for _ in range(4)]
    names = [f"img_{i}.jpg" for i in range(4)]
    for root, mods, kw in ((tmp_path / "ref", (jomvs, jsfmo, jext), {}),
                           (tmp_path / "port", (tomvs, tsfmo, text),
                            {"device": "cpu"})):
        omvs, sfmo, ext = mods
        os.makedirs(root)
        omvs.export_openmvs(str(root / "scene.mvs"), ts if kw else js, names)
        omvs.export_openmvs(str(root / "scene_und.mvs"), ts if kw else js,
                            names, undistorted_dir="undistorted")
        sfmo.export_sfm_output(str(root / "SfM_output"), ts if kw else js,
                               images, names, **kw)
        ext.export_external_mvs(str(root / "ext"), ts if kw else js, images,
                                names, **kw)
    # 2 archives; SfM_output 3 per posed view + 3; external MVS 7 per posed
    # view + output.sfm + 2 ini files
    assert _same_tree(str(tmp_path / "ref"), str(tmp_path / "port")) == \
        2 + (3 * 3 + 3) + (7 * 3 + 3)
    with open(tmp_path / "port" / "scene.mvs", "rb") as f:
        assert f.read(4) == b"MVSI"
