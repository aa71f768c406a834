"""Port parity: the float64 engines with MaxPair (incremental2) and the
global engine, on the CPU, on ``tests/test_torch_f64.py``'s 4 views.

Both keep their minimal-solver sweeps (the MaxPair and relative-motion E
sweeps) in float32. Under ``jax_enable_x64`` the reference's sweep
promotes its scan carry to float64 and raises, so its ``sfm --f64`` runs
only v1 (ROADMAP §3), and the one reference run of these two engines is
its f32 run. The port's f64 run, with the draws of that run, is held to
it at the f32 bounds: its cameras, tracks within 2%, rms within 5%,
centres within 1e-3 of the extent after Sim3; beside that, float64 state
in ``scene.npz`` and the ATE gate. Also the f32 runs of v1 in both
packages, the residual that ``test_torch_f64.py``'s f64 v1 comparison
shrinks.
"""

import os

import numpy as np
import pytest
import torch

from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.pipeline import triangulation_step as jts
from tests.test_torch_f64 import (ENGINES, N_VIEWS, _agree, _npz_dtypes,
                                  _run, x64)
from tests.test_torch_f64 import stage  # noqa: F401  (the fixture)

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("name", ["incremental2", "global"])
def test_f64_engines_where_the_reference_raises(stage, name):
    """MaxPair (incremental2) and the global engine keep their minimal-
    solver sweeps in float32, and under x64 the reference's sweep promotes
    its scan carry to float64 and raises (ROADMAP §3). The port runs them:
    every camera posed, float64 poses, points, observations and
    intrinsics in scene.npz, within the f32 bounds of the reference's f32
    run with the same draws."""
    with x64(), pytest.raises(TypeError, match="scan body"):
        jts.run_triangulation(
            stage["matches"], str(stage["base"] / f"{name}_raises"),
            stage["images"],
            params=jts.TriangulationParams(f64=True, **ENGINES[name]),
            **stage["kw"])
    st, port = _run(stage, name, True, "port", draws_x64=False)
    sj32, ref32 = _run(stage, name, False, "ref")
    err = _agree(st, sj32, port, ref32)
    dt = _npz_dtypes(port)
    assert dt["poses.C"] == dt["landmarks.X"] == dt["observations.xy"] \
        == dt["intrinsics.params"] == np.float64
    ate = jmet.ate_rmse(np.asarray(jsd.load_npz(os.path.join(
        port, "scene.npz")).poses.C), stage["ds"]["Cs"][:N_VIEWS])
    assert ate < 0.08, ate
    print(f"{name}: port f64 vs reference f32, centres after Sim3 / "
          f"extent {err:.3e}; rms px {st['rms_px']:.9f} / "
          f"{sj32['rms_px']:.9f}; ATE {ate:.5f}")


def test_v1_f32_agreement_for_the_record(stage):
    """The f32 counterpart of ``test_torch_f64.py``'s v1 comparison: both
    packages' f32 runs with the same draws agree within the f32 bounds
    (centres within 1e-3 of the extent after Sim3); the printed residual
    is what f64 shrinks."""
    sj, ref = _run(stage, "v1", False, "ref")
    st, port = _run(stage, "v1", False, "port")
    err = _agree(st, sj, port, ref)
    print(f"v1 f32, port vs reference centres after Sim3 / extent "
          f"{err:.3e}; rms px {st['rms_px']:.9f} / {sj['rms_px']:.9f}")
