"""Port parity: the float64 engines (``TriangulationParams(f64=True)``,
``r3d sfm --f64``) against the JAX package's f64 runs, on the CPU.

The reference runs them under ``jax_enable_x64``; the tests here turn it
on inside try/finally, as ``tests/test_ba.py``'s f64 test does. The port
has no global switch: the inputs' dtype carries float64 into the engine
state, triangulation and BA, while the minimal-solver sweeps stay float32
in both packages.

* BA on ``tests/test_ba.py``'s noiseless islands problem in f64: float64
  state, rms < 1e-4 px in both packages, and the two final states agree
  within 1e-9 (rotations; points after Sim3, as a fraction of the extent),
  at least 1e3 times closer than the two f32 runs (1.2e-7 and 2.6e-6).
* ``run_triangulation(f64=True)`` on 4 synthetic fountain views at 256 px
  (the stage fixture of ``tests/test_torch_triangulation_step.py``), each
  engine with the reference's draws. v1 (the user's initial pair) against
  the reference's f64 run: its cameras, tracks within 2%, rms within 5%,
  centres within 1e-6 of the extent after Sim3 (1e-3 in f32), rms within
  1e-6, and ``scene.npz`` holding the reference's dtype in every field.
  The f32 runs' agreement, incremental2 and global:
  ``tests/test_torch_f64_engines.py``.
* The f32 path stays float32: its inputs, read from the same files.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.ba import lm as jlm
from regard3d_tpu.core import metrics as jmet
from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.core.types import PINHOLE
from regard3d_tpu.pipeline import triangulation_step as jts
from regard3d_tpu_torch.ba import lm as tlm
from regard3d_tpu_torch.core.types import (ba_observations_from_numpy,
                                           ba_state_from_numpy)
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import triangulation_step as tts
from tests.test_ba import synth_ba_problem
from tests.test_torch_global_sfm import GlobalReplay
from tests.test_torch_incremental import Replay

torch.set_num_threads(min(2, torch.get_num_threads()))

N_VIEWS = 4


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _islands(dtype_j, dtype_t):
    """Both packages' BA on the noiseless islands problem; returns the two
    final states, both rms residuals (px) and the port's stats."""
    state, _, obs = synth_ba_problem(np.random.default_rng(0), noise_px=0.0)
    js = jlm.BAState(*(jnp.asarray(x, dtype_j) for x in state))
    jo = obs._replace(xy=jnp.asarray(obs.xy, dtype_j),
                      weight=jnp.asarray(obs.weight, dtype_j))
    fixed = np.zeros(js.R.shape[0], bool)
    fixed[0] = True
    jout, _ = jlm.bundle_adjust(js, jo, jlm.BAOptions(max_iterations=25),
                                fixed_pose_mask=jnp.asarray(fixed))
    ts = ba_state_from_numpy(*(np.asarray(a) for a in js), dtype=dtype_t)
    to = ba_observations_from_numpy(*(np.asarray(a) for a in jo),
                                    dtype=dtype_t)
    tout, stats = tlm.bundle_adjust(ts, to, tlm.BAOptions(max_iterations=25),
                                    fixed_pose_mask=torch.as_tensor(fixed),
                                    device="cpu")
    rt = tlm.compute_residuals(tout, to)
    rj = jlm.compute_residuals(jout, jo)
    return (jout, tout, float(jnp.sqrt(jnp.mean(jnp.sum(rj * rj, -1)))),
            float(torch.sqrt((rt ** 2).sum(-1).mean())), stats)


def test_ba_f64_islands_matches_reference():
    with x64():
        j64, t64, rms_j, rms64, st = _islands(jnp.float64, torch.float64)
    j32, t32, _, _, _ = _islands(jnp.float32, torch.float32)
    assert t64.X.dtype == torch.float64 and t64.R.dtype == torch.float64
    assert rms_j < 1e-4 and rms64 < 1e-4, (rms_j, rms64)
    assert st.final_cost < st.initial_cost
    # one fixed pose leaves the scale free, so the points are compared after
    # Sim3 (C and X drift along the gauge by ~1e-4 in f64 and f32 alike)
    d = {}
    for tag, a, b in (("f64", j64, t64), ("f32", j32, t32)):
        Xj = np.asarray(a.X, np.float64)
        Xt = b.X.numpy().astype(np.float64)
        aligned = jmet.umeyama(Xt, Xj).apply(Xt)
        d[tag] = (float(np.abs(b.R.numpy() - np.asarray(a.R)).max()),
                  float(np.abs(aligned - Xj).max() / np.ptp(Xj, 0).max()))
    print(f"islands, port vs reference (R max abs, X after Sim3 / extent): "
          f"f32 {d['f32']}, f64 {d['f64']}")
    assert max(d["f64"]) <= 1e-9, d
    assert all(a * 1e3 <= b for a, b in zip(d["f64"], d["f32"])), d
    assert rms64 == pytest.approx(rms_j, rel=1e-6)


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Matches of 4 synthetic fountain views at 256 px (352 keypoints, 64
    iterations): the triangulation-stage fixture's scene."""
    base = tmp_path_factory.mktemp("f64")
    ds = tsynth.make_dataset("fountain", n_cams=11, hw=256, seed=0)
    images = ds["images"][:N_VIEWS]
    f = ds["f"] * 1.03
    matches = str(base / "matches")
    tcm.run_compute_matches(images, matches, threshold=0.0007,
                            cfg=tcm.MatchConfig(ransac_iters=64),
                            focals=np.full(N_VIEWS, f), max_keypoints=352,
                            device="cpu")
    intr = np.zeros((1, 9), np.float32)
    intr[0, :3] = [f, 128.0, 128.0]
    kw = dict(intr_id=np.zeros(N_VIEWS, np.int32), intr=intr,
              models=np.asarray([PINHOLE], np.int32))
    return dict(base=base, ds=ds, images=images, matches=matches, kw=kw)


ENGINES = {"v1": dict(engine="incremental", initial_pair=(0, 1)),
           "incremental2": dict(engine="incremental2"),
           "global": dict(engine="global")}


def _draws(name):
    if name == "global":
        return GlobalReplay(jax.random.PRNGKey(0))
    return Replay(initial_pair=name == "v1")


def _run(stage, name, f64, package, draws_x64=None):
    """One package's run_triangulation into its own directory; returns
    (stats, directory). The port takes the reference's draws, made as in
    the reference run it is compared with: under x64 for the reference's
    f64 runs (``draws_x64`` defaults to ``f64``)."""
    out = str(stage["base"] / f"{name}_{'f64' if f64 else 'f32'}_{package}")
    draws_x64 = f64 if draws_x64 is None else draws_x64
    with x64() if (f64 if package == "ref" else draws_x64) \
            else contextlib.nullcontext():
        if package == "ref":
            return jts.run_triangulation(
                stage["matches"], out, stage["images"],
                params=jts.TriangulationParams(f64=f64, **ENGINES[name]),
                **stage["kw"]), out
        return tts.run_triangulation(
            stage["matches"], out, stage["images"],
            params=tts.TriangulationParams(f64=f64, **ENGINES[name]),
            device="cpu", sample_provider=_draws(name), **stage["kw"]), out


def _sim3_err(port, ref):
    """Largest centre distance between two runs after Sim3, as a fraction
    of the second run's extent."""
    a = jsd.load_npz(os.path.join(port, "scene.npz"))
    b = jsd.load_npz(os.path.join(ref, "scene.npz"))
    Ct, Cj = np.asarray(a.poses.C, np.float64), np.asarray(b.poses.C,
                                                           np.float64)
    aligned = jmet.umeyama(Ct, Cj).apply(Ct)
    return np.linalg.norm(aligned - Cj, axis=1).max() / np.ptp(Cj,
                                                               axis=0).max()


def _npz_dtypes(path):
    with np.load(os.path.join(path, "scene.npz")) as z:
        return {k: z[k].dtype for k in z.files}


def _agree(st, sj, port, ref):
    assert st["num_cameras"] == sj["num_cameras"] == N_VIEWS
    assert abs(st["num_tracks"] - sj["num_tracks"]) <= 0.02 * sj["num_tracks"]
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=0.05)
    err = _sim3_err(port, ref)
    assert err <= 1e-3, err
    return err


def test_f64_v1_matches_reference_f64(stage):
    """v1 (the user's initial pair) is the engine the reference runs in
    f64: both packages' f64 runs agree, centres within 1e-6 of the extent
    after Sim3 (the f32 runs: within 1e-3, ``tests/test_torch_f64_engines.
    py`` measures them) and rms within 1e-6, and scene.npz holds the dtypes
    the reference writes in f64, field by field."""
    sj, ref = _run(stage, "v1", True, "ref")
    st, port = _run(stage, "v1", True, "port")
    err64 = _agree(st, sj, port, ref)
    assert err64 <= 1e-6, err64
    assert st["rms_px"] == pytest.approx(sj["rms_px"], rel=1e-6)
    assert _npz_dtypes(port) == _npz_dtypes(ref)
    dt = _npz_dtypes(port)
    assert dt["poses.C"] == dt["landmarks.X"] == dt["observations.xy"] \
        == dt["intrinsics.params"] == np.float64
    print(f"v1 f64, port vs reference centres after Sim3 / extent "
          f"{err64:.3e}; rms px {st['rms_px']:.9f} / {sj['rms_px']:.9f}")


def test_f32_path_stays_float32(stage):
    """The default run keeps float32 in its inputs and every float field of
    its scene (no float64 leaks in from the f64 threading)."""
    inputs, _ = tts.build_sfm_inputs(
        stage["matches"], N_VIEWS, stage["kw"]["intr_id"],
        stage["kw"]["intr"], stage["kw"]["models"],
        np.asarray([[256, 256]] * N_VIEWS), "f", device="cpu")
    assert inputs.xy.dtype == inputs.intr.dtype == torch.float32
    inputs64, _ = tts.build_sfm_inputs(
        stage["matches"], N_VIEWS, stage["kw"]["intr_id"],
        stage["kw"]["intr"], stage["kw"]["models"],
        np.asarray([[256, 256]] * N_VIEWS), "f", dtype=np.float64,
        device="cpu")
    assert inputs64.xy.dtype == inputs64.intr.dtype == torch.float64
    # the same coordinates, read from the same f32 feature files
    np.testing.assert_array_equal(inputs64.xy.numpy(),
                                  inputs.xy.numpy().astype(np.float64))
