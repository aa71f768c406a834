"""Port parity: the distributed BA's communication accounting
(``ba/dossier.py``) against the JAX package, on the CPU.

* ``analytic_collectives``: the reference's table, value for value.
* ``record_trial``: the bytes that one LM trial's reductions move, as shard
  0 sends them, equal the analytic table for both shardings, site by site
  in total and per CG step — the counterpart of the reference's HLO parse
  (``tests/test_ba_dossier.py``).
* The point-sharded bytes of a CG step do not change when the landmarks
  grow 4x; the observation-sharded ones grow by exactly 3 x 4 bytes per
  added landmark (``tests/test_ba_dossier.py:41``).
"""

import numpy as np
import pytest
import torch

from regard3d_tpu.ba import dossier as jdos
from regard3d_tpu_torch.ba import dossier as tdos
from regard3d_tpu_torch.ba import lm as tlm
from regard3d_tpu_torch.core.types import (ba_observations_from_numpy,
                                           ba_state_from_numpy)
from regard3d_tpu_torch.dist import mesh as tmesh
from tests.test_ba import synth_ba_problem

torch.set_num_threads(min(2, torch.get_num_threads()))

V, CG = 6, 3


@pytest.mark.parametrize("V_,L,K,cg,nb", [(12, 512, 1, 3, 4),
                                          (300, 200000, 7, 40, 4),
                                          (5, 1, 2, 0, 8)])
def test_analytic_collectives_match_reference(V_, L, K, cg, nb):
    assert tdos.analytic_collectives(V_, L, K, cg, nb) == \
        jdos.analytic_collectives(V_, L, K, cg, nb)


def _record(sharding, n_pts, n_shards=2):
    js, _, jo = synth_ba_problem(np.random.default_rng(1), n_cams=V,
                                 n_pts=n_pts)
    ts = ba_state_from_numpy(*(np.asarray(a) for a in js))
    to = ba_observations_from_numpy(*(np.asarray(a) for a in jo))
    fixed = torch.zeros(V, dtype=torch.bool)
    fixed[0] = True
    return tdos.record_trial(ts, to, sharding,
                             tmesh.make_mesh("obs", ["cpu"] * n_shards),
                             tlm.BAOptions(cg_iterations=CG),
                             fixed_pose_mask=fixed)


@pytest.mark.parametrize("sharding", ["obs", "point"])
@pytest.mark.parametrize("n_pts", [60, 240])
def test_recorded_trial_bytes_equal_the_table(sharding, n_pts):
    rec = _record(sharding, n_pts)
    want = jdos.analytic_collectives(V, n_pts, 1, CG)[f"{sharding}_sharded"]
    assert rec["per_trial_bytes"] == want["per_trial_bytes"]
    assert rec["per_cg_step_bytes"] == want["per_cg_step_bytes"]
    sites = rec["sites"]
    assert sites["cg_step"]["calls"] == CG * (2 if sharding == "obs" else 1)
    assert sites["cost"] == {"calls": 1, "bytes": 4}
    assert ("back_substitution" in sites) == (sharding == "obs")


def test_point_sharded_per_cg_bytes_independent_of_L():
    small, big = (_record("point", n) for n in (60, 240))
    assert small["per_cg_step_bytes"] == big["per_cg_step_bytes"]
    assert small["sites"] == big["sites"]
    o_small, o_big = (_record("obs", n) for n in (60, 240))
    assert (o_big["per_cg_step_bytes"] - o_small["per_cg_step_bytes"]
            == 3 * 4 * (240 - 60))
