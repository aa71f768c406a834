"""Communication accounting for the distributed BA paths.

Counterpart of ``regard3d_tpu/ba/dossier.py``. The claim it checks: point-
block sharding's traffic per CG step does not depend on the landmark
count, while the observation-sharded path sums an (L,3) tensor every
matvec.

* ``analytic_collectives`` — the closed-form per-trial payload table for
  both shardings, as in the reference.
* ``record_trial`` — the port's counterpart of the reference's HLO parse
  (``hlo_collectives`` / ``collective_summary``): it runs one LM trial of
  either sharding with every reduction hook wrapped by a ``Recorder`` and
  returns the calls and bytes at each site (``linearize``, ``rhs``,
  ``cg_step``, ``back_substitution``, ``cost``), as one shard sends them.

The reference's ``memory_report`` reads XLA's compiled memory analysis; a
PyTorch program has none, so the port reads ``torch.cuda.
max_memory_allocated`` around a run on the card instead
(``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from regard3d_tpu_torch.ba import lm, sharded
from regard3d_tpu_torch.dist import mesh as meshlib


def analytic_collectives(V: int, L: int, K: int, cg_iters: int,
                         dtype_bytes: int = 4) -> Dict:
    """Closed-form per-trial reduction payloads for both shardings.

    obs-sharded (``bundle_adjust_sharded``): a point's rows live on several
    shards, so every per-point segment reduction is summed —
      linearize: (V,6,6)+(K,9,9)+(V,6)+(K,9) camera blocks
                 + (L,3,3) V-blocks + (L,3) gp;
      each CG matvec: (L,3) t + (V,6)+(K,9);
      rhs build (W_y): (V,6)+(K,9); WT_x (back-substitution): (L,3).

    point-sharded (``bundle_adjust_point_sharded``): landmarks and their
    rows are co-located, every per-point reduction is shard-local —
    only the reduced camera system is summed:
      linearize: (V,6,6)+(K,9,9)+(V,6)+(K,9);
      each CG matvec: (V,6)+(K,9);
      rhs: (V,6)+(K,9).
    Plus one scalar cost sum per trial in both."""
    cam_blocks = (V * 36 + K * 81 + V * 6 + K * 9) * dtype_bytes
    cam_sys = (V * 6 + K * 9) * dtype_bytes
    point_blocks = (L * 9 + L * 3) * dtype_bytes
    point_vec = L * 3 * dtype_bytes

    obs_per_cg = point_vec + cam_sys
    pt_per_cg = cam_sys
    obs_trial = (cam_blocks + point_blocks          # linearize
                 + cam_sys                          # rhs (W_y)
                 + cg_iters * obs_per_cg            # CG
                 + point_vec                        # back-substitution WT_x
                 + dtype_bytes)                     # cost scalar
    pt_trial = (cam_blocks + cam_sys + cg_iters * pt_per_cg + dtype_bytes)
    return {
        "V": V, "L": L, "K": K, "cg_iters": cg_iters,
        "obs_sharded": {
            "per_cg_step_bytes": obs_per_cg,
            "per_trial_bytes": obs_trial,
            "landmark_dependent": True,
        },
        "point_sharded": {
            "per_cg_step_bytes": pt_per_cg,
            "per_trial_bytes": pt_trial,
            "landmark_dependent": False,
        },
        "ratio_per_cg_step": obs_per_cg / max(pt_per_cg, 1),
    }


class Recorder:
    """Calls and bytes of each reduction site, as one participant sends
    them."""

    def __init__(self):
        self.sites: Dict[str, Dict[str, int]] = {}

    def wrap(self, inner: lm.Reduce) -> lm.Reduce:
        def reduce(tensors, site):
            rec = self.sites.setdefault(site, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size()
                                for t in tensors)
            return inner(tensors, site)
        return reduce


def record_trial(state: lm.BAState, obs: lm.BAObservations, sharding: str,
                 mesh: meshlib.Mesh, opts: lm.BAOptions = lm.BAOptions(),
                 fixed_pose_mask: Optional[torch.Tensor] = None,
                 lam: float = 1e-3) -> Dict:
    """One LM trial (linearize, Schur/CG solve, cost of the new state) of
    ``sharding`` ("obs" or "point") over the positions of ``mesh``, every
    reduction of shard 0 recorded. Returns ``{sites, per_trial_bytes,
    per_cg_step_bytes}``; the CG runs its fixed ``opts.cg_iterations``
    steps, each with its reductions."""
    if sharding == "obs":
        shards = sharded._obs_shards(state, obs, opts, fixed_pose_mask, None,
                                     mesh.device_list)
    elif sharding == "point":
        shards, _ = sharded._point_shards(state, obs, mesh, opts,
                                          fixed_pose_mask, None, None)
    else:
        raise ValueError(f"sharding {sharding!r}: 'obs' or 'point'")
    rec = Recorder()

    def body(d, sh, red):
        cam = rec.wrap(red) if d == 0 else red
        pt = cam if sharding == "obs" else lm.identity_reduce
        with torch.no_grad():
            new = lm.lm_trial(sh.state, lam, sh.obs, opts, sh.fixed,
                              sh.intr_mask, None, sh.layout, cam, pt)
            return float(lm._full_cost(new, sh.obs, opts, None, cam))

    sharded._run_local(mesh, shards, body)
    cg = rec.sites.get("cg_step", {"bytes": 0})["bytes"]
    return {"sites": rec.sites,
            "per_trial_bytes": sum(r["bytes"] for r in rec.sites.values()),
            "per_cg_step_bytes": cg // max(opts.cg_iterations, 1)}
