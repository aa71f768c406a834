"""The Schur PCG kernel (``csrc/schur_pcg.cu``) against the plain solve
(``ba/lm.py:_solve_schur``), both on the card.

These tests need a CUDA device and skip without one. On the card:

    python -m pytest tests/test_torch_schur_pcg_kernel.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not use.) The kernel sums in another order than the plain version (whose
sorted tables sum a segment sequentially in one thread), inverts the 3x3
point blocks by cofactors where the plain version factors them, and
contracts multiply-adds. Tolerances and their reasons:

* one solve at lam = 1, where the CG converges in 10-12 steps and carries
  no rounding far: (dc, dp, di) each within 1e-4 (float32) or 1e-10
  (float64) of its largest entry (on an H100: at most 6.9e-6 and
  5.7e-15);
* one solve at lam = 1e-3 through 40 CG steps that do not converge: 40
  steps amplify any change of rounding (the plain version against itself
  on the other table form: 4e-4 to 3.4e-2 in float32, 1e-11 to 1.2e-5 in
  float64), so the kernel is held to four times that yardstick (on an
  H100: at most 1.5 times);
* the kernel against itself: the same bits in two calls (no atomics), and
  once ``cg_iterations`` reaches the step where the CG stops, the same
  bits for every larger count (the plain loop's frozen state);
* a whole ``bundle_adjust`` that converges: the final cost within 1e-3 of
  the plain solve's, as the port's is held to the reference's (the plain
  version's two table forms end 3e-7 to 2.5e-5 apart).
"""

import dataclasses

import pytest
import torch

from regard3d_tpu_torch import spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core.types import PINHOLE, RADIAL_K3
from regard3d_tpu_torch.kernels import _build
from tests.test_torch_schur_pcg import ba_problem, solve_inputs

pytestmark = pytest.mark.card

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}

# (problem arguments, options)
CASES = {
    "radial_refine_prior": (dict(model=RADIAL_K3), dict(
        refine_intrinsics=True, huber_delta_px=2.0, center_prior_weight=0.5)),
    "groups": (dict(model=PINHOLE, groups=3), dict(refine_intrinsics=True)),
    "intrinsics_fixed": (dict(model=RADIAL_K3), dict(huber_delta_px=2.0)),
    "wide": (dict(model=RADIAL_K3, n_cams=19, n_pts=2500, seed=5), dict(
        refine_intrinsics=True, huber_delta_px=2.0)),
}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run these tests on the card")
    return torch.device("cuda", 0)


def _inputs(dev, case, dtype, form, **opt_kw):
    kw, okw = CASES[case]
    state, obs, fixed, prior = ba_problem(dtype=dtype, device=dev, **kw)
    opts = lm.BAOptions(**{**okw, **opt_kw})
    pad = 1e9 if form == "padded" else 0.0
    nb, layout, imask = solve_inputs(state, obs, opts, fixed, prior, pad)
    assert (layout.pt.rows is None) == (form == "sorted")
    return state, obs, fixed, opts, nb, layout, imask


def _kernel(nb, obs, opts, fixed, imask, layout, lam=1e-3, steps=None):
    out = lm._solve_schur_kernel(nb, obs, lam, opts, fixed, imask, layout,
                                 steps)
    torch.cuda.synchronize()
    return out


def _rel_err(got, want):
    return [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("form", ["padded", "sorted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_solve(dev, case, dtype, form):
    """One damped solve at lam = 1 against ``_solve_schur`` on the same
    inputs, and the same bits in a second call; one launch a call; fixed
    cameras and (where none is refined) intrinsics do not move."""
    state, obs, fixed, opts, nb, layout, imask = _inputs(dev, case, dtype,
                                                         form)
    want = lm._solve_schur(nb, obs, 1.0, state, opts, fixed, imask, layout)
    tag = "f32" if dtype == torch.float32 else "f64"
    before = _build.LAUNCHES[f"schur_pcg_{tag}"]
    got = _kernel(nb, obs, opts, fixed, imask, layout, lam=1.0)
    again = _kernel(nb, obs, opts, fixed, imask, layout, lam=1.0)
    assert _build.LAUNCHES[f"schur_pcg_{tag}"] == before + 2
    assert all(g.dtype == dtype and g.shape == w.shape
               for g, w in zip(got, want))
    err = _rel_err(got, want)
    assert max(err) <= TOL[dtype], (case, dtype, form, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if not opts.refine_intrinsics:
        assert not got[2].any()
    assert not got[0][fixed].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_tracks_plain_solve_through_40_steps(dev, case, dtype):
    """At lam = 1e-3 through 40 CG steps, on both table forms, the kernel
    is within four times the plain version's own spread between the two
    forms, and gives the same bits in a second call."""
    out = {}
    for form in ("padded", "sorted"):
        state, obs, fixed, opts, nb, layout, imask = _inputs(dev, case,
                                                             dtype, form)
        want = lm._solve_schur(nb, obs, 1e-3, state, opts, fixed, imask,
                               layout)
        got = _kernel(nb, obs, opts, fixed, imask, layout)
        again = _kernel(nb, obs, opts, fixed, imask, layout)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        out[form] = (got, want)
    yard = max(_rel_err(out["sorted"][1], out["padded"][1]))
    err = [max(_rel_err(*out[f])) for f in ("padded", "sorted")]
    assert max(err) <= 4 * max(yard, TOL[dtype]), (case, dtype, err, yard)


@pytest.mark.parametrize("form", ["padded", "sorted"])
def test_cg_iterations_against_the_early_stop(dev, form):
    """With cg_tol 1e-2 the kernel's result for k CG iterations changes up
    to the step n where its stop triggers and never after (k = 200
    included); it ran min(k, n) steps, and the plain loop's frozen state
    freezes within one step of n. With cg_tol 0 every step counts."""
    state, obs, fixed, opts, nb, layout, imask = _inputs(
        dev, "radial_refine_prior", torch.float32, form)

    def run(k, tol=1e-2):
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        o = dataclasses.replace(opts, cg_iterations=k, cg_tol=tol)
        return _kernel(nb, obs, o, fixed, imask, layout, steps=steps), \
            int(steps)
    full, n = run(40)
    same = []
    for k in range(1, 41):
        out, ran = run(k)
        assert ran == min(k, n), (k, ran, n)
        same.append(all(torch.equal(a, b) for a, b in zip(out, full)))
    assert 1 < n < 40 and same.index(True) + 1 == n and all(same[n - 1:])
    assert all(torch.equal(a, b) for a, b in zip(run(200)[0], full))
    assert run(200)[1] == n

    def plain(k):
        o = dataclasses.replace(opts, cg_iterations=k, cg_tol=1e-2)
        return lm._solve_schur(nb, obs, 1e-3, state, o, fixed, imask, layout)
    pfull = plain(40)
    n_plain = next(k for k in range(1, 41) if all(
        torch.equal(a, b) for a, b in zip(plain(k), pfull)))
    assert abs(n_plain - n) <= 1, (n_plain, n)
    assert max(_rel_err(full, pfull)) <= 1e-4
    out40, ran40 = run(40, 0.0)
    out41, ran41 = run(41, 0.0)
    assert (ran40, ran41) == (40, 41)
    assert not all(torch.equal(a, b) for a, b in zip(out40, out41))


@pytest.mark.parametrize("case", ["groups", "intrinsics_fixed", "wide"])
def test_bundle_adjust_reaches_the_plain_cost(dev, case, monkeypatch):
    """``bundle_adjust`` on the card with the kernel (one launch a trial,
    counted on the spans) reaches the final cost of the same run with the
    plain solve within 1e-3. (``radial_refine_prior`` is left out: in
    float32 it creeps down a valley for 100 iterations and more, and the
    plain version's two table forms end 0.35-0.5% apart.)"""
    kw, okw = CASES[case]
    state, obs, fixed, prior = ba_problem(device=dev, **kw)
    opts = lm.BAOptions(max_iterations=40, **okw)
    before = _build.LAUNCHES["schur_pcg_f32"]
    with spans.collect() as c, spans.span("triangulation.ba"):
        out, st = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                   center_prior=prior, device=dev)
    summary = c.summary()
    assert _build.LAUNCHES["schur_pcg_f32"] == before + st.iterations
    assert summary["triangulation.ba.trial"]["pcg_kernel"] == st.iterations
    steps = summary["triangulation.ba"]["pcg_steps"]
    assert st.iterations <= steps <= 40 * st.iterations
    with monkeypatch.context() as m:
        m.setattr(lm, "_pcg_on_card", lambda x, cr, pr: False)
        _, sp = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                 center_prior=prior, device=dev)
    assert _build.LAUNCHES["schur_pcg_f32"] == before + st.iterations
    assert st.final_cost == pytest.approx(sp.final_cost, rel=1e-3)
    assert st.final_cost < st.initial_cost
    assert torch.equal(out.R[fixed], state.R[fixed])
