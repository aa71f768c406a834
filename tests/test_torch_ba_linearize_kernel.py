"""The linearisation and cost kernels (``csrc/ba_linearize.cu``) against
the plain ``lm._normal_blocks`` / ``lm._build_blocks`` and
``lm.compute_cost``, both on the card.

These tests need a CUDA device and skip without one. On the card:

    python -m pytest tests/test_torch_ba_linearize_kernel.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not use.) The kernel takes the Jacobian in closed form where the plain
version runs a jvp, sums in another order and contracts multiply-adds.
Tolerances and their reasons:

* per row (r, A, B, Ji, w): within 1e-5 (float32) or 1e-12 (float64) of
  the row's largest entry (the residual: of the observed pixel's, as it is
  the difference of two such values; the weight: of the plain IRLS weight
  of the kernel's own residual), rows masked or not finite exact zeros in
  both;
* the block sums (U, Vl, Ui, gc, gp, gi): within 1e-4 (float32) or 1e-12
  (float64) of the sum of the absolute values of their terms, what a
  change of summation order can move over segments of up to ~2,000 rows;
* the cost: within 1e-5 (float32) or 1e-12 (float64) of itself (its terms
  are not negative);
* the kernels against themselves: the same bits in two calls (no
  atomics);
* a whole ``bundle_adjust`` through the three kernels that converges: the
  final cost within 1e-3 of the plain run's, as the Schur PCG kernel's
  card tests hold it.
"""

import pytest
import torch

from regard3d_tpu_torch import spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core.segments import segment_sum
from regard3d_tpu_torch.kernels import _build, ba_linearize
from tests.test_torch_ba_linearize import MODELS, mixed_problem
from tests.test_torch_schur_pcg import ba_problem
from tests.test_torch_schur_pcg_kernel import CASES

pytestmark = pytest.mark.card

ROW_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SUM_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
TAG = {torch.float32: "f32", torch.float64: "f64"}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run these tests on the card")
    return torch.device("cuda", 0)


def _layout(state, obs, form):
    layout = lm.make_layout(obs, state.R.shape[0], state.X.shape[0],
                            state.intr.shape[0],
                            1e9 if form == "padded" else 0.0)
    assert (layout.pt.rows is None) == (form == "sorted")
    return layout


def _row_err(got, want, scale=None):
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    s = (w if scale is None else scale).abs().amax(1).clamp_min(1e-30)
    return float(((g - w).abs().amax(1) / s).max())


def _abs_sums(r, A, B, Ji, w, layout):
    """The block sums of the terms' absolute values: the scale of what a
    change of summation order can move."""
    aw = w.abs()[:, None, None]
    out = lambda J: (J.abs() * aw).transpose(-1, -2) @ J.abs()
    jr = lambda J: ((J.abs() * aw).transpose(-1, -2)
                    @ r.abs()[..., None])[..., 0]
    return (segment_sum(out(A), layout.cam), segment_sum(out(B), layout.pt),
            segment_sum(out(Ji), layout.intr),
            segment_sum(jr(A), layout.cam), segment_sum(jr(B), layout.pt),
            segment_sum(jr(Ji), layout.intr))


def _linearize(state, obs, opts, layout):
    c = lambda t: t.contiguous()
    out = ba_linearize.linearize(*map(c, state), *map(c, obs), *layout,
                                 opts.huber_delta_px)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["padded", "sorted"])
@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("model", ["mixed"] + [str(m) for m in MODELS])
def test_linearize_matches_plain(dev, model, huber, form, dtype):
    """One linearisation against ``_build_blocks`` and ``_normal_blocks``
    on the same inputs (rows masked by weight 0, rows behind a camera,
    rows whose projection is not finite); the same bits in a second call;
    one launch a call."""
    models = MODELS if model == "mixed" else (int(model),)
    state, obs, _ = mixed_problem(models, dtype=dtype, device=dev)
    opts = lm.BAOptions(huber_delta_px=huber)
    layout = _layout(state, obs, form)
    key = f"ba_linearize_{TAG[dtype]}"
    before = _build.LAUNCHES[key]
    got = _linearize(state, obs, opts, layout)
    again = _linearize(state, obs, opts, layout)
    assert _build.LAUNCHES[key] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    r, A, B, Ji, w = got[:5]
    wr, wA, wB, wJi, _ = lm._build_blocks(state, obs, opts)
    nb = lm._normal_blocks(state, obs, opts, layout)
    assert all(g.dtype == dtype and g.is_contiguous() for g in got)
    for name, g, want in (("r", r, wr), ("A", A, wA), ("B", B, wB),
                          ("Ji", Ji, wJi)):
        assert g.shape == want.shape
        err = _row_err(g, want, obs.xy if name == "r" else None)
        assert err <= ROW_TOL[dtype], (name, err)
    ww = obs.weight * lm._irls_weights(torch.sum(r * r, -1), opts)
    assert float(((w - ww).abs() / ww.abs().clamp_min(1e-30)).max()) \
        <= ROW_TOL[dtype]
    dead = (obs.weight <= 0) | ~torch.isfinite(state.X[obs.point_id]).all(1)
    assert dead.any() and not any(t[dead].any() for t in (r, A, B, Ji))
    scale = _abs_sums(r, A, B, Ji, w, layout)
    for name, g, want, s in zip(("U", "Vl", "Ui", "gc", "gp", "gi"),
                                got[5:], [nb.U, nb.Vl, nb.Ui, nb.gc, nb.gp,
                                          nb.gi], scale):
        assert g.shape == want.shape
        err = float(((g - want).abs() / s.clamp_min(1e-30)).max())
        assert err <= SUM_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("model", ["mixed"] + [str(m) for m in MODELS])
def test_cost_matches_plain(dev, model, huber, poison, dtype):
    """One cost read against ``compute_cost`` (with poisoned rows, whose
    1e12 swamps the rest, and without); the same bits in a second call; a
    0-dim tensor on the card; one launch a call."""
    models = MODELS if model == "mixed" else (int(model),)
    state, obs, _ = mixed_problem(models, dtype=dtype, device=dev,
                                  poison=poison)
    opts = lm.BAOptions(huber_delta_px=huber)
    key = f"ba_cost_{TAG[dtype]}"
    before = _build.LAUNCHES[key]
    got = ba_linearize.cost(*state, *obs, huber)
    again = ba_linearize.cost(*state, *obs, huber)
    assert _build.LAUNCHES[key] == before + 2
    assert got.shape == () and got.dtype == dtype and got.is_cuda
    assert torch.equal(got, again)
    want = lm.compute_cost(state, obs, opts)
    assert float(abs(got - want) / want) <= ROW_TOL[dtype]


def test_empty_table(dev):
    """No observations: every block sum 0, the cost 0."""
    state, obs, _ = mixed_problem(device=dev, poison=False)
    obs = lm.BAObservations(*(t[:0] for t in obs))
    layout = _layout(state, obs, "sorted")
    got = _linearize(state, obs, lm.BAOptions(), layout)
    assert all(t.numel() == 0 for t in got[:5])
    assert not any(t.any() for t in got[5:])
    assert float(ba_linearize.cost(*state, *obs, 0.0)) == 0.0


@pytest.mark.parametrize("case", ["groups", "intrinsics_fixed", "wide",
                                  "mixed"])
def test_bundle_adjust_reaches_the_plain_cost(dev, case, monkeypatch):
    """``bundle_adjust`` on the card through the kernels (a linearisation
    and a solve a trial, a cost read a trial and one before, counted on
    the spans and in ``_build.LAUNCHES``) reaches the final cost of the
    same run on the plain path within 1e-3: the Schur PCG kernel's card
    tests' converging cases, and a table mixing the five models."""
    if case == "mixed":
        state, obs, fixed = mixed_problem(device=dev, poison=False)
        prior = None
        opts = lm.BAOptions(max_iterations=40, refine_intrinsics=True,
                            huber_delta_px=2.0)
    else:
        kw, okw = CASES[case]
        state, obs, fixed, prior = ba_problem(device=dev, **kw)
        opts = lm.BAOptions(max_iterations=40, **okw)
    keys = ("ba_linearize_f32", "ba_cost_f32", "schur_pcg_f32")
    before = {k: _build.LAUNCHES[k] for k in keys}
    with spans.collect() as c, spans.span("triangulation.ba"):
        out, st = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                   center_prior=prior, device=dev)
    summary = c.summary()
    n = st.iterations
    assert [_build.LAUNCHES[k] - before[k] for k in keys] == [n, n + 1, n]
    trial = summary["triangulation.ba.trial"]
    assert trial["ba_kernel"] == trial["pcg_kernel"] == n
    assert summary["triangulation.ba.cost"]["cost_kernel"] == n + 1
    with monkeypatch.context() as m:
        m.setattr(lm, "_pcg_on_card", lambda x, cr, pr: False)
        _, sp = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                 center_prior=prior, device=dev)
    assert [_build.LAUNCHES[k] - before[k] for k in keys] == [n, n + 1, n]
    assert st.final_cost == pytest.approx(sp.final_cost, rel=1e-3)
    assert st.final_cost < st.initial_cost
    assert torch.equal(out.R[fixed], state.R[fixed])


def test_trial_kernels_agree_with_plain_trial(dev):
    """One ``lm_trial`` through the kernels against the plain trial (a
    reduce hook that sums nothing keeps the plain path) at lam = 1, where
    the CG converges: the new states within 1e-4 of their largest entries,
    intrinsics refined and fixed."""
    state, obs, fixed = mixed_problem(device=dev, poison=False)
    layout = _layout(state, obs, "padded")
    for refine in (True, False):
        opts = lm.BAOptions(refine_intrinsics=refine, huber_delta_px=2.0)
        imask = lm.intr_mask_of(obs, state.intr.shape[0], refine)
        got = lm.lm_trial(state, 1.0, obs, opts, fixed, imask, None, layout)
        want = lm.lm_trial(state, 1.0, obs, opts, fixed, imask, None, layout,
                           lambda t, site: t)
        for g, w in zip(got, want):
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= 1e-4, (refine, err)
        if not refine:
            assert torch.equal(got.intr, state.intr)
