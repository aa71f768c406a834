"""The bundle adjustment's linearisation and cost kernels on any machine.

``csrc/ba_linearize.cu`` keeps a row's projection, its closed-form
Jacobian, the masking, the IRLS weight, the cost term and a point's sums
in ``__host__ __device__`` functions; outside nvcc the file is plain C++
without its kernels. Here g++ builds those functions behind a small C
interface and they are held against the plain ``lm._build_blocks``,
``lm.compute_cost`` and ``lm._normal_blocks`` on the CPU: every camera
model, Huber on and off, rows masked by weight 0, rows behind the camera
and rows whose projection is not finite, in float32 and float64.

Then which path a bundle adjustment takes: ``lm_trial`` and ``_full_cost``
launch the kernels (``kernels/ba_linearize.py``) only for CUDA tensors with
both reduce hooks ``identity_reduce``; CPU tensors and the sharded hooks
take the plain versions. The kernels' wrapper raises on what they cannot
take and nothing falls back from it. The counters ``ba_kernel`` (on
``.trial``) and ``cost_kernel`` (on ``.cost``) reach a step's
``stats["spans"]``: shown here with the launches replaced by the plain
versions. The kernels themselves run in
``tests/test_torch_ba_linearize_kernel.py``, on the card.
"""

import ctypes
import hashlib
import shutil

import numpy as np
import pytest
import torch

from regard3d_tpu_torch import spans
from regard3d_tpu_torch.ba import lm
from regard3d_tpu_torch.core import cameras as cam
from regard3d_tpu_torch.core.types import (BROWN_T2, FISHEYE, PINHOLE,
                                           RADIAL_K1, RADIAL_K3)
from regard3d_tpu_torch.kernels import _build, ba_linearize, schur_pcg
from tests.test_torch_schur_pcg import (plain_cost, plain_launch,
                                        plain_linearize)

torch.set_num_threads(min(2, torch.get_num_threads()))

MODELS = (PINHOLE, RADIAL_K1, RADIAL_K3, BROWN_T2, FISHEYE)
# each model's distortion d0..d5 in the problems
DISTO = {PINHOLE: (0, 0, 0, 0, 0, 0), RADIAL_K1: (-0.1, 0, 0, 0, 0, 0),
         RADIAL_K3: (-0.15, 0.03, -0.005, 0, 0, 0),
         BROWN_T2: (-0.15, 0.03, -0.005, 0.001, -0.002, 0),
         FISHEYE: (0.05, -0.01, 0.002, -0.0005, 0, 0)}


def mixed_problem(models=MODELS, seed=0, n_cams=6, n_pts=80,
                  dtype=torch.float32, device="cpu", poison=True):
    """Cameras on an arc around a cloud, every point in every view, rows
    shuffled; intrinsic group g has model ``models[g]`` and camera v is in
    group v % len(models). The state is perturbed from the truth (poses,
    points, focal 2% off, distortion halved). ``poison``: 40 rows at weight
    0 moved by 1000 px, two points behind camera 0 (negative depth, finite
    projection), and two points whose projection is not finite (their
    coordinates NaN and inf) seen at weight 1. Returns (state, obs, fixed:
    camera 0)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_pts, 3)) * [2, 1.5, 1] + [0, 0, 8]
    a = -0.3 + 0.6 * np.arange(n_cams) / max(n_cams - 1, 1)
    R = cam.exp_so3(torch.tensor(np.stack([0 * a, a, 0 * a], 1)))
    C = np.stack([-8 * np.sin(a), 0.3 * rng.normal(size=n_cams),
                  8 - 8 * np.cos(a)], 1)
    K = len(models)
    intr = np.zeros((K, 9))
    intr[:, :3] = [900.0, 640.0, 480.0]
    intr[:, 3:] = [DISTO[m] for m in models]
    O = n_cams * n_pts
    perm = rng.permutation(O)
    vid = np.repeat(np.arange(n_cams), n_pts)[perm]
    pid = np.tile(np.arange(n_pts), n_cams)[perm]
    gid = vid % K
    mdl = np.asarray(models)[gid]
    uv, _ = cam.project(R[vid], torch.tensor(C)[vid], torch.tensor(mdl),
                        torch.tensor(intr)[gid], torch.tensor(X)[pid])
    xy = uv.numpy() + rng.normal(size=(O, 2)) * 0.5
    weight = np.ones(O)
    Rp = cam.exp_so3(torch.tensor(rng.normal(size=(n_cams, 3)) * 0.01)) @ R
    Cp = C + rng.normal(size=C.shape) * 0.05
    Xp = X + rng.normal(size=X.shape) * 0.05
    if poison:
        xy[:40] += 1000.0
        weight[:40] = 0.0
        # behind camera 0: mirrored through its centre along its axis
        axis = R[0, 2].numpy()
        for p in (1, 2):
            Xp[p] = Cp[0] - axis * (2.0 + p)
        Xp[3] = np.nan
        Xp[4] = np.inf
        weight[np.isin(pid, [3, 4])] = 1.0
    intr_p = intr.copy()
    intr_p[:, 0] *= 1.02
    intr_p[:, 3:] *= 0.5
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                  device=device)
    state = lm.BAState(R=f(Rp), C=f(Cp), intr=f(intr_p), X=f(Xp))
    obs = lm.BAObservations(view_id=i(vid), intr_id=i(gid), point_id=i(pid),
                            model=i(mdl), xy=f(xy), weight=f(weight))
    fixed = torch.zeros(n_cams, dtype=torch.bool, device=device)
    fixed[0] = True
    return state, obs, fixed


# ---------------------------------------------------------------------------
# the kernel source's arithmetic, built for the host
# ---------------------------------------------------------------------------

SHIM = r"""
#include "ba_linearize.cu"

template <typename T>
static void rows(long long O, const T* R, const T* C, const T* p,
                 const T* X, const T* xy, const long long* model,
                 const T* weight, double huber, T* r, T* A, T* B, T* Ji,
                 T* w, T* cost) {
  for (long long o = 0; o < O; ++o) {
    T rr[2];
    bal::project<T, false>(R + o * 9, C + o * 3, p + o * 9, X + o * 3,
                           xy + o * 2, int(model[o]), rr, nullptr, nullptr,
                           nullptr);
    cost[o] = bal::cost_term(rr, weight[o], huber);
    bal::project<T, true>(R + o * 9, C + o * 3, p + o * 9, X + o * 3,
                          xy + o * 2, int(model[o]), r + o * 2, A + o * 12,
                          B + o * 6, Ji + o * 18);
    w[o] = bal::mask_row(weight[o], huber, r + o * 2, A + o * 12, B + o * 6,
                         Ji + o * 18);
  }
}

template <typename T>
static void points(long long L, const long long* idx, const float* mask,
                   const long long* len, long long* start, long long cap,
                   const T* B, const T* w, const T* r, T* out) {
  baseg::Table tb{idx, mask, len, start, nullptr, nullptr, L, cap};
  for (long long l = 0; l < L; ++l)
    bal::point_sums(tb, l, B, w, r, out + l * bal::POINT_SUMS);
}

extern "C" void bal_rows(int dtype, long long O, const void* R,
                         const void* C, const void* p, const void* X,
                         const void* xy, const long long* model,
                         const void* weight, double huber, void* r, void* A,
                         void* B, void* Ji, void* w, void* cost) {
  if (dtype == 0)
    rows<float>(O, (const float*)R, (const float*)C, (const float*)p,
                (const float*)X, (const float*)xy, model,
                (const float*)weight, huber, (float*)r, (float*)A,
                (float*)B, (float*)Ji, (float*)w, (float*)cost);
  else
    rows<double>(O, (const double*)R, (const double*)C, (const double*)p,
                 (const double*)X, (const double*)xy, model,
                 (const double*)weight, huber, (double*)r, (double*)A,
                 (double*)B, (double*)Ji, (double*)w, (double*)cost);
}

extern "C" void bal_points(int dtype, long long L, const long long* idx,
                           const float* mask, const long long* len,
                           long long* start, long long cap, const void* B,
                           const void* w, const void* r, void* out) {
  if (dtype == 0)
    points<float>(L, idx, mask, len, start, cap, (const float*)B,
                  (const float*)w, (const float*)r, (float*)out);
  else
    points<double>(L, idx, mask, len, start, cap, (const double*)B,
                   (const double*)w, (const double*)r, (double*)out);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The shim built by g++ against csrc/ba_linearize.cu (the hash of the
    source and its header in the shim, so an edited kernel source is built
    again)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ compiler to build the kernel source for the host")
    tag = hashlib.sha1(_build._source_bytes(
        f"{_build.CSRC}/{ba_linearize._SOURCE}")).hexdigest()
    shim = tmp_path_factory.mktemp("bal") / "bal_host.cpp"
    shim.write_text(f"// {ba_linearize._SOURCE} {tag}\n{SHIM}")
    lib = ctypes.CDLL(_build.compile_library(
        gxx, ["-O2", "-std=c++17", "-shared", "-fPIC", "-I", _build.CSRC],
        str(shim)))
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.bal_rows.argtypes = ([ctypes.c_int, L] + [P] * 7
                             + [ctypes.c_double] + [P] * 6)
    lib.bal_points.argtypes = [ctypes.c_int, L] + [P] * 4 + [L] + [P] * 4
    return lib


def _np(t):
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def host_rows(host, state, obs, huber):
    """The shim's per-row (r, A, B, Ji, w, cost term), as torch tensors."""
    R, C, intr, X = state
    v, g, p = obs.view_id, obs.intr_id, obs.point_id
    ins = [_np(t) for t in (R[v], C[v], intr[g], X[p], obs.xy)]
    model, weight = _np(obs.model), _np(obs.weight)
    O, dt = model.shape[0], ins[0].dtype
    outs = [np.zeros((O,) + s, dt) for s in ((2,), (2, 6), (2, 3), (2, 9),
                                             (), ())]
    host.bal_rows(int(dt == np.float64), O, *map(_ptr, ins), _ptr(model),
                  _ptr(weight), float(huber), *map(_ptr, outs))
    return [torch.from_numpy(a) for a in outs]


def _row_err(got, want, scale=None):
    """The largest error of each row over the row's largest entry (of
    ``want``, or of ``scale``), the worst row's."""
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = (w if scale is None else scale).abs().amax(1).clamp_min(1e-30)
    return float(((g - w).abs().amax(1) / scale).max())


TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("model", ["mixed"] + [str(m) for m in MODELS])
def test_host_rows_match_plain_linearisation(host, model, huber, dtype):
    """Each row's residual, Jacobian blocks and weight from the kernel
    source against ``_build_blocks`` (the vmap-ped jvp): within 1e-5
    (float32) or 1e-12 (float64) of the row's largest entry (the residual:
    of the observed pixel's, since it is a difference of two such values);
    rows at weight 0 and rows whose projection is not finite give exact
    zeros in both; the weights are the plain IRLS weights of the kernel
    source's residuals, to the same tolerance."""
    models = MODELS if model == "mixed" else (int(model),)
    state, obs, _ = mixed_problem(models, dtype=dtype)
    r, A, B, Ji, w, _ = host_rows(host, state, obs, huber)
    opts = lm.BAOptions(huber_delta_px=huber)
    wr, wA, wB, wJi, _ = lm._build_blocks(state, obs, opts)
    ww = obs.weight * lm._irls_weights(torch.sum(r * r, -1), opts)
    for name, got, want in (("r", r, wr), ("A", A, wA), ("B", B, wB),
                            ("Ji", Ji, wJi)):
        assert got.dtype == dtype and got.shape == want.shape
        err = _row_err(got, want, obs.xy if name == "r" else None)
        assert err <= TOL[dtype], (name, err)
        dead = (want.reshape(want.shape[0], -1) == 0).all(1)
        assert not got[dead].any(), name
    assert float(((w - ww).abs() / ww.abs().clamp_min(1e-30)).max()) \
        <= TOL[dtype]
    masked = obs.weight <= 0
    bad = ~torch.isfinite(state.X[obs.point_id]).all(1)
    assert masked.sum() >= 30 and bad.sum() == 2 * state.R.shape[0]
    for t in (r, A, B, Ji):
        assert not t[masked | bad].any()
    assert not w[masked].any() and (w[bad] == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_host_cost_terms_match_plain_cost(host, huber, dtype):
    """The rows' cost terms from the kernel source sum to
    ``compute_cost`` (rows not finite at 1e12, masked rows 0) within the
    summation order's rounding; the terms of the poisoned rows are exact
    (a row not finite: 1e12, or Huber's cost of it)."""
    state, obs, _ = mixed_problem(dtype=dtype)
    terms = host_rows(host, state, obs, huber)[5]
    want = lm.compute_cost(state, obs, lm.BAOptions(huber_delta_px=huber))
    got = terms.double().sum()
    assert float(abs(got - want.double()) / want.double()) <= (
        1e-5 if dtype == torch.float32 else 1e-12)
    assert not terms[obs.weight <= 0].any()
    bad = ~torch.isfinite(state.X[obs.point_id]).all(1)
    big = torch.tensor(1e12, dtype=dtype)
    if huber > 0:
        big = 2.0 * huber * torch.sqrt(big) - huber * huber
    assert (terms[bad] == big).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["padded", "sorted"])
def test_host_point_sums_match_segment_sums(host, form, dtype):
    """A point's Vl and gp summed over its rows in table order, as the
    kernel's point pass does, against ``_normal_blocks``' segment sums on
    both table forms (the plain sorted table sums in the same order)."""
    state, obs, _ = mixed_problem(dtype=dtype)
    opts = lm.BAOptions(huber_delta_px=2.0)
    layout = lm.make_layout(obs, state.R.shape[0], state.X.shape[0],
                            state.intr.shape[0],
                            1e9 if form == "padded" else 0.0)
    r, _, B, _, w = lm._build_blocks(state, obs, opts)
    nb = lm._normal_blocks(state, obs, opts, layout)
    pt = layout.pt
    L = state.X.shape[0]
    if form == "padded":
        idx, mask, lengths, start, cap = (_np(pt.rows), _np(pt.mask), None,
                                          None, pt.rows.shape[1])
    else:
        lengths = _np(pt.lengths)
        idx, mask, cap = _np(pt.order), None, 0
        start = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    out = np.zeros((L, 12), _np(r).dtype)
    host.bal_points(int(dtype == torch.float64), L, _ptr(idx), _ptr(mask),
                    _ptr(lengths), _ptr(start), cap, _ptr(_np(B)),
                    _ptr(_np(w)), _ptr(_np(r)), _ptr(out))
    out = torch.from_numpy(out)
    assert _row_err(out[:, :9], nb.Vl.reshape(L, 9)) <= TOL[dtype]
    assert _row_err(out[:, 9:], nb.gp) <= TOL[dtype]


# ---------------------------------------------------------------------------
# which path a bundle adjustment takes
# ---------------------------------------------------------------------------

@pytest.fixture()
def small():
    return mixed_problem(n_cams=5, n_pts=40, poison=False)


def _card_when_unsharded(monkeypatch):
    """CPU tensors taken for the card's where both hooks are the
    identity."""
    monkeypatch.setattr(lm, "_pcg_on_card", lambda x, c, p: (
        c is lm.identity_reduce and p is lm.identity_reduce))


def test_cpu_tensors_take_the_plain_path(small):
    """On CPU tensors a bundle adjustment launches nothing and counts no
    ``ba_kernel`` or ``cost_kernel``; its trial and cost are the plain
    versions'."""
    state, obs, fixed = small
    opts = lm.BAOptions(max_iterations=3, refine_intrinsics=True,
                        huber_delta_px=2.0)
    before = dict(_build.LAUNCHES)
    with spans.collect() as c, spans.span("triangulation.ba"):
        lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                         device="cpu")
    summary = c.summary()
    assert "ba_kernel" not in summary["triangulation.ba.trial"]
    assert "cost_kernel" not in summary["triangulation.ba.cost"]
    assert _build.LAUNCHES == before
    assert torch.equal(lm._full_cost(state, obs, opts, None),
                       lm.compute_cost(state, obs, opts))


def test_sharded_hooks_take_the_plain_path(small, monkeypatch):
    """A trial and a cost read with non-identity hooks, on tensors taken
    for the card's, never reach the kernels' launches."""
    state, obs, fixed = small
    _card_when_unsharded(monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("a kernel ran under sharded hooks")
    for name in ("linearize", "cost"):
        monkeypatch.setattr(ba_linearize, name, refuse)
    monkeypatch.setattr(schur_pcg, "schur_pcg", refuse)
    summed = lambda tensors, site: tensors
    imask = lm.intr_mask_of(obs, state.intr.shape[0], False)
    opts = lm.BAOptions(huber_delta_px=2.0)
    for hooks in ((summed, lm.identity_reduce), (lm.identity_reduce, summed),
                  (summed, summed)):
        lm.lm_trial(state, 1e-3, obs, opts, fixed, imask, None, None, *hooks)
    assert torch.equal(lm._full_cost(state, obs, opts, None, summed),
                       lm.compute_cost(state, obs, opts))
    with pytest.raises(AssertionError, match="sharded"):
        lm.lm_trial(state, 1e-3, obs, opts, fixed, imask)
    with pytest.raises(AssertionError, match="sharded"):
        lm._full_cost(state, obs, opts, None)


def test_unsharded_card_tensors_take_the_kernels(small, monkeypatch):
    """With the launches replaced by the plain versions: one
    ``ba_kernel`` a trial on ``.trial``, one ``cost_kernel`` a cost read on
    ``.cost`` (the trials and the first read), beside ``pcg_kernel``; the
    result is the plain bundle adjustment's, bit for bit."""
    state, obs, fixed = small
    opts = lm.BAOptions(max_iterations=4, refine_intrinsics=True,
                        huber_delta_px=2.0)
    want, st_want = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                     device="cpu")
    _card_when_unsharded(monkeypatch)
    monkeypatch.setattr(ba_linearize, "linearize", plain_linearize)
    monkeypatch.setattr(ba_linearize, "cost", plain_cost)
    monkeypatch.setattr(schur_pcg, "schur_pcg", plain_launch)
    with spans.collect() as c, spans.span("triangulation.ba"):
        got, st = lm.bundle_adjust(state, obs, opts, fixed_pose_mask=fixed,
                                   device="cpu")
    summary = c.summary()
    assert st == st_want and all(torch.equal(a, b)
                                 for a, b in zip(got, want))
    trial, cost = summary["triangulation.ba.trial"], \
        summary["triangulation.ba.cost"]
    assert trial["ba_kernel"] == trial["pcg_kernel"] == st.iterations
    assert cost["cost_kernel"] == cost["n"] == st.iterations + 1


@pytest.mark.parametrize("which", ["linearize", "cost"])
def test_kernel_failure_is_not_caught(small, monkeypatch, which):
    """A failed launch raises out of the trial or the cost read: no plain
    version instead."""
    state, obs, fixed = small
    monkeypatch.setattr(lm, "_pcg_on_card", lambda x, c, p: True)

    def fail(*a, **k):
        raise RuntimeError("BA linearisation CUDA kernel launch failed")
    monkeypatch.setattr(ba_linearize, which, fail)
    opts = lm.BAOptions()
    with pytest.raises(RuntimeError, match="launch failed"):
        if which == "linearize":
            lm.lm_trial(state, 1e-3, obs, opts, fixed,
                        lm.intr_mask_of(obs, state.intr.shape[0], False))
        else:
            lm._full_cost(state, obs, opts, None)


REFUSALS = ["cpu", "dtype", "mixed_dtype", "index_dtype", "shape", "layout"]


@pytest.mark.parametrize("entry,case", [("linearize", c) for c in REFUSALS]
                         + [("linearize", "table"),
                            ("linearize", "table_width")]
                         + [("cost", c) for c in REFUSALS])
def test_kernels_refuse_what_they_cannot_take(small, entry, case):
    """The launches raise ValueError on CPU tensors, on a state neither
    float32 nor float64 or observations of another dtype, on ids that are
    not int64, on shapes that do not fit together, on non-contiguous
    tensors and (the linearisation) on a table of another segment count or
    a padded table without a width; they launch nothing."""
    state, obs, _ = small
    layout = lm.make_layout(obs, state.R.shape[0], state.X.shape[0],
                            state.intr.shape[0])
    args = [*state, *obs]
    if case == "dtype":
        args[:4] = [a.half() for a in args[:4]]
    elif case == "mixed_dtype":
        args[8] = args[8].double()
    elif case == "index_dtype":
        args[6] = args[6].int()
    elif case == "shape":
        args[9] = args[9][:-1]
    elif case == "layout":
        args[1] = args[1].t().contiguous().t()
    tables = list(layout)
    if case == "table":
        tables[1] = layout.cam          # 5 segments for the 40 points
    elif case == "table_width":
        tables[0] = layout.cam._replace(rows=layout.cam.rows[:, :0],
                                        mask=layout.cam.mask[:, :0])
    if entry == "linearize":
        call = lambda: ba_linearize.linearize(*args, *tables, 2.0)
    else:
        call = lambda: ba_linearize.cost(*args, 2.0)
    want = {"cpu": "CUDA", "dtype": "float32 or float64",
            "mixed_dtype": "want float32", "index_dtype": "int64",
            "shape": "shape", "layout": "contiguous", "table": "segments",
            "table_width": "width"}[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=want):
        call()
    assert _build.LAUNCHES == before
