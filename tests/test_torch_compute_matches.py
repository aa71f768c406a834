"""Port parity: AC-RANSAC (``kernels/ransac.py``) and the compute-matches stage
(``pipeline/compute_matches.py``) of ``regard3d_tpu_torch`` against the JAX
package, on the CPU.

Random draws: ``jax.random`` and ``torch.Generator`` cannot give the same
bits, so the port is handed the reference's own draws (its
``_draw_samples`` under the per-pair keys of its ``geometric_filter``).

Both halves share the reference's compiled filter programs: a block of 128
pairs at a match capacity of 128, sharded over the test session's eight
virtual CPU devices exactly as the reference's ``geometric_filter`` shards
it, 64 iterations. The stage scene is sized so that every putative pair
falls into that one capacity bucket.

What "the same result" means for AC-RANSAC (``classify``): the same draws
give the same winning model unless two draws score within f32 noise of
each other, and the a-contrario threshold is the argmin of log-NFA over the
sorted residuals, where a flat curve lets two f32 implementations stop one
rank apart. So a pair's inliers are identical ("same"), or differ only in
a few matches that lie within a factor of ``BORDER`` of the reference's
threshold ("borderline"), or, for a minority of pairs of the synthetic
blocks, come from another winner ("other"). On the stage's own pairs every
F and H difference must be borderline; the E pairs that differ are named
in ``E_NAMED`` with their cause.
"""

import os
import shutil
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from regard3d_tpu.dist import mesh as jmesh
from regard3d_tpu.kernels import geometry as jg
from regard3d_tpu.kernels import match as jm
from regard3d_tpu.kernels import ransac as jr
from regard3d_tpu.pipeline import compute_matches as jcm
from regard3d_tpu.pipeline import features as jfeat
from regard3d_tpu_torch.ingest import synth as tsynth
from regard3d_tpu_torch.kernels import geometry as tg
from regard3d_tpu_torch.kernels import ransac as tr
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import features as tfeat

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))

BLOCK, CAP, ITERS = 128, 128, 64
SAMPLE = {"f": 8, "e": 5, "h": 4}
SALT = {"f": 0, "e": 1, "h": 2}
BORDER = 4.0            # a borderline match lies within this factor of thr

# the stage scene: 4 fountain views at 256 px; 352 keypoints put every
# putative pair between 65 and 128 matches (one capacity bucket)
N_VIEWS, HW, MAX_KP = 4, 256, 352


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def pair_key(seed, i, j, kind):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(i))
    k = jax.random.fold_in(k, np.uint32(j))
    return jax.random.fold_in(k, SALT[kind])


def reference_draws(key, mask, kind):
    return np.asarray(jr._draw_samples(key, jnp.asarray(mask), ITERS,
                                       SAMPLE[kind]))


def reference_provider(seed=0):
    """A ``sample_provider`` for the port that returns the reference's own
    draws for pair (i, j) of filter ``kind``."""
    def provider(kind, i, j, mask, iters, s):
        assert iters == ITERS and s == SAMPLE[kind]
        return reference_draws(pair_key(seed, i, j, kind), mask, kind)
    return provider


_BATCH = {"f": (jr.acransac_f_batch, tr.acransac_f_batch),
          "e": (jr.acransac_e_batch, tr.acransac_e_batch),
          "h": (jr.acransac_h_batch, tr.acransac_h_batch)}


def run_both(kind, keys, x1, x2, mask, la, me):
    """One filter over a (BLOCK, CAP) pair block in both packages: the
    reference sharded over the local devices like its geometric_filter, the
    port with the reference's draws injected. Returns (ref, port) results
    as numpy dicts."""
    shard = NamedSharding(jmesh.make_mesh("pairs",
                                          devices=jax.local_devices()),
                          PartitionSpec("pairs"))
    put = lambda a: jax.device_put(jnp.asarray(a), shard)
    ref_fn, port_fn = _BATCH[kind]
    rj = ref_fn(put(keys), put(x1), put(x2), put(mask), put(la), put(me),
                iters=ITERS)
    idx = np.stack([reference_draws(keys[p], mask[p], kind)
                    for p in range(len(keys))])
    t = torch.as_tensor
    rt = port_fn(None, t(x1), t(x2), t(mask), t(la), t(me), iters=ITERS,
                 idx=t(idx))
    as_np = lambda r: {k: np.asarray(v) if not torch.is_tensor(v)
                       else v.numpy() for k, v in r._asdict().items()}
    return as_np(rj), as_np(rt)


def residuals(kind, model, x1, x2):
    """Squared residual of every correspondence under one model."""
    M = torch.from_numpy(np.array(model, np.float32))[None]
    a = torch.as_tensor(x1)[None]
    b = torch.as_tensor(x2)[None]
    fn = tg.sym_transfer_h if kind == "h" else tg.epipolar_dist_f
    return fn(M, a, b)[0].numpy()


def aligned(Mj, Mt):
    """Both models scaled to unit norm, the port's turned to the
    reference's sign."""
    a = np.asarray(Mj, np.float64) / np.linalg.norm(Mj)
    b = np.asarray(Mt, np.float64) / np.linalg.norm(Mt)
    return a, b * (1.0 if np.sum(a * b) >= 0 else -1.0)


def classify(kind, rj, rt, p, x1, x2):
    """Compare pair p's results. Both packages must agree on validity and
    roughly on the inlier count. Returns ("invalid", None), ("same", None)
    when inliers are identical and log-NFA agrees, ("borderline", matches)
    when the inlier sets differ in a few matches that each lie near the
    reference's threshold, else ("other", None): a different winning draw,
    which f32 rounding picked (see the E solver test). (Models are not
    compared here: on a nearly planar scene the inliers determine F only up
    to a one-parameter family.)"""
    assert bool(rj["valid"][p]) == bool(rt["valid"][p]), (kind, p)
    if not rj["valid"][p]:
        return "invalid", None
    ij, it = rj["inliers"][p], rt["inliers"][p]
    n_in = int(ij.sum())
    assert abs(int(it.sum()) - n_in) <= max(3, 0.2 * n_in), (kind, p)
    nfa_j, nfa_t = float(rj["log_nfa"][p]), float(rt["log_nfa"][p])
    diff = np.where(ij != it)[0]
    if len(diff) == 0 and abs(nfa_t - nfa_j) <= 0.03 * abs(nfa_j) + 0.05:
        return "same", None
    thr = float(rj["threshold_sq"][p])
    r = residuals(kind, rj["model"][p], x1[p], x2[p])[diff]
    if (0 < len(diff) <= max(4, 0.05 * n_in)
            and abs(nfa_t - nfa_j) <= 0.1 * abs(nfa_j) + 1.0
            and np.all((r >= thr / BORDER) & (r <= thr * BORDER))):
        return "borderline", [(int(d), float(x / thr)) for d, x in
                              zip(diff, r)]
    return "other", None


def rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def synthetic_block(rng, planar=False, f=300.0, size=256.0):
    """BLOCK pairs of noisy correspondences with outliers, each padded to
    CAP: (x1, x2, x1n, x2n, mask) in pixels and normalized coordinates."""
    c = size / 2.0
    x1 = np.zeros((BLOCK, CAP, 2), np.float32)
    x2 = np.zeros((BLOCK, CAP, 2), np.float32)
    mask = np.zeros((BLOCK, CAP), bool)
    for p in range(BLOCK):
        n = int(rng.integers(72, CAP + 1))
        R = rodrigues(rng.normal(size=3) * 0.1)
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        if planar:
            X = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                                np.full((n, 1), 7.0)], 1)
        else:
            X = rng.normal(size=(n, 3)) * [2.5, 2.0, 1.5] + [0, 0, 7]
        Xc = X @ R.T + t
        a = X[:, :2] / X[:, 2:] * f + c + rng.normal(size=(n, 2)) * 0.5
        b = Xc[:, :2] / Xc[:, 2:] * f + c + rng.normal(size=(n, 2)) * 0.5
        out = rng.uniform(size=n) < rng.uniform(0.1, 0.4)
        b[out] = rng.uniform(0, size, size=(int(out.sum()), 2))
        x1[p, :n], x2[p, :n], mask[p, :n] = a, b, True
    x1n = np.where(mask[..., None], (x1 - c) / f, 0).astype(np.float32)
    x2n = np.where(mask[..., None], (x2 - c) / f, 0).astype(np.float32)
    return x1, x2, x1n, x2n, mask


# ---------------------------------------------------------------------------
# (c) AC-RANSAC F / E / H with the reference's draws injected
# ---------------------------------------------------------------------------

# share of valid pairs that must come out "same" or "borderline"; the rest
# picked another of two draws whose scores tie within f32 noise. The 5-point
# E solver is the loosest: in f32 it solves only about 60% of minimal
# problems precisely (tests/test_minimal_solvers.py), so near-ties between
# its candidates are common.
AGREE = {"f": 0.95, "e": 0.7, "h": 0.95}


@pytest.mark.parametrize("kind", ["f", "e", "h"])
def test_acransac_batch_matches_reference(rng, kind):
    f, size = 300.0, 256.0
    x1, x2, x1n, x2n, mask = synthetic_block(rng, planar=kind == "h", f=f,
                                             size=size)
    keys = np.stack([np.asarray(pair_key(7, p, p + 1, kind))
                     for p in range(BLOCK)])
    if kind == "e":
        a, b = x1n, x2n
        la = np.full(BLOCK, tr._logalpha0_e(size, size, f), np.float32)
        me = np.full(BLOCK, (4.0 / f) ** 2, np.float32)
    else:
        a, b = x1, x2
        la = np.full(BLOCK, tr._logalpha0_line(size, size) if kind == "f"
                     else tr._logalpha0_point(size, size), np.float32)
        me = np.full(BLOCK, 16.0, np.float32)
    rj, rt = run_both(kind, keys, a, b, mask, la, me)
    n_valid = int(rj["valid"].sum())
    assert n_valid >= 0.9 * BLOCK, n_valid
    verdicts = [classify(kind, rj, rt, p, a, b)[0] for p in range(BLOCK)]
    same = verdicts.count("same")
    agree = same + verdicts.count("borderline")
    assert same >= 0.7 * n_valid and agree >= AGREE[kind] * n_valid, (
        kind, {v: verdicts.count(v) for v in set(verdicts)})
    # general 3D scenes determine the model: where the inliers are the
    # same, so is the model up to sign and scale. Where the refit does not
    # lower the NFA each package keeps its winning minimal-sample model,
    # and an f32 5-point solution is good to about 1e-2
    # (tests/test_minimal_solvers.py gates its recovery there)
    tol = 2e-2 if kind == "e" else 1e-2
    for p in np.where(np.asarray(verdicts) == "same")[0]:
        Mj, Mt = aligned(rj["model"][p], rt["model"][p])
        np.testing.assert_allclose(Mt, Mj, atol=tol)


def test_port_draws_are_distinct_valid_and_seeded_per_pair():
    """Without injected draws the port samples with one generator per pair,
    seeded from (seed, i, j, filter): distinct indices of valid entries,
    the same draws for the same pair, other draws for another pair."""
    mask = torch.zeros(40, dtype=torch.bool)
    mask[[1, 3, 4, 8, 9, 10, 15, 20, 21, 30, 33, 39]] = True
    for s in (4, 5, 8):
        idx = tr._draw_samples(tcm.pair_generator(0, 1, 2, "f"), mask, 256, s)
        assert idx.shape == (256, s) and bool(mask[idx].all())
        assert bool((torch.sort(idx, -1).values.diff(dim=-1) > 0).all())
        assert set(idx.flatten().tolist()) == set(
            torch.where(mask)[0].tolist())
        again = tr._draw_samples(tcm.pair_generator(0, 1, 2, "f"), mask, 256,
                                 s)
        assert torch.equal(idx, again)
    for other in (tcm.pair_generator(0, 1, 3, "f"),
                  tcm.pair_generator(0, 1, 2, "h"),
                  tcm.pair_generator(1, 1, 2, "f")):
        assert not torch.equal(tr._draw_samples(other, mask, 256, 8), idx)


def test_filter_result_independent_of_block(rng):
    """A pair filtered alone and filtered in a block with another pair gives
    the same F, E and H matches (its draws depend on the pair only)."""
    x1, x2, _, _, mask = synthetic_block(rng)
    n = [int(mask[p].sum()) for p in range(2)]
    xy = np.zeros((4, CAP, 2), np.float32)
    xy[0], xy[1], xy[2], xy[3] = x1[0], x2[0], x1[1], x2[1]
    kps = types.SimpleNamespace(xy=torch.as_tensor(xy))
    put = {(0, 1): np.stack([np.arange(n[0])] * 2, -1),
           (2, 3): np.stack([np.arange(n[1])] * 2, -1)}
    args = (np.full((4, 2), 256), np.full(4, 300.0),
            tcm.MatchConfig(ransac_iters=ITERS))
    both = tcm.geometric_filter(kps, put, *args, device="cpu")
    alone = tcm.geometric_filter(kps, {(0, 1): put[(0, 1)]}, *args,
                                 device="cpu")
    for kind in ("f", "e", "h"):
        got, want = getattr(alone, kind), getattr(both, kind)
        assert (0, 1) in want
        np.testing.assert_array_equal(got[(0, 1)], want[(0, 1)])


# ---------------------------------------------------------------------------
# (e) the stage as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Both packages' run_compute_matches on the same synthetic views, plus
    the port's matching and filter on the reference's own feature files
    with the reference's draws."""
    base = tmp_path_factory.mktemp("stage")
    ds = tsynth.make_dataset("fountain", n_cams=11, hw=HW, seed=0)
    images = ds["images"][:N_VIEWS]
    focals = np.full(N_VIEWS, ds["f"] * 1.03)
    names = [f"view{i}.png" for i in range(N_VIEWS)]
    kw = dict(threshold=0.0007, focals=focals, max_keypoints=MAX_KP,
              image_names=names)
    ref, port, shared = (str(base / d) for d in ("ref", "port", "shared"))
    jcm.run_compute_matches(images, ref,
                            cfg=jcm.MatchConfig(ransac_iters=ITERS), **kw)
    tcm.run_compute_matches(images, port,
                            cfg=tcm.MatchConfig(ransac_iters=ITERS),
                            device="cpu", **kw)
    os.makedirs(shared)
    for i in range(N_VIEWS):
        for path in (jfeat.feat_path(ref, i), jfeat.desc_path(ref, i)):
            shutil.copy(path, shared)
    stats = tcm.run_compute_matches(images, shared,
                                    cfg=tcm.MatchConfig(ransac_iters=ITERS),
                                    device="cpu",
                                    sample_provider=reference_provider(0),
                                    **kw)
    return dict(ref=ref, port=port, shared=shared, images=images,
                focals=focals, stats=stats)


def test_stage_features_match_reference(stage):
    """Part 1: each package detects and describes on its own. Keypoint
    counts within 1%; >= 99% of the reference's keypoints have a port
    keypoint within 0.01 px; the descriptors of matched keypoints agree
    within 1e-4 (L2) on >= 99% of them. LIOP bins pixels by intensity
    order, so a keypoint that moved by float rounding (the two packages sum
    their convolutions in different orders) can swap two near-equal pixels
    and move a few histogram entries: the rest must stay close (cosine >
    0.9995; measured: 5 of 656 beyond 1e-4, cosine >= 0.99996). The
    stage's sfm_data.json and lists.txt are byte-identical."""
    ref, port = stage["ref"], stage["port"]
    n_kp = n_close = n_desc = n_desc_ok = 0
    for i in range(N_VIEWS):
        xy_r, sc_r, an_r, d_r = jfeat.load_features(ref, i)
        xy_p, sc_p, an_p, d_p = tfeat.load_features(port, i)
        assert abs(len(xy_p) - len(xy_r)) <= 0.01 * len(xy_r), (i, len(xy_p),
                                                                len(xy_r))
        dist = np.linalg.norm(xy_r[:, None] - xy_p[None], axis=-1)
        j = np.argmin(dist, 1)
        close = dist[np.arange(len(xy_r)), j] <= 0.01
        n_kp += len(xy_r)
        n_close += int(close.sum())
        np.testing.assert_allclose(sc_p[j[close]], sc_r[close], rtol=1e-5)
        dd = np.linalg.norm(d_r[close] - d_p[j[close]], axis=1)
        cos = np.sum(d_r[close] * d_p[j[close]], 1)
        n_desc += int(close.sum())
        n_desc_ok += int((dd <= 1e-4).sum())
        assert cos.min() > 0.9995, cos.min()
    assert n_close >= 0.99 * n_kp, (n_close, n_kp)
    assert n_desc_ok >= 0.99 * n_desc, (n_desc_ok, n_desc)
    for name in ("sfm_data.json", "lists.txt"):
        with open(os.path.join(ref, name), "rb") as a, \
                open(os.path.join(port, name), "rb") as b:
            assert a.read() == b.read(), name


def _reference_block(stage, kind):
    """The reference's filter block for the shared features, rebuilt as its
    geometric_filter builds it (one bucket: all pairs at capacity CAP)."""
    ref = stage["ref"]
    put = jcm.load_matches_txt(os.path.join(ref, "matches.putative.txt"))
    kps, _ = jfeat.load_all_padded(ref, N_VIEWS, pad_to=256)
    xy = np.asarray(kps.xy)
    sizes = np.asarray([[im.shape[1], im.shape[0]] for im in stage["images"]])
    f = stage["focals"]
    items = sorted((pr, m) for pr, m in put.items() if len(m) >= 16)
    assert all(64 < len(m) <= CAP for _, m in items), [len(m) for _, m in
                                                      items]
    x1 = np.zeros((BLOCK, CAP, 2), np.float32)
    x2 = np.zeros((BLOCK, CAP, 2), np.float32)
    mask = np.zeros((BLOCK, CAP), bool)
    la = np.zeros(BLOCK, np.float32)
    me = np.full(BLOCK, 16.0, np.float32)
    keys = np.zeros((BLOCK, 2), np.uint32)
    keys[:] = np.asarray(pair_key(0, 0, 0, kind))
    for bi, ((i, j), m) in enumerate(items):
        n = len(m)
        p1, p2 = xy[i][m[:, 0]], xy[j][m[:, 1]]
        w, h = (float(max(sizes[i][k], sizes[j][k])) for k in (0, 1))
        if kind == "e":
            p1 = (p1 - sizes[i] / 2.0) / f[i]
            p2 = (p2 - sizes[j] / 2.0) / f[j]
            fm = float(np.sqrt(f[i] * f[j]))
            la[bi] = np.log10(2.0 * np.sqrt(w * w + h * h) / (w * h) * fm)
            me[bi] = (4.0 / fm) ** 2
        else:
            la[bi] = (jr._logalpha0_line(w, h) if kind == "f"
                      else jr._logalpha0_point(w, h))
        x1[bi, :n], x2[bi, :n], mask[bi, :n] = p1, p2, True
        keys[bi] = np.asarray(pair_key(0, i, j, kind))
    return items, keys, x1, x2, mask, la, me


def _roots_f64(coeffs, iters=0):
    """Every root of each polynomial (ascending coefficients) in complex128,
    from numpy's companion-matrix eigenvalues; absent roots sit far off the
    real axis."""
    c = coeffs.detach().to(torch.complex128).numpy()
    out = np.full((c.shape[0], c.shape[1] - 1), 1e6 + 1e6j)
    for s in range(c.shape[0]):
        r = np.roots(c[s, ::-1])
        out[s, :len(r)] = r
    return torch.from_numpy(out)


def essential_5pt_f64(a, b):
    """The yardstick for both packages' f32 5-point solvers: the port's
    Nistér construction in float64, with an exact nullspace (eigh) and
    exact polynomial roots in place of inverse iteration and
    Durand–Kerner."""
    with mock.patch.object(tg, "poly_roots", _roots_f64), \
            mock.patch.object(tg, "_nullspace4",
                              lambda AtA, iters=0: torch.linalg.eigh(AtA)[1]
                              [..., :4]):
        E, ok = tg.fit_essential_5pt(torch.from_numpy(a).double(),
                                     torch.from_numpy(b).double())
    return E.numpy(), ok.numpy()


def best_candidate(E, ok, a, b, max_err_sq):
    """Per draw, the lowest truncated score (float64, over the valid matches
    a, b) among its candidates E (D, 10, 3, 3), and that candidate's slot."""
    D = E.shape[0]
    r = tg.epipolar_dist_f(torch.from_numpy(np.asarray(E, np.float64))
                           .reshape(-1, 3, 3),
                           torch.from_numpy(a).double()[None],
                           torch.from_numpy(b).double()[None]).numpy()
    s = np.minimum(r, max_err_sq).sum(-1).reshape(D, 10)
    s = np.where(ok, s, np.inf)
    return s.min(1), s.argmin(1)


@pytest.fixture(scope="module")
def e_solvers(stage):
    """The 5-point solvers on every draw of the stage's E block (the
    reference's 64 draws for each pair). For each draw, the best score
    among the candidates of: the reference's f32 solver compiled with
    ``jax.jit`` ("ref") and run op by op ("ref_eager"), the port's
    ("port"), and the float64 yardstick ("f64"); and whether the
    yardstick's best candidate is a true essential matrix ("exact": two
    equal singular values and one zero, to 1e-6). Each is a (pairs, 64)
    array; "pairs" lists the pairs."""
    items, keys, x1, x2, mask, _, me = _reference_block(stage, "e")
    idx = [reference_draws(keys[p], mask[p], "e") for p in range(len(items))]
    A = np.concatenate([x1[p][idx[p]] for p in range(len(items))])
    B = np.concatenate([x2[p][idx[p]] for p in range(len(items))])
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    cands = {
        "ref": jax.jit(jg.fit_essential_5pt)(ja, jb),
        "ref_eager": jg.fit_essential_5pt(ja, jb),
        "port": tg.fit_essential_5pt(torch.from_numpy(A),
                                     torch.from_numpy(B)),
        "f64": essential_5pt_f64(A, B)}
    out = {k: [] for k in (*cands, "exact")}
    for p in range(len(items)):
        sl = slice(p * ITERS, (p + 1) * ITERS)
        args = (x1[p][mask[p]], x2[p][mask[p]], float(me[p]))
        slot = {}
        for k, (E, ok) in cands.items():
            s, slot[k] = best_candidate(np.asarray(E)[sl],
                                        np.asarray(ok)[sl], *args)
            out[k].append(s)
        E6 = cands["f64"][0][sl][np.arange(ITERS), slot["f64"]]
        sv = np.linalg.svd(E6, compute_uv=False)
        out["exact"].append((sv[:, 0] - sv[:, 1] <= 1e-6 * sv[:, 0])
                            & (sv[:, 2] <= 1e-6 * sv[:, 0]))
    out = {k: np.stack(v) for k, v in out.items()}
    out["pairs"] = [pr for pr, _m in items]
    return out


def _near(s, s64, tol):
    """Scores within ``tol`` of ``s64`` (two draws without a candidate are
    alike)."""
    both = np.isfinite(s) & np.isfinite(s64)
    with np.errstate(invalid="ignore"):
        return ((both & (np.abs(s - s64) <= tol * s64))
                | (np.isinf(s) & np.isinf(s64)))


def test_stage_e_solver_as_accurate_as_reference(e_solvers):
    """Why the E files may differ. In f32 the 5-point solver of either
    package returns the float64 solution (best candidate's score within
    1e-3) on only a minority of the stage's draws; on the rest, rounding
    decides which perturbed candidates a draw yields, and so which draw
    wins. The reference's own solver, compiled by XLA or run op by op,
    disagrees with itself on most draws. The port must be as accurate as
    the reference (as many draws near the yardstick, less 10%), and differ
    from the reference on no more draws than the reference differs from
    itself, plus 15%: a fault in its Nistér construction would fail both.
    The yardstick's best candidate is a true essential matrix on >= 95% of
    draws. Measured on 384 draws: yardstick exact on 376; near it at 1e-3
    / 1e-2, reference 54 / 91, port 56 / 90; reference against itself
    208 / 145 draws apart, port against reference 224 / 150."""
    s, exact = e_solvers, e_solvers["exact"]
    assert exact.mean() >= 0.95, exact.mean()
    for tol in (1e-3, 1e-2):
        n_ref, n_port = (int((exact & _near(s[k], s["f64"], tol)).sum())
                         for k in ("ref", "port"))
        assert n_ref >= 0.1 * exact.size, (tol, n_ref)
        assert n_port >= 0.9 * n_ref, (tol, n_ref, n_port)
        self_apart = int((~_near(s["ref_eager"], s["ref"], tol)).sum())
        port_apart = int((~_near(s["port"], s["ref"], tol)).sum())
        assert port_apart <= 1.15 * self_apart, (tol, self_apart,
                                                 port_apart)


# E pairs of the stage whose matches.e.txt entries differ: the rounding of
# the f32 5-point solver picks another winning draw (test above). Readings,
# reference / port: inliers 111/111, 89/90, 114/118 (Jaccard 0.947, 0.925,
# 0.950); log-NFA -247.81/-246.77, -165.75/-178.65, -244.14/-253.51.
# Winning draws (lowest best score) of the reference jitted / op by op /
# port / float64 yardstick: (0, 1) 4/4/39/39, (1, 3) 26/57/56/17,
# (2, 3) 46/42/13/55.
E_NAMED = {(0, 1), (1, 3), (2, 3)}


def test_stage_matching_and_filter_on_reference_features(stage, e_solvers):
    """Part 2: the port matches and filters the feature directory the
    reference wrote, with the reference's draws. matches.putative.txt is
    byte-identical. matches.f.txt and matches.h.txt are identical or differ
    only in borderline matches, which the test names (and checks) per pair.
    matches.e.txt differs at most in the pairs of ``E_NAMED``. Each of them
    must show its cause, a winning draw that rounding moves: the
    reference's own solver wins with another draw when XLA compiles it than
    when it runs op by op, or the port wins with the float64 yardstick's
    draw. And each must come out no worse than the reference's: the same
    validity, inlier Jaccard >= 0.9 and log-NFA at most 1% above the
    reference's (the worst reading is 0.42% above; the port's is lower on
    the other two by 3.8% and 7.8%)."""
    ref, shared = stage["ref"], stage["shared"]
    with open(os.path.join(ref, "matches.putative.txt")) as a, \
            open(os.path.join(shared, "matches.putative.txt")) as b:
        assert a.read() == b.read()
    named = {}
    for kind in ("f", "e", "h"):
        want = jcm.load_matches_txt(os.path.join(ref, f"matches.{kind}.txt"))
        got = tcm.load_matches_txt(os.path.join(shared,
                                                f"matches.{kind}.txt"))
        differ = sorted(pr for pr in set(want) | set(got)
                        if pr not in want or pr not in got
                        or not np.array_equal(want[pr], got[pr]))
        if not differ:
            continue
        items, keys, x1, x2, mask, la, me = _reference_block(stage, kind)
        rj, rt = run_both(kind, keys, x1, x2, mask, la, me)
        for bi, (pr, m) in enumerate(items):
            # the rebuilt block reproduces both packages' files (E pairs
            # may also have been dropped by the overlap prune)
            for r, files in ((rj, want), (rt, got)):
                kept = m[r["inliers"][bi][:len(m)]]
                if kind != "e":
                    assert (pr in files) == bool(r["valid"][bi]), (kind, pr)
                if pr in files:
                    np.testing.assert_array_equal(kept, files[pr])
            if pr not in differ:
                continue
            verdict, named[(kind, pr)] = classify(kind, rj, rt, bi, x1, x2)
            if kind != "e":
                assert verdict == "borderline", (kind, pr, verdict)
                continue
            assert pr in E_NAMED, (pr, verdict)
            win = {k: int(np.argmin(e_solvers[k][e_solvers["pairs"]
                                                 .index(pr)]))
                   for k in ("ref", "ref_eager", "port", "f64")}
            assert (win["ref"] != win["ref_eager"]
                    or win["port"] == win["f64"]), (pr, win)
            ij, it = rj["inliers"][bi], rt["inliers"][bi]
            assert (ij & it).sum() >= 0.9 * (ij | it).sum(), (kind, pr)
            nfa_j, nfa_t = rj["log_nfa"][bi], rt["log_nfa"][bi]
            assert nfa_t <= nfa_j + 0.01 * abs(nfa_j), (kind, pr)
    assert sum(k != "e" for k, _ in named) <= 2, named
    stats = stage["stats"]
    assert stats["pairs_putative"] == N_VIEWS * (N_VIEWS - 1) // 2


def kernel_route_matches(descs, cfg):
    """The reference's putative matches on its Pallas kernel route (the
    route ``match_all_pairs`` takes on its chip), block by block in
    interpret mode: blocks of 64 pairs padded with the last pair,
    ``match_pair_block(..., use_pallas=True, tile_m, tile_n, bf16)``."""
    assert not cfg.mutual
    B, N, _ = descs.data.shape
    pairs = jcm.exhaustive_pairs(B)
    tile_m, tile_n = jm._auto_tiles(N, N)
    bf16 = jcm.matcher_knobs(cfg.matcher)["bf16"]
    padded = pairs + [pairs[-1]] * ((-len(pairs)) % 64)
    out = {}
    for start in range(0, len(padded), 64):
        chunk = padded[start:start + 64]
        idx, _, ok = jm.match_pair_block(
            descs.data, descs.mask, jnp.asarray(np.asarray(chunk, np.int32)),
            cfg.ratio, True, tile_m, tile_n, bf16=bf16)
        idx, ok = np.asarray(idx), np.asarray(ok)
        for bi, pr in enumerate(chunk[:len(pairs) - start]):
            ia = np.where(ok[bi])[0]
            out[pr] = np.stack([ia, idx[bi][ia]], -1).astype(np.int64)
    return out


@pytest.mark.parametrize("matcher,mutual", [("brute-force", True),
                                            ("hnsw-fast", False)])
def test_matcher_presets_on_reference_features(stage, matcher, mutual):
    """The mutual check and a bf16 (ANN) preset on the reference's feature
    files: the port's putative matches equal the reference's (for the bf16
    preset, those of its kernel route)."""
    ref = stage["ref"]
    kj, dj = jfeat.load_all_padded(ref, N_VIEWS, pad_to=256)
    kt, dt = tfeat.load_all_padded(ref, N_VIEWS, pad_to=256,
                                   padded_dim=tcm.MATCH_DIM, device="cpu")
    jcfg = jcm.MatchConfig(matcher=matcher, mutual=mutual)
    if jcm.matcher_knobs(matcher)["bf16"]:
        want = kernel_route_matches(dj, jcfg)
    else:
        want = jcm.match_all_pairs(kj, dj, jcfg)
    got = tcm.match_all_pairs(kt, dt, tcm.MatchConfig(matcher=matcher,
                                                      mutual=mutual))
    assert got.keys() == want.keys()
    for pr in want:
        np.testing.assert_array_equal(got[pr], want[pr])


def test_artifacts_readable_both_ways(stage):
    """The port's .feat/.desc/matches files read back through the
    reference's readers, and the reference's through the port's."""
    port, ref = stage["port"], stage["ref"]
    for src in (port, ref):
        for i in range(N_VIEWS):
            a = jfeat.load_features(src, i)
            b = tfeat.load_features(src, i)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert jfeat.load_counts(src, N_VIEWS) == tfeat.load_counts(src,
                                                                    N_VIEWS)
        for kind in ("putative", "f", "e", "h"):
            path = os.path.join(src, f"matches.{kind}.txt")
            a, b = jcm.load_matches_txt(path), tcm.load_matches_txt(path)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    kj, dj = jfeat.load_all_padded(port, N_VIEWS, pad_to=256)
    kt, dt = tfeat.load_all_padded(port, N_VIEWS, pad_to=256, device="cpu")
    np.testing.assert_array_equal(np.asarray(kj.xy), kt.xy.numpy())
    np.testing.assert_array_equal(np.asarray(dj.data), dt.data.numpy())
    np.testing.assert_array_equal(np.asarray(dj.mask), dt.mask.numpy())
    assert jcm.best_validated_pairs(port) == tcm.best_validated_pairs(port)
