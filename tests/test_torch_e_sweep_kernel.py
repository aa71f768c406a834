"""The E-sweep kernel (``csrc/essential5.cu``) against its plain version,
both on the card.

These tests need a CUDA device and skip without one. On the card:

    python -m pytest tests/test_torch_e_sweep_kernel.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not use.) The kernel rounds differently from the plain version (fused
multiply-adds, summation order), and the 5-point solve amplifies rounding
in ill-conditioned draws: the plain version given inputs perturbed by one
part in 1e7 (float32) or 1e10 (float64) moves a few percent of its
candidates by more than 1e-3. So candidates are held to shares within a
tolerance, and the sweep's winners to the plain version's or to a score
tied with it.
"""

import numpy as np
import pytest
import torch

from regard3d_tpu_torch.kernels import _build, ransac

pytestmark = pytest.mark.card


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run these tests on the card")
    return torch.device("cuda", 0)


def _rot(a):
    th = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _views(rng, n, noise=0.0):
    """n points seen by two calibrated cameras (normalized coordinates)."""
    X = rng.uniform(-1, 1, (n, 3)) + [0, 0, 4]
    t = rng.normal(size=3)
    Y = X @ _rot(rng.normal(size=3) * 0.1).T + t / np.linalg.norm(t)
    x1 = X[:, :2] / X[:, 2:] + rng.normal(size=(n, 2)) * noise
    x2 = Y[:, :2] / Y[:, 2:] + rng.normal(size=(n, 2)) * noise
    return x1, x2


def _scenes(rng, P, cap, outliers=0.3, noise=0.0):
    """P pairs of ``cap`` slots, 40-100% of them filled, a share of the
    matches replaced by random points; returns numpy x1, x2, mask. With
    noise, every all-inlier draw gives a model about as good as the next:
    their scores differ by less than the rounding of a float32 sum over the
    slots, so any change of rounding picks another of them (at noise 1e-5,
    one pair in ten 1e-3 away in E), and at 3e-4, the 4e-3 threshold's
    scale, the inlier sets move too (see
    ``test_acransac_e_batch_inliers_match_plain``)."""
    x1 = np.zeros((P, cap, 2))
    x2 = np.zeros((P, cap, 2))
    mask = np.zeros((P, cap), bool)
    for p in range(P):
        n = int(cap * rng.uniform(0.4, 1.0)) if P > 1 else cap
        a, b = _views(rng, n, noise=noise)
        k = int(outliers * n)
        b[:k] = rng.uniform(-0.4, 0.4, (k, 2))
        x1[p, :n], x2[p, :n], mask[p, :n] = a, b, True
    return x1, x2, mask


def _draws(mask, iters, seed):
    return torch.stack([ransac._draw_samples(
        torch.Generator().manual_seed(seed + p), torch.as_tensor(mask[p]),
        iters, 5) for p in range(len(mask))])


def _share_found(E_plain, ok_plain, E_kern, ok_kern, tol):
    """Share of the plain version's ok candidates that the kernel's ok
    candidates of the same draw hold within ``tol`` (max abs, up to
    sign)."""
    Ep = E_plain.reshape(-1, 10, 9).double().cpu().numpy()
    Ek = E_kern.reshape(-1, 10, 9).double().cpu().numpy()
    okp, okk = ok_plain.cpu().numpy(), ok_kern.cpu().numpy()
    d = np.minimum(np.abs(Ep[:, :, None] - Ek[:, None]).max(-1),
                   np.abs(Ep[:, :, None] + Ek[:, None]).max(-1))
    d = np.where(okk[:, None, :], d, np.inf).min(-1)
    return float((d[okp] < tol).mean())


@pytest.mark.parametrize("dtype,tol,share,ok_share", [
    (torch.float32, 1e-2, 0.9, 0.95),
    (torch.float64, 1e-6, 0.95, 0.99)])
@pytest.mark.parametrize("kind", ["exact", "random"])
def test_candidates_match_plain(dev, kind, dtype, tol, share, ok_share):
    """The kernel's solver finds the plain version's real candidates, up to
    sign, and agrees on ``ok``: exact-geometry draws and random draws."""
    rng = np.random.default_rng(7)
    S = 4096
    if kind == "exact":
        pts = [_views(rng, 5) for _ in range(S)]
        x1 = np.stack([a for a, _ in pts])
        x2 = np.stack([b for _, b in pts])
    else:
        x1, x2 = rng.normal(size=(2, S, 5, 2)) * 0.5
    t1 = torch.tensor(x1, dtype=dtype, device=dev)
    t2 = torch.tensor(x2, dtype=dtype, device=dev)
    before = _build.LAUNCHES[f"e_solve_{ransac._E_DTYPE[dtype][1]}"]
    Ek, okk = ransac.essential_5pt(t1, t2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"e_solve_{ransac._E_DTYPE[dtype][1]}"] \
        == before + 1
    from regard3d_tpu_torch.kernels import geometry
    Ep, okp = geometry.fit_essential_5pt(t1, t2)
    assert okp.sum() > S                      # several real roots a draw
    assert (okp == okk).float().mean().item() >= ok_share
    assert _share_found(Ep, okp, Ek, okk, tol) >= share


def _score(model, x1, x2, mask, me):
    """The plain version's truncated score of one model per pair."""
    r = ransac._epi_resid(model[:, None], {"x1": x1, "x2": x2})[:, 0]
    r = torch.where(mask, r, ransac._BIG)
    return torch.minimum(r, me[:, None]).sum(-1)


def _sweep_pair(dev, P, cap, iters, dtype, seed, noise=0.0):
    """The kernel's and the plain version's sweeps of the same scenes and
    draws, and the plain version's of the scenes with x1 moved by one part
    in 1e7 (float32 rounding's scale): ((x1, x2, mask, max_err_sq), kernel,
    plain, moved), each (model, ok)."""
    rng = np.random.default_rng(seed)
    x1, x2, mask = _scenes(rng, P, cap, noise=noise)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    x1t, x2t, mt = t(x1), t(x2), torch.tensor(mask, device=dev)
    me = torch.full((P,), (4.0 / 1000.0) ** 2, dtype=dtype, device=dev)
    idx = _draws(mask, iters, seed).to(dev)
    tag = f"e_sweep_{ransac._E_DTYPE[dtype][1]}"
    before = _build.LAUNCHES[tag]
    kern = ransac.e_sweep(x1t, x2t, mt, me, idx)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tag] == before + 1
    plain = ransac.e_sweep_plain(x1t, x2t, mt, me, idx)
    moved = ransac.e_sweep_plain(t(x1 * (1 + 1e-7 * rng.normal(
        size=x1.shape))), x2t, mt, me, idx)
    return (x1t, x2t, mt, me), kern, plain, moved


@pytest.mark.parametrize("iters", [1024, 100])
@pytest.mark.parametrize("cap", [64, 1024, 4096])
@pytest.mark.parametrize("P", [1, 16, 55])
def test_selected_model_matches_plain(dev, P, cap, iters):
    """Per pair the kernel's winner has the plain winner's ok, and its
    score lies as close to the plain winner's as rounding alone puts it.
    The all-inlier draws' models score within float32 rounding of each
    other, even on exact matches (the solve's own error separates them),
    so any change of rounding may pick another of them: on the card the
    kernel's winners lay up to 5.5e-3 from the plain ones in E and 2.6e-3
    in score. The yardstick is the plain version's own winner on inputs
    moved by one part in 1e7."""
    data, (Mk, okk), (Mp, okp), (Mn, okn) = _sweep_pair(
        dev, P, cap, iters, torch.float32, 100 + P + cap)
    assert torch.equal(okk, okp)
    sp = _score(Mp, *data)
    rel = lambda M: ((_score(M, *data) - sp).abs() / sp).max().item()
    assert rel(Mk) <= max(4 * rel(Mn), 1e-3), (rel(Mk), rel(Mn))


def test_float64_sweep_matches_plain(dev):
    """f64 inputs run the kernel in double (the roots in complex float, as
    poly_roots does) and select the plain version's models, on noisy
    matches (on exact ones the good candidates differ by the solve's own
    error and tie within float64 rounding)."""
    data, (Mk, okk), (Mp, okp), _ = _sweep_pair(dev, 16, 512, 256,
                                                torch.float64, 5, noise=3e-4)
    assert Mk.dtype == torch.float64 and torch.equal(okk, okp)
    err = torch.minimum((Mk - Mp).abs().amax((1, 2)),
                        (Mk + Mp).abs().amax((1, 2)))
    assert err.max().item() < 1e-9


def test_ties_go_to_the_earliest_candidate(dev):
    """With every slot masked out every candidate scores cap * max_err_sq:
    the winner is draw 0's slot 0, across threads, warps and blocks; its ok
    is that candidate's."""
    rng = np.random.default_rng(3)
    P, cap, iters = 3, 256, 300
    x1, x2, mask = _scenes(rng, P, cap)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    idx = _draws(mask, iters, 11).to(dev)
    none = torch.zeros((P, cap), dtype=torch.bool, device=dev)
    me = torch.full((P,), 1e-5, device=dev)
    M, ok = ransac.e_sweep(t(x1), t(x2), none, me, idx)
    # draw 0 of each pair, solved alone
    g = lambda a: torch.gather(t(a), 1, idx[:, 0, :, None].expand(P, 5, 2))
    E0, ok0 = ransac.essential_5pt(g(x1), g(x2))
    assert torch.equal(ok, ok0[:, 0])
    assert torch.allclose(M, E0[:, 0], rtol=0, atol=1e-6, equal_nan=True)
    # duplicated draws: the sweep over draws repeated four times selects
    # what the sweep over one copy selects
    Ma, oka = ransac.e_sweep(t(x1), t(x2), torch.tensor(mask, device=dev),
                             me, idx[:, :75].repeat(1, 4, 1))
    Mb, okb = ransac.e_sweep(t(x1), t(x2), torch.tensor(mask, device=dev),
                             me, idx[:, :75].contiguous())
    assert torch.equal(Ma, Mb) and torch.equal(oka, okb)


def test_pair_with_no_ok_candidate_is_not_valid(dev):
    """A pair whose every candidate is not ok (NaN points) comes out not
    ok and not valid in both versions; its neighbours are unaffected."""
    rng = np.random.default_rng(4)
    P, cap, iters = 3, 128, 128
    x1, x2, mask = _scenes(rng, P, cap)
    x1[1] = np.nan
    args = [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (x1, x2)]
    mt = torch.tensor(mask, device=dev)
    la = torch.full((P,), -3.0, device=dev)
    me = torch.full((P,), (4.0 / 1000.0) ** 2, device=dev)
    idx = _draws(mask, iters, 2).to(dev)
    _, ok = ransac.e_sweep(*args, mt, me, idx)
    assert not bool(ok[1]) and bool(ok[0]) and bool(ok[2])
    got = ransac.acransac_e_batch(None, *args, mt, la, me, iters=iters,
                                  idx=idx)
    with torch.no_grad():
        cpu = [a.cpu() for a in args]
        want = ransac.acransac_e_batch(None, *cpu, mt.cpu(), la.cpu(),
                                       me.cpu(), iters=iters, idx=idx.cpu())
    assert got.valid.tolist() == want.valid.tolist()
    assert not bool(got.valid[1])


def test_nan_in_a_live_slot_voids_the_pair(dev):
    """A NaN point in a live slot makes every ok candidate's score NaN: the
    plain loop rejects each such chunk, and so does the kernel each block,
    so the pair keeps a zero model, not ok; a NaN in a masked slot changes
    nothing (a ragged last block of 36 draws)."""
    rng = np.random.default_rng(8)
    P, cap, iters = 3, 128, 100
    x1, x2, mask = _scenes(rng, P, cap)
    mask[2, -1] = False
    x1[0, 7, 1] = np.nan
    x2[2, -1, 0] = np.nan
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    mt = torch.tensor(mask, device=dev)
    me = torch.full((P,), (4.0 / 1000.0) ** 2, device=dev)
    idx = _draws(mask, iters, 6).to(dev)
    Mk, okk = ransac.e_sweep(t(x1), t(x2), mt, me, idx)
    Mp, okp = ransac.e_sweep_plain(t(x1), t(x2), mt, me, idx)
    assert okk.tolist() == okp.tolist() == [False, True, True]
    assert (Mk[0] == 0).all() and (Mp[0] == 0).all()
    err = torch.minimum((Mk - Mp).abs().amax((1, 2)),
                        (Mk + Mp).abs().amax((1, 2)))
    assert err[1:].max().item() < 1e-2, err


def _set_distance(a, b):
    """1 - |a & b| / |a | b| per pair of (P, N) inlier masks."""
    union = (a | b).sum(-1).clamp_min(1)
    return 1.0 - (a & b).sum(-1) / union


def test_acransac_e_batch_inliers_match_plain(dev):
    """End to end on 128 pairs: the filter's inlier sets with the kernel
    equal the plain sweep's up to the points that rounding moves across
    the threshold. On 99% of pairs they are within a set distance of 0.05,
    and they are exactly equal on as many pairs as the plain version keeps
    against itself when its inputs move by one part in 1e7 (less 5 points:
    that yardstick reads 92-96% on these scenes, so exact equality on 99%
    of pairs is more than float32 rounding allows any implementation)."""
    rng = np.random.default_rng(9)
    P, cap, iters = 128, 512, 1024
    x1, x2, mask = _scenes(rng, P, cap, noise=3e-4)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    mt = torch.tensor(mask, device=dev)
    la = torch.full((P,), -3.0, device=dev)
    me = torch.full((P,), (4.0 / 1000.0) ** 2, device=dev)
    idx = _draws(mask, iters, 21).to(dev)
    run = lambda a: ransac.acransac_e_batch(None, t(a), t(x2), mt, la, me,
                                            iters=iters, idx=idx)
    before = _build.LAUNCHES["e_sweep_f32"]
    got = run(x1)
    assert _build.LAUNCHES["e_sweep_f32"] == before + 1
    plain = ransac.e_sweep
    try:
        ransac.e_sweep = ransac.e_sweep_plain
        want = run(x1)
        moved = run(x1 * (1 + 1e-7 * rng.normal(size=x1.shape)))
    finally:
        ransac.e_sweep = plain
    equal = lambda r: ((r.inliers == want.inliers).all(-1)
                       & (r.valid == want.valid)).float().mean().item()
    assert got.valid.float().mean().item() > 0.9
    assert (_set_distance(got.inliers, want.inliers) <= 0.05).float().mean() \
        .item() >= 0.99
    assert equal(got) >= equal(moved) - 0.05, (equal(got), equal(moved))
