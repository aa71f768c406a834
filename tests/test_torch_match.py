"""Port parity: ``regard3d_tpu_torch.kernels.match`` against the JAX matcher.

The same numpy descriptors (made from a seed) go through the JAX package
(its plain ``match_pair_ref`` / ``match_pair_block`` path and its Pallas
kernels in interpret mode, as ``tests/test_match.py`` runs them on the CPU)
and through the port's plain PyTorch version, which is what the port's
wrappers run for CPU tensors. The CUDA kernel itself is held against the
same plain version on the card by ``chip_smoke.py``.

Descriptors are unit-norm rows, as LIOP's are. Tolerances: the nearest
index and the ratio-test verdict must be identical; d1/d2 agree within 1e-4
relative, with an absolute floor of 1e-5 (both sides form |a|^2 + |b|^2 -
2 a.b from 256-term f32 dot products in different orders, and that
cancellation leaves a few ulps of the norms, ~2e-7 each, in small
distances).
"""

import functools
import importlib.util
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.kernels import match as jm
from regard3d_tpu_torch.kernels import _build
from regard3d_tpu_torch.kernels import match as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# several pytest workers share the host: a small intra-op pool per worker
# keeps torch from oversubscribing the cores
torch.set_num_threads(min(2, torch.get_num_threads()))

RTOL = 1e-4
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def profile_tool():
    """The reference's matcher profile, ``tools/profile_matcher.py`` (a
    script, not a package module), loaded from its file. Its import-time
    ``runtime.setup()`` would repoint this process's compilation cache, so
    it is stubbed while the module loads."""
    spec = importlib.util.spec_from_file_location(
        "reference_profile_matcher",
        os.path.join(ROOT, "tools", "profile_matcher.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch("regard3d_tpu.runtime.setup"):
        spec.loader.exec_module(mod)
    return mod


def unit_rows(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_descs(rng, m, n, d=256, planted=32):
    a = unit_rows(rng.normal(size=(m, d)))
    b = unit_rows(rng.normal(size=(n, d)))
    b[:planted] = unit_rows(a[:planted] + 0.01 * rng.normal(size=(planted, d))
                            / np.sqrt(d))
    return a, b


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_top2(got, want, rtol=RTOL):
    """got/want: (d1, i1, d2). Indices identical, distances within rtol."""
    d1g, i1g, d2g = (_np(x) for x in got)
    d1w, i1w, d2w = (_np(x) for x in want)
    np.testing.assert_array_equal(i1g, i1w)
    np.testing.assert_allclose(d1g, d1w, rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(d2g, d2w, rtol=rtol, atol=ATOL)


def test_sqdist_and_top2_ref(rng):
    a, b = make_descs(rng, 64, 48, d=16, planted=0)
    dj = np.asarray(jm.sqdist(jnp.asarray(a), jnp.asarray(b)))
    dt = tm.sqdist(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    vj, ij = jm.top2_ref(jnp.asarray(dj))
    vt, it = tm.top2_ref(torch.tensor(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("n", [512, 300])       # tiled and ragged N
def test_match_pair_ref_masked(rng, n):
    m = 256
    a, b = make_descs(rng, m, n, planted=64)
    mask_a = np.arange(m) < 200
    mask_b = np.arange(n) < n - 12                 # masked B rows
    ij, dj, okj = jm.match_pair_ref(jnp.asarray(a), jnp.asarray(mask_a),
                                    jnp.asarray(b), jnp.asarray(mask_b), 0.8)
    it, dt, okt = tm.match_pair_ref(torch.tensor(a), torch.tensor(mask_a),
                                    torch.tensor(b), torch.tensor(mask_b), 0.8)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    assert okt[:64].all() and (it[:64].numpy() == np.arange(64)).all()
    # the port's match_pair (kernel wrapper: plain version on CPU tensors)
    iw, dw, okw = tm.match_pair(torch.tensor(a), torch.tensor(mask_a),
                                torch.tensor(b), torch.tensor(mask_b), 0.8)
    np.testing.assert_array_equal(okw.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(iw.numpy()[okw.numpy()],
                                  np.asarray(ij)[np.asarray(okj)])


def test_single_pair_kernel_vs_pallas_interpret(rng):
    """K2: ``l2_top2_pallas`` (interpret mode) against the port's
    ``l2_top2`` on CPU tensors, with masked B rows."""
    m, n = 256, 512
    a, b = make_descs(rng, m, n, planted=64)
    mask_b = np.arange(n) < 500
    want = jm.l2_top2_pallas(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(mask_b), tile_m=128, tile_n=128)
    got = tm.l2_top2(torch.tensor(a), torch.tensor(b), torch.tensor(mask_b))
    _same_top2(got, want)


def _block_inputs(rng, B=3, N=256, D=256, valid=(256, 200, 230)):
    desc = unit_rows(rng.normal(size=(B, N, D)))
    noise = lambda: 0.01 * rng.normal(size=(40, D)) / np.sqrt(D)
    desc[1, :40] = unit_rows(desc[0, :40] + noise())
    desc[2, 10:50] = unit_rows(desc[1, :40] + noise())
    mask = np.zeros((B, N), bool)
    for i, v in enumerate(valid):
        mask[i, :v] = True
    pairs = np.asarray([[0, 1], [0, 2], [1, 2], [2, 0], [1, 2]], np.int32)
    return desc, mask, pairs


def test_block_kernel_vs_pallas_interpret(rng, monkeypatch):
    """K1: ``l2_top2_block_pallas`` in f32 (interpret mode, HIGHEST
    precision) against the port's ``l2_top2_block`` on CPU tensors."""
    desc, mask, pairs = _block_inputs(rng)
    want = jm.l2_top2_block_pallas(jnp.asarray(desc), jnp.asarray(mask),
                                   jnp.asarray(pairs), 128, 128, False)
    got = tm.l2_top2_block(torch.tensor(desc), torch.tensor(mask),
                           torch.tensor(pairs))
    _same_top2(got, want)
    # the plain version in small pair chunks gives the same answer
    monkeypatch.setattr(tm, "_PLAIN_CHUNK", 2 * desc.shape[1] ** 2)
    chunked = tm.l2_top2_block_plain(torch.tensor(desc), torch.tensor(mask),
                                     torch.tensor(pairs))
    _same_top2(chunked, got, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_match_pair_block_vs_reference(rng, bf16):
    """The stage's block matcher against the reference: f32 on its plain
    path, bf16 on its Pallas kernel route in interpret mode (the route the
    reference runs on its chip: bf16 operands, |b|^2 from f32, f32
    accumulation)."""
    desc, mask, pairs = _block_inputs(rng)
    ij, dj, okj = jm.match_pair_block(jnp.asarray(desc), jnp.asarray(mask),
                                      jnp.asarray(pairs), 0.8, bf16, 128,
                                      128, bf16=bf16)
    it, dt, okt = tm.match_pair_block(torch.tensor(desc), torch.tensor(mask),
                                      torch.tensor(pairs), 0.8, bf16=bf16)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    # planted correspondences are found: pair (0, 1) rows 0..39
    assert okt[0, :40].all()
    np.testing.assert_array_equal(it[0, :40].numpy(), np.arange(40))


@pytest.mark.parametrize("masked", [False, True])
def test_match_pairs_batched_vs_reference(rng, masked):
    """Batched single-pair matching at ``tests/test_match.py``'s size (3
    pairs of 128 x 128, D = 256, 16 planted matches), against the
    reference's plain path; with masked rows on both sides as well."""
    P, m, n = 3, 128, 128
    A, B = (np.stack(x) for x in zip(*(make_descs(rng, m, n, planted=16)
                                       for _ in range(P))))
    ma = np.ones((P, m), bool)
    mb = np.ones((P, n), bool)
    if masked:
        ma[:, 100:] = False
        mb[:, 90:] = False
        mb[1, 3] = False
    ij, dj, okj = jm.match_pairs_batched(
        jnp.asarray(A), jnp.asarray(ma), jnp.asarray(B), jnp.asarray(mb),
        0.8, False, 128, 128)
    before = dict(_build.LAUNCHES)
    it, dt, okt = tm.match_pairs_batched(torch.tensor(A), torch.tensor(ma),
                                         torch.tensor(B), torch.tensor(mb))
    assert _build.LAUNCHES == before and it.shape == (P, m)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=ATOL)
    for p in range(P):
        keep = mb[p, :16] if masked else np.ones(16, bool)
        np.testing.assert_array_equal(it[p, :16].numpy()[keep],
                                      np.arange(16)[keep])


def test_exact_ties_lowest_index_wins(rng):
    """Duplicate B rows give bit-equal distances: the lowest column wins,
    d2 == d1, and the ratio test rejects the row — in the reference's
    plain path, its Pallas kernel (ties across tiles) and the port."""
    D, N = 256, 256
    a = unit_rows(rng.normal(size=(128, D)))
    b = unit_rows(rng.normal(size=(N, D)))
    b[5] = a[0] + 0.01
    b[200] = b[5]                         # tie across 128-wide tiles
    b[7] = a[1] + 0.01
    b[9] = b[7]                           # tie inside one tile
    mask_b = np.ones(N, bool)
    want = jm.l2_top2_pallas(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(mask_b), tile_m=128, tile_n=128)
    got = tm.l2_top2(torch.tensor(a), torch.tensor(b), torch.tensor(mask_b))
    _same_top2(got, want)
    d1, i1, d2 = (x.numpy() for x in got)
    assert i1[0] == 5 and i1[1] == 7
    assert d1[0] == d2[0] and d1[1] == d2[1]
    ij, _, okj = jm.match_pair_ref(jnp.asarray(a), jnp.ones(128, bool),
                                   jnp.asarray(b), jnp.asarray(mask_b), 0.8)
    it, _, okt = tm.match_pair_ref(torch.tensor(a), torch.ones(128, dtype=bool),
                                   torch.tensor(b), torch.tensor(mask_b), 0.8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not okt[0] and not okt[1] and not bool(okj[0])
    # block form: pair table with the same image twice
    desc = np.stack([np.pad(a, ((0, N - 128), (0, 0))), b])
    mask = np.stack([np.arange(N) < 128, mask_b])
    pairs = np.asarray([[0, 1]], np.int32)
    wantb = jm.l2_top2_block_pallas(jnp.asarray(desc), jnp.asarray(mask),
                                    jnp.asarray(pairs), 128, 128, False)
    gotb = tm.l2_top2_block(torch.tensor(desc), torch.tensor(mask),
                            torch.tensor(pairs))
    # rows 128.. of image 0 are zero padding: every distance there is |b|^2
    # = 1 up to rounding, a near-tie with no defined winner
    _same_top2([t[:, :128] for t in gotb], [t[:, :128] for t in wantb])
    assert gotb[1][0, 0] == 5 and gotb[1][0, 1] == 7


@pytest.mark.parametrize("kernel", ["block", "single"])
def test_bf16_kernels_vs_pallas_interpret(rng, kernel):
    """K1 and K2 at ``bf16=True`` against ``l2_top2_block_pallas`` and
    ``l2_top2_pallas`` in interpret mode, masked rows included: f32
    descriptors in, bf16 operands, |b|^2 from the f32 values."""
    desc, mask, pairs = _block_inputs(rng)
    if kernel == "block":
        want = jm.l2_top2_block_pallas(jnp.asarray(desc), jnp.asarray(mask),
                                       jnp.asarray(pairs), 128, 128, True)
        got = tm.l2_top2_block(torch.tensor(desc), torch.tensor(mask),
                               torch.tensor(pairs), bf16=True)
    else:
        want = jm.l2_top2_pallas(jnp.asarray(desc[0]), jnp.asarray(desc[1]),
                                 jnp.asarray(mask[1]), tile_m=128,
                                 tile_n=128, bf16=True)
        got = tm.l2_top2(torch.tensor(desc[0]), torch.tensor(desc[1]),
                         torch.tensor(mask[1]), bf16=True)
    _same_top2(got, want)


def _unit_random_block(seed=0, B=3, N=256, D=144):
    """Random unit-norm rows (no planted matches, so near neighbours are
    close calls) and a cyclic pair table."""
    x = np.random.default_rng(seed).random((B, N, D)).astype(np.float32)
    x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    return (x, np.ones((B, N), bool),
            np.asarray([[0, 1], [1, 2], [2, 0]], np.int32))


def test_bf16_bnorm_from_f32_matches_pallas_rounded_route_does_not():
    """The bf16 repair: taking |b|^2 from the rounded descriptors (the
    port's former route: round first, then hand the bf16 tensor over)
    moves i1 on some of these rows and d1 by ~1e-3; with |b|^2 from the f32
    values, as the Pallas kernel takes it, every row agrees."""
    desc, mask, pairs = _unit_random_block()
    want = jm.l2_top2_block_pallas(jnp.asarray(desc), jnp.asarray(mask),
                                   jnp.asarray(pairs), 128, 128, True)
    t = torch.tensor
    _same_top2(tm.l2_top2_block(t(desc), t(mask), t(pairs), bf16=True),
               want)
    old = tm.l2_top2_block(t(desc).to(torch.bfloat16), t(mask), t(pairs))
    moved = (old[1].numpy() != np.asarray(want[1])).sum()
    assert moved >= 1, moved
    assert np.abs(old[0].numpy() - np.asarray(want[0])).max() > 1e-4


@pytest.mark.parametrize("mode", ["mm_only", "min_only"])
@pytest.mark.parametrize("d", [144, 256])
def test_ablated_block_vs_pallas_interpret(mode, d):
    """K3: the port's ``l2_top2_block_ablated`` on CPU tensors against the
    matcher profile's ``_ablated_block`` in interpret mode, at tile_n = 128
    (the kernel's column tile). Tolerance rtol 1e-5 + atol 1e-5: both sides
    sum exact bf16 products in f32, in different orders."""
    desc, mask, pairs = _block_inputs(np.random.default_rng(1), D=d)
    want = profile_tool()._ablated_block(jnp.asarray(desc), jnp.asarray(mask),
                                         jnp.asarray(pairs), 128, 128, mode)
    got = tm.l2_top2_block_ablated(torch.tensor(desc), torch.tensor(mask),
                                   torch.tensor(pairs), mode)
    assert tm.TILE_N == 128 and got.shape == (len(pairs), desc.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# clusters of 1..8 blocks a card holds at once: every SM of a 132-SM card
# usable (IDEAL), and what ``cudaOccupancyMaxActiveClusters`` reads for
# both FULL kernels (one block an SM) on an H100 80GB HBM3, whose GPCs
# leave SMs idle at most cluster sizes (H100)
IDEAL = tuple(132 // r for r in range(1, 9))
H100 = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("P,M,N,granule,fits,want", [
    (64, 4096, 4096, 2, H100, (1, 32)),  # K1 on the main path: 2048 blocks
    (64, 768, 768, 2, H100, (1, 6)),     # K1 at the scale tool's N
    (1, 4000, 3001, 1, IDEAL, (4, 6)),   # K2: 32 row tiles of 24 tiles
    (1, 4000, 3001, 1, H100, (3, 8)),    # 30 clusters of 4 fit, 39 of 3
    (1, 4000, 3001, 2, H100, (3, 8)),    # f32: two column tiles a step
    (1, 100, 100, 1, H100, (1, 1)),      # one column tile: nothing to split
    (4, 1000, 4096, 1, IDEAL, (4, 8)),   # 32 blocks -> 128
    (1, 4000, 600, 1, IDEAL, (3, 2)),    # 5 tiles: 4 ranks leave one empty
], ids=["k1_main", "k1_scale", "k2_ideal", "k2_h100_bf16", "k2_h100_f32",
        "one_tile", "few_pairs", "no_empty_rank"])
def test_cluster_plan(P, M, N, granule, fits, want):
    """A call whose row tiles fill less than one wave becomes clusters of up
    to 8 ranks: the fewest waves x column tiles a rank (counted in steps of
    ``granule`` tiles) that the card's cluster capacity allows; each rank a
    contiguous range of whole 128-column tiles, none empty."""
    ranks, per = tm.cluster_plan(P, M, N, fits, granule)
    assert (ranks, per) == want
    ntiles = -(-N // 128)
    assert 1 <= ranks <= tm.MAX_RANKS
    assert (ranks - 1) * per < ntiles <= ranks * per
    assert ranks == 1 or -(-M // 128) * P <= fits[ranks - 1]


@pytest.mark.parametrize("bf16", [False, True])
def test_rank_merge_keeps_lowest_column_on_ties(rng, bf16):
    """The plain version of the cluster path's merge (``merge_top2`` over
    the ranks' column ranges in rank order) on K2's shape: exact ties
    planted inside one range (columns 9 and 11) and across two ranges
    (columns 5 and 2000, in ranks 0 and 2 of 4) keep the lowest column with
    d2 == d1, and every row equals the unsplit plain version and the
    reference's nearest index."""
    a = unit_rows(rng.normal(size=(256, 144)))
    b = unit_rows(rng.normal(size=(3001, 144)))
    b[5] = a[0] + 0.01
    b[2000] = b[5]
    b[9] = a[1] + 0.01
    b[11] = b[9]
    mask = np.ones(3001, bool)
    mask[::50] = False
    mask[[5, 9, 11, 2000]] = True
    ranks, per = tm.cluster_plan(1, 4000, 3001, IDEAL)
    assert ranks == 4 and 5 // (per * 128) != 2000 // (per * 128)
    t = torch.tensor
    got = tm.l2_top2_ranks_plain(t(a), t(b), t(mask), ranks, bf16)
    want = tm.l2_top2_plain(t(a), t(b), t(mask), bf16)
    _same_top2(got, want, rtol=1e-6)
    d1, i1, d2 = (x.numpy() for x in got)
    assert i1[0] == 5 and i1[1] == 9
    assert d1[0] == d2[0] and d1[1] == d2[1]
    ij, _, _ = jm.match_pair_ref(jnp.asarray(a), jnp.ones(256, bool),
                                 jnp.asarray(b), jnp.asarray(mask), 0.8)
    np.testing.assert_array_equal(i1, np.asarray(ij))
    # the merge rule itself: a tie across ranks keeps the lower column
    m = tm.merge_top2((t([1.0, 1.0, 2.0]), t([3, 7, 1]), t([4.0, 4.0, 5.0])),
                      (t([1.0, 1.0, 1.5]), t([9, 2, 8]), t([1.0, 3.0, 6.0])))
    np.testing.assert_array_equal(m[0].numpy(), [1.0, 1.0, 1.5])
    np.testing.assert_array_equal(m[1].numpy(), [3, 2, 8])
    np.testing.assert_array_equal(m[2].numpy(), [1.0, 1.0, 2.0])


def test_mutual_filter(rng):
    a, b = make_descs(rng, 64, 64, planted=32)
    ones = np.ones(64, bool)
    iab, _, okab = jm.match_pair_ref(jnp.asarray(a), jnp.asarray(ones),
                                     jnp.asarray(b), jnp.asarray(ones), 0.9)
    iba, _, okba = jm.match_pair_ref(jnp.asarray(b), jnp.asarray(ones),
                                     jnp.asarray(a), jnp.asarray(ones), 0.9)
    want = np.asarray(jm.mutual_filter(iab, okab, iba, okba))
    got = tm.mutual_filter(torch.tensor(np.asarray(iab)),
                           torch.tensor(np.asarray(okab)),
                           torch.tensor(np.asarray(iba)),
                           torch.tensor(np.asarray(okba)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:32].all()


def test_wrappers_take_plain_version_only_on_cpu(rng):
    """A CPU tensor runs the plain version and counts no kernel launch."""
    desc, mask, pairs = _block_inputs(rng)
    before = dict(_build.LAUNCHES)
    tm.l2_top2_block(torch.tensor(desc), torch.tensor(mask),
                     torch.tensor(pairs))
    tm.l2_top2(torch.tensor(desc[0]), torch.tensor(desc[1]),
               torch.tensor(mask[1]), bf16=True)
    for mode in tm.ABLATIONS:
        tm.l2_top2_block_ablated(torch.tensor(desc), torch.tensor(mask),
                                 torch.tensor(pairs), mode)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="mode"):
        tm.l2_top2_block_ablated(torch.tensor(desc), torch.tensor(mask),
                                 torch.tensor(pairs), "full")


def _flat(shape, dtype, offset=0):
    """A contiguous tensor of ``shape`` starting ``offset`` elements into a
    fresh (aligned) buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("case,dtype,shape,offset,match", [
    ("d_not_whole_k_steps", torch.bfloat16, (2, 8, 8), 0, "multiple of 16"),
    ("f32_rows_of_80_bytes", torch.float32, (2, 8, 20), 0, "multiple of 16"),
    ("bf16_d_above_max", torch.bfloat16, (2, 8, 304), 0, "D <= 288"),
    ("row_stride_not_16_bytes", torch.float32, (2, 8, 16), 0, "contiguous"),
    ("misaligned", torch.float32, (2, 8, 16), 1, "16-byte aligned"),
    ("float16", torch.float16, (2, 8, 16), 0, "float32 or bfloat16"),
    ("layout_ok_but_on_the_host", torch.bfloat16, (2, 8, 288), 0, "CUDA"),
])
def test_kernel_operands_the_tensor_maps_cannot_take_are_rejected(
        case, dtype, shape, offset, match):
    """The kernels read rows through TMA tensor maps: rows of whole k steps
    (16 values, so a multiple of 16 bytes), D <= MAX_BF16_DIM in bf16,
    16-byte aligned, contiguous; the layout is checked before the device,
    and a tensor that passes it still has to be on a card."""
    t = _flat(shape, dtype, offset)
    if case == "row_stride_not_16_bytes":      # rows 20 floats apart
        t = _flat((2, 8, 20), dtype)[..., :16]
    assert tm.MAX_BF16_DIM == 288
    bnorm = torch.zeros(shape[:2])
    pairs = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises((ValueError, TypeError), match=match):
        tm._block_call(t, t, bnorm, pairs)


def test_host_pairs_checks_the_table():
    """The pair table goes to the card as a checked int32 (P, 2) table:
    A indices below Ba, B indices below Bb, none negative, not empty."""
    good = tm._host_pairs(torch.tensor([[0, 1], [2, 0]]), 3, 2)
    assert good.dtype == torch.int32 and good.is_contiguous()
    assert good.tolist() == [[0, 1], [2, 0]]
    for bad, err in ((torch.zeros((0, 2), dtype=torch.int32), ValueError),
                     (torch.zeros((3,), dtype=torch.int32), ValueError),
                     (torch.tensor([[0, 2]]), IndexError),
                     (torch.tensor([[3, 0]]), IndexError),
                     (torch.tensor([[-1, 0]]), IndexError)):
        with pytest.raises(err):
            tm._host_pairs(bad, 3, 2)


def test_bnorm_of_the_images_a_table_reads(rng):
    """|b|^2 restricted to the images of a pair table's B column: the same
    values on those images' rows (masked rows 3e38), 3e38 on the others;
    a table that reads every image gives the full sums."""
    desc, mask, _ = _block_inputs(rng)
    desc, mask = torch.tensor(desc), torch.tensor(mask)
    full = tm._bnorm(desc, mask)
    images = torch.tensor([2, 0, 2], dtype=torch.int32)
    sub = tm._bnorm(desc, mask, images)
    assert sub.shape == full.shape and sub.dtype == torch.float32
    for b in range(desc.shape[0]):
        if b in (0, 2):
            np.testing.assert_array_equal(sub[b].numpy(), full[b].numpy())
        else:
            assert bool((sub[b] == tm._BIG).all())
    every = torch.arange(desc.shape[0]).repeat(2)
    np.testing.assert_array_equal(tm._bnorm(desc, mask, every).numpy(),
                                  full.numpy())
