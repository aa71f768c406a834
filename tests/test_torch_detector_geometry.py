"""GFTT's F-validated pairs lie off the exact geometry in the reference as
in the port, on the CPU.

``chip_smoke.py``'s phase (m) holds every detector's F-validated pairs to
a median symmetric epipolar error < 1 px, but for GFTT: it describes 3 px
corners at kpSizeFactor 0.13, a LIOP patch under a pixel, so its putative
matches are mostly wrong and the a-contrario F filter validates pairs on
them. This test runs both packages on the same 3 synthetic fountain views
at (m)'s width and keypoint budget (1024², 4096 keypoints, focal prior
1.03x the truth), 256 RANSAC iterations, and requires that each validates
at least one pair and that every pair it validates lies at a median > 1 px
from the exact geometry. The reference is run through its stage's own
steps (``extract_features``, ``load_all_padded``, ``_match_block`` over
the 3 pairs, ``geometric_filter``): its ``match_all_pairs`` pads the pair
list to blocks of 64, which costs minutes on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import sym_epipolar_px, true_fundamental
from regard3d_tpu.kernels import match as jm
from regard3d_tpu.pipeline import compute_matches as jcm
from regard3d_tpu.pipeline import features as jf
from regard3d_tpu_torch.ingest import synth
from regard3d_tpu_torch.pipeline import compute_matches as tcm
from regard3d_tpu_torch.pipeline import features as tf

torch.set_num_threads(min(2, torch.get_num_threads()))

N_VIEWS, HW, MAX_KP, ITERS = 3, 1024, 4096, 256


def _medians(ds, f_matches, xy):
    return {(i, j): float(np.median(sym_epipolar_px(
        true_fundamental(ds, i, j), xy[i][m[:, 0]], xy[j][m[:, 1]])))
        for (i, j), m in f_matches.items()}


def _reference(ds, out):
    images = list(ds["images"][:N_VIEWS])
    cfg = jcm.MatchConfig(ransac_iters=ITERS)
    jf.extract_features(images, out, detector="gftt", max_keypoints=MAX_KP)
    kps, descs = jf.load_all_padded(out, N_VIEWS, pad_to=256)
    pairs = jcm.exhaustive_pairs(N_VIEWS)
    n = descs.data.shape[1]
    idx, ok = jcm._match_block(
        descs.data, descs.mask, jnp.asarray(np.asarray(pairs, np.int32)),
        cfg, False, *jm._auto_tiles(n, n),
        jcm.matcher_knobs(cfg.matcher)["bf16"], None, "pairs")
    idx, ok = np.asarray(idx), np.asarray(ok)
    putative = {}
    for b, p in enumerate(pairs):
        ia = np.where(ok[b])[0]
        putative[p] = np.stack([ia, idx[b][ia]], -1).astype(np.int64)
    filt = jcm.geometric_filter(kps, putative,
                                np.asarray([[HW, HW]] * N_VIEWS),
                                np.full(N_VIEWS, ds["f"] * 1.03), cfg)
    xy = [jf.load_features(out, i)[0] for i in range(N_VIEWS)]
    return _medians(ds, filt.f, xy)


def _port(ds, out):
    tcm.run_compute_matches(list(ds["images"][:N_VIEWS]), out,
                            cfg=tcm.MatchConfig(ransac_iters=ITERS),
                            focals=np.full(N_VIEWS, ds["f"] * 1.03),
                            max_keypoints=MAX_KP, detector="gftt",
                            device="cpu")
    f = tcm.load_matches_txt(os.path.join(out, "matches.f.txt"))
    xy = [tf.load_features(out, i)[0] for i in range(N_VIEWS)]
    return _medians(ds, f, xy)


def test_gftt_validates_pairs_off_the_geometry_in_both_packages(tmp_path):
    ds = synth.make_dataset("fountain", n_cams=11, hw=HW, seed=0)
    ref = _reference(ds, str(tmp_path / "ref"))
    port = _port(ds, str(tmp_path / "port"))
    print(f"GFTT F-validated pairs, median px: reference {ref}, port {port}")
    for got in (ref, port):
        assert got and min(got.values()) > 1.0, (ref, port)
