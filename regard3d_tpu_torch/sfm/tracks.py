"""Tracks builder — fuse pairwise matches into multi-view tracks (host numpy).

Counterpart of ``regard3d_tpu/sfm/tracks.py`` (OpenMVG's union-find
``TracksBuilder``). Connected components come from vectorized min-label
propagation, relabelled densely by ``np.unique``: the min node of a
component orders components by first appearance, the order in which the
reference's native union-find numbers them, so the ``TrackTable`` is the
same either way.

Semantics (OpenMVG parity):
* nodes are (view, feature) pairs, edges are putative/geometric matches;
* connected components become tracks;
* tracks containing two different features of the same view are dropped
  (inconsistent), as are tracks shorter than ``min_length``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class TrackTable:
    """Flat observation table, sorted by track id."""
    track_id: np.ndarray    # (O,) int32
    view_id: np.ndarray     # (O,) int32
    feature_id: np.ndarray  # (O,) int32
    num_tracks: int

    def lengths(self) -> np.ndarray:
        return np.bincount(self.track_id, minlength=self.num_tracks)


def _connected_components(n: int, e0: np.ndarray, e1: np.ndarray):
    """Min-label propagation over an undirected edge list. Returns (n,)
    component labels (the min node id in each component)."""
    labels = np.arange(n, dtype=np.int64)
    while True:
        l_new = labels.copy()
        np.minimum.at(l_new, e0, labels[e1])
        np.minimum.at(l_new, e1, labels[e0])
        # pointer jumping: propagate through label indirection
        l_new = np.minimum(l_new, l_new[l_new])
        l_new = np.minimum(l_new, l_new[l_new])
        if np.array_equal(l_new, labels):
            return labels
        labels = l_new


def build_tracks(matches: Dict[Tuple[int, int], np.ndarray],
                 min_length: int = 2) -> TrackTable:
    """matches: {(i, j): (M, 2) array of (feat_i, feat_j) index pairs}.

    Returns a TrackTable with dense track ids (sorted by track)."""
    SHIFT = np.int64(1) << 32
    codes_a, codes_b = [], []
    for (i, j), m in matches.items():
        m = np.asarray(m, np.int64)
        if m.size == 0:
            continue
        codes_a.append(np.int64(i) * SHIFT + m[:, 0])
        codes_b.append(np.int64(j) * SHIFT + m[:, 1])
    if not codes_a:
        return TrackTable(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.int32), 0)
    ca = np.concatenate(codes_a)
    cb = np.concatenate(codes_b)

    nodes, inv = np.unique(np.concatenate([ca, cb]), return_inverse=True)
    e0 = inv[:len(ca)]
    e1 = inv[len(ca):]
    comp = _connected_components(len(nodes), e0, e1)
    _, comp = np.unique(comp, return_inverse=True)       # dense component ids

    views = (nodes // SHIFT).astype(np.int32)
    feats = (nodes % SHIFT).astype(np.int32)

    # sort nodes by (component, view)
    order = np.lexsort((views, comp))
    comp_s = comp[order]
    views_s = views[order]
    feats_s = feats[order]

    sizes = np.bincount(comp_s)
    # consistency: within a component, all views distinct <=> no adjacent
    # equal views after the (comp, view) sort
    dup = np.zeros(len(comp_s), bool)
    dup[1:] = (comp_s[1:] == comp_s[:-1]) & (views_s[1:] == views_s[:-1])
    bad = np.zeros(sizes.shape[0], bool)
    np.logical_or.at(bad, comp_s[dup], True)

    keep_comp = (~bad) & (sizes >= min_length)
    keep_row = keep_comp[comp_s]
    comp_k = comp_s[keep_row]
    # renumber surviving components densely, preserving order
    _, tids = np.unique(comp_k, return_inverse=True)
    return TrackTable(
        track_id=tids.astype(np.int32),
        view_id=views_s[keep_row],
        feature_id=feats_s[keep_row],
        num_tracks=int(tids.max()) + 1 if len(tids) else 0,
    )


def tracks_in_views(table: TrackTable, views: List[int]) -> np.ndarray:
    """Track ids observed in ALL the given views (e.g. the initial pair)."""
    sel = None
    for v in views:
        tv = set(table.track_id[table.view_id == v].tolist())
        sel = tv if sel is None else (sel & tv)
    return np.asarray(sorted(sel or []), np.int32)


def covisibility_pairs(table: TrackTable, num_views: int,
                       min_count: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse co-visibility: (pairs (P, 2) int32 with i<j, counts (P,)),
    sorted by count descending.  Never materializes a (V, V) matrix, so
    Rome16K-scale view graphs (V ~ 16k) stay in O(sum_t k_t^2) memory."""
    if len(table.track_id) == 0:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.int64)
    V = np.int64(num_views)
    order = np.lexsort((table.view_id, table.track_id))
    tid = table.track_id[order]
    vid = table.view_id[order].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, tid[1:] != tid[:-1]])
    ends = np.r_[starts[1:], len(tid)]
    lens = ends - starts
    codes = []
    for k in np.unique(lens):
        if k < 2:
            continue
        sel = starts[lens == k]
        idx = sel[:, None] + np.arange(k)[None, :]
        vs = vid[idx]                                  # sorted within track
        iu, ju = np.triu_indices(int(k), 1)
        codes.append(vs[:, iu].ravel() * V + vs[:, ju].ravel())
    if not codes:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.int64)
    enc, counts = np.unique(np.concatenate(codes), return_counts=True)
    keep = counts >= min_count
    enc, counts = enc[keep], counts[keep]
    o = np.argsort(-counts, kind="stable")
    enc, counts = enc[o], counts[o]
    pairs = np.stack([enc // V, enc % V], -1).astype(np.int32)
    return pairs, counts


def shared_track_count(table: TrackTable, num_views: int) -> np.ndarray:
    """(V, V) matrix of co-visible track counts (used for initial-pair /
    next-view selection).

    Sparse formulation: enumerate within-track view pairs directly (total
    work sum_t k_t^2 — track lengths are small), so city-scale scenes never
    materialize a (V, T) incidence matrix."""
    V = num_views
    counts = np.zeros((V, V), np.int64)
    if len(table.track_id) == 0:
        return counts
    order = np.lexsort((table.view_id, table.track_id))
    tid = table.track_id[order]
    vid = table.view_id[order]
    # segment boundaries per track
    starts = np.flatnonzero(np.r_[True, tid[1:] != tid[:-1]])
    ends = np.r_[starts[1:], len(tid)]
    lens = ends - starts
    # enumerate pairs per track, bucketed by track length (vectorized)
    for k in np.unique(lens):
        if k < 2:
            continue
        sel = starts[lens == k]
        idx = sel[:, None] + np.arange(k)[None, :]     # (n_tracks_k, k)
        vs = vid[idx]                                   # views per track
        iu, ju = np.triu_indices(k, 1)
        a = vs[:, iu].ravel()
        b = vs[:, ju].ravel()
        np.add.at(counts, (a, b), 1)
        np.add.at(counts, (b, a), 1)
    return counts
