"""Port parity: the port's own binding to the host library
(``regard3d_tpu_torch/native.py``) against ``regard3d_tpu.native``.

Both compile ``native/r3d_native.cpp``; the port builds it into its build
directory (``runtime.kernel_build_dir()``) with the reference's flags.
MSER, TBMR (both polarities) and the ``.feat`` parser must give rows
identical to the reference's on the same uint8 images and files, an empty
file included; ``union_find`` the reference's labels on the edge lists of
``tests/test_native.py``, and the components of the port's
``sfm/tracks.py`` on a track graph. The one allowed slack, 1e-5 on the float columns, applies
only where the reference loaded a library built otherwise (``native/
build.sh`` adds ``-march=native``, which lets g++ contract to FMA); each
test reports which case it met.
"""

import os

import numpy as np
import pytest

from regard3d_tpu import native as jnative
from regard3d_tpu_torch import native as tnative
from regard3d_tpu_torch import runtime
from regard3d_tpu_torch.ingest import synth
from regard3d_tpu_torch.sfm import tracks


def _same_build() -> bool:
    """Whether the reference's loaded library is byte-identical to the
    port's build (the same source and flags)."""
    assert jnative.get_lib() is not None
    with open(jnative._LIB_PATH, "rb") as a, \
            open(tnative.build(), "rb") as b:
        return a.read() == b.read()


def assert_rows_equal(port, ref, float_cols):
    """Identical rows; or, where the reference's library is another build,
    within 1e-5 on the float columns. Returns the case met."""
    assert port.dtype == ref.dtype and port.shape == ref.shape
    if np.array_equal(port, ref):
        return "identical"
    assert not _same_build(), "the same library gave other rows"
    np.testing.assert_allclose(port[:, float_cols], ref[:, float_cols],
                               rtol=0, atol=1e-5)
    other = [c for c in range(port.shape[1]) if c not in float_cols]
    np.testing.assert_array_equal(port[:, other], ref[:, other])
    return "within 1e-5 (reference built with other flags)"


def _images():
    rng = np.random.default_rng(0)
    blobs = (rng.normal(0, 2, (120, 160)) + 60).astype(np.uint8)
    yy, xx = np.mgrid[:120, :160]
    blobs[((xx - 80) / 30.0) ** 2 + ((yy - 60) / 15.0) ** 2 < 1] = 220
    blobs[20:40, 20:40] = 5
    view = synth.make_dataset("fountain", n_cams=2, hw=256, seed=0)[
        "images"][0]
    g8 = (np.clip(view, 0.0, 1.0) * 255.0).astype(np.uint8)
    return {"blobs": blobs, "fountain": g8}


def test_library_is_built_into_the_port_build_dir():
    path = tnative.build()
    assert os.path.dirname(path) == runtime.kernel_build_dir()
    assert os.path.basename(path).startswith("libr3d_native_")
    assert path != jnative._LIB_PATH
    assert tnative.GXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17"]


@pytest.mark.parametrize("name", ["blobs", "fountain"])
def test_mser_and_tbmr_rows_equal_reference(name):
    img = _images()[name]
    cases = {}
    rows_m = tnative.mser(img)
    assert len(rows_m) > 0
    cases["mser"] = assert_rows_equal(rows_m, jnative.mser(img), [0, 1, 2])
    cases["mser_area"] = assert_rows_equal(
        tnative.mser(img, min_area=60, max_area=500),
        jnative.mser(img, min_area=60, max_area=500), [0, 1, 2])
    rows_t = tnative.tbmr(img)
    assert len(rows_t) > 0
    cases["tbmr"] = assert_rows_equal(rows_t, jnative.tbmr(img),
                                      [0, 1, 2, 3, 4])
    cases["tbmr_one"] = assert_rows_equal(
        tnative.tbmr(img, both_polarities=False),
        jnative.tbmr(img, both_polarities=False), [0, 1, 2, 3, 4])
    print(name, cases)


def test_parse_feats_equal_reference_and_loadtxt(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.uniform(-10, 1000, size=(321, 4)).astype(np.float32)
    p = str(tmp_path / "x.feat")
    with open(p, "w") as f:
        for row in data:
            f.write(f"{row[0]:.6g} {row[1]:.6g} {row[2]:.6g} {row[3]:.6g}\n")
    out = tnative.parse_feats(p)
    np.testing.assert_array_equal(out, jnative.parse_feats(p))
    np.testing.assert_array_equal(out, np.loadtxt(p, ndmin=2,
                                                  dtype=np.float32))
    empty = str(tmp_path / "empty.feat")
    open(empty, "w").close()
    assert tnative.parse_feats(empty).shape == (0, 4)
    np.testing.assert_array_equal(tnative.parse_feats(empty),
                                  jnative.parse_feats(empty))
    with pytest.raises(RuntimeError, match="parse_feats"):
        tnative.parse_feats(str(tmp_path / "missing.feat"))


def test_build_failure_raises_with_the_compiler_message(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("R3D_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tnative.build()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()


def _union_find_edges(case):
    """The edge lists of ``tests/test_native.py``'s union-find cases:
    (edges, num_nodes)."""
    if case == "random":
        n = 5000
        edges = np.random.default_rng(0).integers(0, n, size=(20000, 2))
        return edges.astype(np.int64), n
    if case == "chain":
        return np.stack([np.arange(99), np.arange(1, 100)],
                        -1).astype(np.int64), 100
    # out-of-range ends are ignored
    return np.asarray([[0, 1], [5, 900], [-3, 2]], np.int64), 6


@pytest.mark.parametrize("case", ["random", "chain", "out_of_range"])
def test_union_find_labels_equal_reference(case):
    edges, n = _union_find_edges(case)
    got = tnative.union_find(edges, n)
    want = jnative.union_find(edges, n)
    assert want is not None
    assert got.dtype == np.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    if case == "chain":
        assert (got == 0).all()
    if case == "out_of_range":
        assert got[0] == got[1] and got[5] != got[0]
        assert len(set(got.tolist())) == 5


def test_union_find_components_equal_port_tracks():
    """On a sparse match graph (300 edges over 400 nodes: many components,
    some nodes isolated), ``union_find``'s labels and the component
    labelling of the port's ``sfm/tracks.build_tracks`` (min-label
    propagation, densely renumbered) give the same numbering."""
    rng = np.random.default_rng(1)
    n = 400
    e0 = rng.integers(0, n, 300)
    e1 = (e0 + rng.integers(1, 4, 300)) % n
    edges = np.stack([e0, e1], -1).astype(np.int64)
    labels = tnative.union_find(edges, n)
    comp = tracks._connected_components(n, e0.astype(np.int64),
                                        e1.astype(np.int64))
    _, dense = np.unique(comp, return_inverse=True)
    np.testing.assert_array_equal(labels, dense)
    assert 1 < labels.max() + 1 < n
