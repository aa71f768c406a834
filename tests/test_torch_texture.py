"""Port parity: mesh texturing (``surface/texture.py``) against the JAX
package, on the CPU, on the reference tests' constructions
(``tests/test_texture.py``: a color-gradient plane seen by two views, an
occluder in front of a small back face) and on the rendered two-plane
scene; then the whole slice, ``densify_scene`` -> ``reconstruct`` ->
``texture_mesh``, in both packages.

Tolerances (f32 in both packages, sums in other orders):

* ``face_view_data``: scores within 1e-4 relative, mean colors within
  1e-4; ``select_views``: labels identical on >= 99% of faces, and every
  face whose label differs is a tie (its two best scores within 1e-4);
* ``texture_mesh``: atlas within 1/255 on >= 99% of texels, labels as
  above, uvs identical; ``write_textured_obj``: byte-identical files;
* the slice: cloud count within 2% and chamfer <= 1e-3 of the extent,
  face count within 2% and chamfer <= half a voxel (the two chains give
  the same faces, with vertices a rounding apart), labels identical on
  >= 99% of faces and the atlases within 1/255 on >= 99% of texels.
"""

import filecmp

import numpy as np
import pytest
import torch

from regard3d_tpu.core import sfm_data as jsd
from regard3d_tpu.mvs import driver as jdrv
from regard3d_tpu.surface import poisson as jpo
from regard3d_tpu.surface import texture as jtx
from regard3d_tpu_torch.core.types import scene_from_numpy
from regard3d_tpu_torch.mvs import driver as tdrv
from regard3d_tpu_torch.surface import poisson as tpo
from regard3d_tpu_torch.surface import texture as ttx
from tests.test_mvs import _scene_from_render
from tests.test_pipeline import render_scene
from tests.test_texture import _make_scene, _plane_color, _render_plane

torch.set_num_threads(min(2, torch.get_num_threads()))


def port_scene(jscene):
    return scene_from_numpy(jsd.scene_to_numpy(jscene))


def chamfer(a, b):
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


def grid_mesh(x0, x1, y0, y1, z, g):
    """A (g x g)-cell triangulated rectangle at depth z, normals toward -z
    (the cameras)."""
    xs, ys = np.linspace(x0, x1, g + 1), np.linspace(y0, y1, g + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([X.ravel(), Y.ravel(), np.full(X.size, z)], -1)
    faces = []
    for j in range(g):
        for i in range(g):
            a = j * (g + 1) + i
            faces += [[a, a + g + 2, a + 1], [a, a + g + 1, a + g + 2]]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def plane_case():
    f, hw = 200.0, 200
    Cs = np.array([[-0.5, 0, 0], [0.5, 0, 0]], np.float32)
    Rs = np.stack([np.eye(3, dtype=np.float32)] * 2)
    verts, faces = grid_mesh(-1.2, 1.2, -1.2, 1.2, 5.0, 24)
    return (_make_scene(Rs, Cs, f, hw),
            [_render_plane(C, f, hw) for C in Cs], verts, faces)


def occluder_case():
    """``tests/test_texture.py``'s occlusion scene, with the gradient
    images of the plane case."""
    f, hw = 200.0, 200
    Cs = np.array([[0, 0, 0], [2.0, 0, 0]], np.float32)
    Rs = np.stack([np.eye(3, dtype=np.float32)] * 2)
    back = np.array([[-0.25, -0.25, 5], [0.25, 0.25, 5], [0.25, -0.25, 5]],
                    np.float32)
    gv, gf = grid_mesh(-0.4, 0.4, -0.4, 0.4, 3.0, 12)
    verts = np.concatenate([back, gv])
    faces = np.concatenate([[[0, 1, 2]], gf + 3]).astype(np.int64)
    return (_make_scene(Rs, Cs, f, hw),
            [_render_plane(C, f, hw) for C in Cs], verts, faces)


def two_plane_case():
    """The rendered two-plane scene (5 views at 128 px, gray images), both
    planes meshed: the near one occludes part of the far one."""
    rng = np.random.default_rng(0)
    sc = render_scene(rng, n_cams=5, hw=128, f=165.0)
    js = _scene_from_render(sc, n_lm=120)
    v1, f1 = grid_mesh(-1.0, 1.0, -1.0, 1.0, 8.0, 16)
    v2, f2 = grid_mesh(-9.0, 9.0, -9.0, 9.0, 13.0, 24)
    verts = np.concatenate([v1, v2])
    faces = np.concatenate([f1, f2 + len(v1)])
    return js, [np.clip(im, 0, 1) for im in sc["images"]], verts, faces


CASES = {"plane": plane_case, "occluder": occluder_case,
         "two_planes": two_plane_case}


def assert_labels_agree(got, want, scores):
    """Identical on >= 99% of faces; every other face a tie of the
    reference's two best scores."""
    diff = np.nonzero(got != want)[0]
    assert len(diff) <= 0.01 * len(want), diff
    top2 = np.sort(scores, axis=0)[-2:]
    ties = np.abs(top2[1] - top2[0]) <= 1e-4 * np.abs(top2[1])
    assert ties[diff].all(), diff[~ties[diff]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_face_view_data_matches_reference(case):
    js, images, verts, faces = CASES[case]()
    stacked, sizes = jtx._stack_images(images)
    vids = jtx._posed_view_ids(js)
    s_w, m_w = jtx.face_view_data(js, stacked, sizes, vids, verts, faces,
                                  zbuf_scale=4)
    ts = port_scene(js)
    np.testing.assert_array_equal(ttx._posed_view_ids(ts), vids)
    s_g, m_g = ttx.face_view_data(ts, stacked, sizes, vids, verts, faces,
                                  zbuf_scale=4, device="cpu")
    assert (s_w > 0).mean() > 0.3
    np.testing.assert_allclose(s_g, s_w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(m_g, m_w, atol=1e-4)
    assert_labels_agree(ttx.select_views(s_g), jtx.select_views(s_w), s_w)
    if case == "occluder":
        # view 0 is blocked for the back face, view 1 is clear
        assert s_g[0, 0] < 0.05 * s_g[1, 0]


def test_host_stages_identical(rng):
    """Outlier weights, view selection and seam leveling are host numpy
    copies: the same inputs give the same arrays."""
    scores = rng.uniform(0, 1, (4, 300)).astype(np.float32)
    scores[:, ::7] = 0.0
    means = rng.uniform(0, 1, (4, 300, 3)).astype(np.float32)
    for mode in ("none", "gauss_clamping", "gauss_damping"):
        np.testing.assert_array_equal(
            ttx.photometric_outlier_weights(scores, means, mode),
            jtx.photometric_outlier_weights(scores, means, mode))
    with pytest.raises(ValueError, match="unknown"):
        ttx.photometric_outlier_weights(scores, means, "median")
    lbl = ttx.select_views(scores)
    np.testing.assert_array_equal(lbl, jtx.select_views(scores))
    faces = rng.integers(0, 120, (300, 3))
    np.testing.assert_array_equal(
        ttx.seam_level_global(np.zeros((120, 3)), faces, lbl, scores,
                              means, 4),
        jtx.seam_level_global(np.zeros((120, 3)), faces, lbl, scores,
                              means, 4))
    np.testing.assert_array_equal(ttx._block_barycentrics(11, 1),
                                  jtx._block_barycentrics(11, 1))


def assert_meshes_agree(got, want, frac=0.99):
    np.testing.assert_array_equal(got.uvs, want.uvs)
    np.testing.assert_array_equal(got.verts, want.verts)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.atlas.shape == want.atlas.shape
    close = np.abs(got.atlas - want.atlas).max(-1) <= 1.0 / 255
    assert close.mean() >= frac, close.mean()


@pytest.mark.parametrize("case,outliers,seams", [
    ("plane", "none", "none"), ("plane", "gauss_damping", "global"),
    ("two_planes", "gauss_clamping", "global"),
    ("two_planes", "gauss_damping", "none")])
def test_texture_mesh_matches_reference(case, outliers, seams):
    js, images, verts, faces = CASES[case]()
    kw = dict(texel_res=8, outlier_removal=outliers, seam_leveling=seams,
              zbuf_scale=2, chunk=512)
    want = jtx.texture_mesh(js, images, verts, faces, **kw)
    got = ttx.texture_mesh(port_scene(js), images, verts, faces,
                           device="cpu", **kw)
    assert (want.labels >= 0).mean() > 0.5
    stacked, sizes = jtx._stack_images(images)
    scores, _ = jtx.face_view_data(js, stacked, sizes,
                                   jtx._posed_view_ids(js), verts, faces,
                                   zbuf_scale=2)
    assert_labels_agree(got.labels, want.labels, scores)
    assert_meshes_agree(got, want)


def test_texture_plane_exact_colors():
    """The reference's closed-form check: every texel of every face equals
    the analytic plane color (a linear gradient is exact under bilinear
    sampling)."""
    js, images, _, _ = plane_case()
    verts = np.array([[-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5]],
                     np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]])
    mesh = ttx.texture_mesh(port_scene(js), images, verts, faces,
                            texel_res=8, outlier_removal="none",
                            seam_leveling="none", zbuf_scale=2,
                            device="cpu")
    assert (mesh.labels >= 0).all()
    pad, T = 1, 8
    B = T + 2 * pad + 1
    bary = ttx._block_barycentrics(B, pad)
    nb = int(np.ceil(np.sqrt(len(faces))))
    for fi in range(len(faces)):
        P = np.einsum("xys,sd->xyd", bary, verts[faces[fi]])
        by, bx = divmod(fi, nb)
        got = mesh.atlas[by * B:(by + 1) * B, bx * B:(bx + 1) * B]
        np.testing.assert_allclose(got, _plane_color(P[..., 0], P[..., 1]),
                                   atol=5e-3)


def test_texture_mesh_needs_posed_views_and_faces():
    js, images, verts, _ = plane_case()
    with pytest.raises(ValueError, match="posed views and faces"):
        ttx.texture_mesh(port_scene(js), images, verts,
                         np.zeros((0, 3), np.int64), device="cpu")


def test_write_textured_obj_byte_identical(tmp_path):
    js, images, verts, faces = plane_case()
    mesh = jtx.texture_mesh(js, images, verts, faces)
    for tag, mod in (("ref", jtx), ("port", ttx)):
        (tmp_path / tag).mkdir()
        mod.write_textured_obj(str(tmp_path / tag / "tex"), mesh)
    for ext in (".obj", ".mtl", ".png"):
        assert filecmp.cmp(str(tmp_path / "ref" / ("tex" + ext)),
                           str(tmp_path / "port" / ("tex" + ext)),
                           shallow=False), ext
    assert "map_Kd tex.png" in (tmp_path / "port" / "tex.mtl").read_text()


def test_slice_densify_reconstruct_texture_matches_reference():
    """The slice end to end in both packages on the rendered two-plane
    scene (5 views at 128 px, [0, 1] float images): densify (level 0, 32
    planes, 3 sources) -> reconstruct (depth 6) -> texture_mesh."""
    rng = np.random.default_rng(0)
    sc = render_scene(rng, n_cams=5, hw=128, f=165.0)
    js = _scene_from_render(sc, n_lm=120)
    ts = port_scene(js)
    images = [np.clip(im, 0, 1).astype(np.float32) for im in sc["images"]]
    kw = dict(level=0, num_planes=32, threshold=0.6, num_sources=3,
              min_image_num=2)
    xyz_w, nrm_w, _, _ = jdrv.densify_scene(js, images, **kw)
    xyz, nrm, _, _ = tdrv.densify_scene(ts, images, device="cpu", **kw)
    assert len(xyz_w) > 1000
    assert abs(len(xyz) - len(xyz_w)) <= 0.02 * len(xyz_w)
    extent = float(np.ptp(xyz_w, 0).max())
    assert chamfer(xyz, xyz_w) <= 1e-3 * extent

    vw, fw = jpo.reconstruct(xyz_w, nrm_w, depth=6)
    vg, fg = tpo.reconstruct(xyz, nrm, depth=6, device="cpu")
    assert len(fw) > 1000
    assert abs(len(fg) - len(fw)) <= 0.02 * len(fw)
    voxel = extent / 0.8 / 63
    assert chamfer(vg, vw) <= 0.5 * voxel

    # one topology from both chains; the vertices differ by the clouds'
    # rounding, so the atlases are compared texel by texel
    np.testing.assert_array_equal(fg, fw)
    want = jtx.texture_mesh(js, images, vw, fw)
    got = ttx.texture_mesh(ts, images, vg, fg, device="cpu")
    assert (got.labels >= 0).mean() > 0.5
    assert (got.labels == want.labels).mean() >= 0.99
    close = np.abs(got.atlas - want.atlas).max(-1) <= 1.0 / 255
    assert close.mean() >= 0.99, close.mean()
    # on the reference's own mesh the port's atlas is the reference's
    same = ttx.texture_mesh(ts, images, vw, fw, device="cpu")
    assert_meshes_agree(same, want)
