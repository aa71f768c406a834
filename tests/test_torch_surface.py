"""Port parity: surface reconstruction (``surface/poisson.py``,
``surface/marching.py``) and the model operations
(``export/model_ops.py``) against the JAX package, on the CPU, on the
reference tests' analytic clouds (``tests/test_surface.py``).

Tolerances (f32 FFTs and sums in other orders in the two packages):

* ``splat_field``, ``sample_trilinear``: within 1e-5; ``solve_indicator``:
  within 1e-4 of max |chi|;
* ``marching_tetrahedra``, ``compact_mesh``: bit-identical on the same
  volume (a host numpy copy);
* ``reconstruct`` on the sphere cloud at depth 6: face count within 2%,
  symmetric chamfer distance <= half a voxel, and the reference's sphere
  and trim gates; a second call gives the same mesh bit for bit;
* the model operations: byte-identical files.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regard3d_tpu.export import model_ops as jmo
from regard3d_tpu.export import ply as jply
from regard3d_tpu.surface import marching as jmc
from regard3d_tpu.surface import poisson as jpo
from regard3d_tpu_torch.export import model_ops as tmo
from regard3d_tpu_torch.surface import marching as tmc
from regard3d_tpu_torch.surface import poisson as tpo
from tests.test_surface import _sphere_cloud

torch.set_num_threads(min(2, torch.get_num_threads()))

CENTER = np.array([10.0, -5.0, 3.0])


def chamfer(a, b):
    from scipy.spatial import cKDTree
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.fixture(scope="module")
def sphere():
    """The reference test's sphere cloud (15,000 points, r = 2), in the
    unit cube, with the reference's field on a 64^3 grid."""
    xyz, nrm = _sphere_cloud(np.random.default_rng(0))
    unit, scale, offset = jpo.normalize_points(xyz.astype(np.float32))
    nrm = nrm.astype(np.float32)
    V, W = jpo.splat_field(jnp.asarray(unit, jnp.float32),
                           jnp.asarray(nrm), 64)
    chi = jpo.solve_indicator(V, 64, sigma_vox=1.5, screen=0.0)
    return dict(xyz=xyz, nrm=nrm, unit=unit.astype(np.float32),
                scale=scale, V=np.array(V), W=np.array(W),
                chi=np.array(chi))


def test_normalize_points_identical(sphere):
    xyz = sphere["xyz"].astype(np.float32)
    for a, b in zip(tpo.normalize_points(xyz), jpo.normalize_points(xyz)):
        np.testing.assert_array_equal(a, b)


def test_splat_field_matches_reference(sphere):
    V, W = tpo.splat_field(torch.as_tensor(sphere["unit"]),
                           torch.as_tensor(sphere["nrm"]), 64)
    np.testing.assert_allclose(V.numpy(), sphere["V"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(W.numpy(), sphere["W"], rtol=1e-5, atol=1e-5)
    assert float(W.sum()) == pytest.approx(len(sphere["unit"]), rel=1e-4)


@pytest.mark.parametrize("sigma,screen", [(1.5, 0.0), (2.1, 0.04)])
def test_solve_indicator_matches_reference(sphere, sigma, screen):
    want = np.asarray(jpo.solve_indicator(jnp.asarray(sphere["V"]), 64,
                                          sigma_vox=sigma, screen=screen))
    got = tpo.solve_indicator(torch.as_tensor(sphere["V"]), 64,
                              sigma_vox=sigma, screen=screen).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_sample_trilinear_matches_reference(sphere, rng):
    pts = np.concatenate([sphere["unit"][:2000],
                          rng.uniform(0, 1, (2000, 3)).astype(np.float32)])
    want = np.asarray(jpo.sample_trilinear(jnp.asarray(sphere["chi"]),
                                           jnp.asarray(pts)))
    got = tpo.sample_trilinear(torch.as_tensor(sphere["chi"]),
                               torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _sdf_volume(n=48):
    g = np.linspace(0, 1, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (0.3 - np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
            ).astype(np.float32)


@pytest.mark.parametrize("volume", ["sdf", "chi"])
def test_marching_and_compact_bit_identical(sphere, volume):
    """The host copy gives the reference's mesh bit for bit, also with a
    slab that does not divide the grid."""
    vol = _sdf_volume() if volume == "sdf" else sphere["chi"]
    iso = 0.0 if volume == "sdf" else float(np.median(vol[vol > 0]))
    for slab in (32, 7):
        vw, fw = jmc.marching_tetrahedra(vol, iso, slab=slab)
        vg, fg = tmc.marching_tetrahedra(vol, iso, slab=slab)
        assert len(fw) > 1000
        np.testing.assert_array_equal(vg, vw)
        np.testing.assert_array_equal(fg, fw)
        assert vg.dtype == vw.dtype and fg.dtype == fw.dtype
    keep = np.arange(len(fw)) % 3 != 0
    for a, b in zip(tmc.compact_mesh(vw, fw[keep]),
                    jmc.compact_mesh(vw, fw[keep])):
        np.testing.assert_array_equal(a, b)


def _sphere_gates(verts, faces):
    """The reference's sphere gates (``tests/test_surface.py``)."""
    assert len(faces) > 5000
    r = np.linalg.norm(verts - CENTER, axis=1)
    np.testing.assert_allclose(r.mean(), 2.0, atol=0.02)
    assert r.std() < 0.02
    cent = verts[faces].mean(1)
    nr = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    assert ((nr * (cent - CENTER)).sum(1) > 0).mean() > 0.99


@pytest.mark.parametrize("trim", [0.0, 7.0])
def test_reconstruct_sphere_matches_reference(sphere, trim):
    xyz, nrm = sphere["xyz"], sphere["nrm"]
    vw, fw = jpo.reconstruct(xyz, nrm, depth=6, trim_threshold=trim)
    vg, fg = tpo.reconstruct(xyz, nrm, depth=6, trim_threshold=trim,
                             device="cpu")
    assert vg.dtype == np.float64 and fg.dtype == np.int32
    assert abs(len(fg) - len(fw)) <= 0.02 * len(fw)
    voxel = sphere["scale"] / 63
    assert chamfer(vg, vw) <= 0.5 * voxel
    _sphere_gates(vg, fg)
    # the same cloud again: the same mesh, bit for bit
    vg2, fg2 = tpo.reconstruct(xyz, nrm, depth=6, trim_threshold=trim,
                               device="cpu")
    np.testing.assert_array_equal(vg2, vg)
    np.testing.assert_array_equal(fg2, fg)


def test_reconstruct_trimming_removes_unsupported(rng):
    """The reference's hemisphere gate: trimming cuts the hallucinated
    lower half."""
    v = rng.normal(size=(20000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    hemi = v[v[:, 2] > 0]
    xyz = hemi * 2.0
    v_t, f_t = tpo.reconstruct(xyz, hemi, depth=6, trim_threshold=7.0,
                               device="cpu")
    v_a, f_a = tpo.reconstruct(xyz, hemi, depth=6, trim_threshold=0.0,
                               device="cpu")
    assert len(f_t) < 0.8 * len(f_a)
    assert v_t[:, 2].min() > v_a[:, 2].min() + 0.3
    w_t, g_t = jpo.reconstruct(xyz, hemi, depth=6, trim_threshold=7.0)
    assert abs(len(f_t) - len(g_t)) <= 0.02 * len(g_t)


def test_model_ops_byte_identical(sphere, tmp_path, rng):
    """colorize_mesh_from_cloud (k = 3 and k = 1), combine_clouds,
    ply_to_obj and export_point_cloud write the reference's bytes."""
    verts, faces = jpo.reconstruct(sphere["xyz"], sphere["nrm"], depth=5,
                                   trim_threshold=0.0)
    mesh = str(tmp_path / "mesh.ply")
    jply.write_ply(mesh, jply.PlyData(xyz=verts, faces=faces))
    clouds = []
    for i in range(2):
        xyz = sphere["xyz"][i::2]
        rgb = rng.integers(0, 256, (len(xyz), 3)).astype(np.uint8)
        clouds.append(str(tmp_path / f"cloud{i}.ply"))
        jply.write_ply(clouds[-1], jply.PlyData(
            xyz=xyz, rgb=rgb, normals=sphere["nrm"][i::2]))
    pc_rgb = rng.uniform(size=(500, 3))
    for tag, mod in (("ref", jmo), ("port", tmo)):
        mod.combine_clouds(clouds, str(tmp_path / f"{tag}_all.ply"))
        for k in (1, 3):
            mod.colorize_mesh_from_cloud(
                mesh, str(tmp_path / f"{tag}_all.ply"),
                str(tmp_path / f"{tag}_col{k}.ply"), k=k)
        mod.ply_to_obj(str(tmp_path / f"{tag}_col3.ply"),
                       str(tmp_path / f"{tag}_col3.obj"))
        mod.ply_to_obj(mesh, str(tmp_path / f"{tag}_mesh.obj"))
        for c, rgb in (("c", pc_rgb), ("n", None)):
            mod.export_point_cloud(sphere["xyz"][:500], rgb,
                                   str(tmp_path / f"{tag}_pc{c}.ply"))
    for name in ("all.ply", "col1.ply", "col3.ply", "col3.obj", "mesh.obj",
                 "pcc.ply", "pcn.ply"):
        assert filecmp.cmp(str(tmp_path / f"ref_{name}"),
                           str(tmp_path / f"port_{name}"),
                           shallow=False), name
    with pytest.raises(ValueError, match="no colors"):
        tmo.colorize_mesh_from_cloud(mesh, mesh, str(tmp_path / "x.ply"))
