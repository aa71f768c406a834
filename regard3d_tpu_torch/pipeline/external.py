"""External MVS / surface / texturing tool runners (host-side sinks).

Parity with the reference's process layer:
* ``R3DExternalPrograms`` (src/utils/R3DExternalPrograms.cpp): discovery of
  the 14 helper executables;
* ``R3DDensificationProcess`` (src/R3DDensificationProcess.cpp): CMVS ->
  genOption -> pmvs2 per cluster (``option-%04d`` discovery loop :239-263),
  or MVE ``dmrecon`` -> ``scene2pset``, or SMVS;
* ``R3DSurfaceGenProcess`` (src/R3DSurfaceGenProcess.cpp): PoissonRecon ->
  SurfaceTrimmer | fssrecon -> meshclean; texrecon texturing; colored
  vertices handled in-process (model_ops k-NN transfer).

Densification stays an external sink per the BASELINE north star; commands
run synchronously with captured logs (the reference chains async wxProcess
callbacks — here a simple sequential subprocess loop).

Counterpart of ``regard3d_tpu/pipeline/external.py``: the same executables,
command lines, logs and result dicts. The in-process ``tpu`` methods run
the port's dense slice on ``device`` (``cuda`` unless ``device="cpu"``), as
do the image undistortions of the exports the external tools read.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Dict, List, Optional

EXTERNAL_PROGRAMS = [
    "cmvs", "pmvs2", "genOption", "dmrecon", "scene2pset", "smvsrecon",
    "smvsrecon_SSE41", "PoissonRecon", "SurfaceTrimmer", "fssrecon",
    "meshclean", "texrecon", "makescene", "sfmrecon",
]


class ExternalPrograms:
    """Executable discovery (R3DExternalPrograms parity)."""

    def __init__(self, extra_dirs: Optional[List[str]] = None):
        self.paths: Dict[str, str] = {}
        dirs = list(extra_dirs or [])
        env_dir = os.environ.get("R3D_EXTERNAL_PROGRAMS_DIR")
        if env_dir:
            dirs.append(env_dir)
        for name in EXTERNAL_PROGRAMS:
            found = None
            for d in dirs:
                cand = os.path.join(d, name)
                if os.path.isfile(cand) and os.access(cand, os.X_OK):
                    found = cand
                    break
            if not found:
                found = shutil.which(name)
            if found:
                self.paths[name] = found

    def has(self, name: str) -> bool:
        return name in self.paths

    def require(self, *names: str):
        missing = [n for n in names if n not in self.paths]
        if missing:
            raise RuntimeError(
                f"external program(s) not found: {', '.join(missing)} — "
                f"install them on PATH or set R3D_EXTERNAL_PROGRAMS_DIR")


def smvs_command(exe: str, scene_dir: str, args) -> List[str]:
    """SMVS command parity (src/R3DDensificationProcess.cpp:171-176):
    ``smvsrecon --scale=%d --output-scale=%d [-S] [--no-sgm] --alpha=%f
    --force <scene>``."""
    cmd = [exe,
           "--scale=%d" % getattr(args, "input_scale", 2),
           "--output-scale=%d" % getattr(args, "output_scale", 2)]
    if getattr(args, "shading", False):
        cmd.append("-S")
    if not getattr(args, "sgm", True):
        cmd.append("--no-sgm")
    cmd += ["--alpha=%f" % getattr(args, "alpha", 1.0), "--force", scene_dir]
    return cmd


def fssr_commands(fssr_exe: str, meshclean_exe: str, dense: str, raw: str,
                  surf: str, args) -> List[List[str]]:
    """FSSR command parity (src/R3DSurfaceGenProcess.cpp:152-161):
    ``fssrecon --scale-factor=%g --refine-octree=%d``, then
    ``meshclean --threshold=%g --component-size=%d``."""
    return [
        [fssr_exe,
         "--scale-factor=%g" % getattr(args, "scale_factor", 1.0),
         "--refine-octree=%d" % getattr(args, "refine_octree_levels", 0),
         dense, raw],
        [meshclean_exe,
         "--threshold=%g" % getattr(args, "conf_threshold", 1.0),
         "--component-size=%d" % getattr(args, "min_component_size", 1000),
         raw, surf],
    ]


def texrecon_command(exe: str, mve_scene: str, surf: str, out_prefix: str,
                     args) -> List[str]:
    """texrecon flag parity (src/R3DSurfaceGenProcess.cpp:172-197)."""
    cmd = [exe]
    if not getattr(args, "visibility_test", True):
        cmd.append("--skip_geometric_visibility_test")
    if getattr(args, "seam_leveling", "global") != "global":
        cmd.append("--skip_global_seam_leveling")
    if not getattr(args, "local_seam_leveling", True):
        cmd.append("--skip_local_seam_leveling")
    outlier = getattr(args, "outlier_removal", "none")
    if outlier in ("gauss_clamping", "gauss_damping"):
        cmd.append("--outlier_removal=%s" % outlier)
    cmd.append("--no_intermediate_results")
    cmd += [mve_scene + "::undistorted", surf, out_prefix]
    return cmd


def _run(cmd: List[str], log_path: str, cwd: Optional[str] = None):
    """Run one tool, capturing stdout/stderr to the step log
    (console-capture parity, src/R3DDensificationProcess.cpp:190-218)."""
    with open(log_path, "a") as log:
        log.write(f"\n$ {' '.join(cmd)}\n")
        log.flush()
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                              cwd=cwd)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed with code {proc.returncode} "
                           f"(see {log_path})")


def run_densification(project, triangulation_id: int, out_dir: str, args,
                      programs: Optional[ExternalPrograms] = None,
                      device=None) -> Dict:
    """Dense reconstruction: the in-process plane sweep (``tpu``), or
    external MVS tools."""
    from regard3d_tpu_torch.core import sfm_data
    from regard3d_tpu_torch.export import formats, model_ops
    from regard3d_tpu_torch.ingest import image_io

    if getattr(args, "method", "pmvs") in ("tpu", "planesweep"):
        from regard3d_tpu_torch.mvs.driver import run_native_densification
        return run_native_densification(project, triangulation_id, out_dir,
                                        args, device=device)

    programs = programs or ExternalPrograms()
    scene = sfm_data.load_npz(project.paths(triangulation_id).scene_npz)
    ps_obj = project.objects[project.objects[triangulation_id].parent_id]
    infos = project.objects[ps_obj.parent_id].params["image_info"]
    images = [image_io.load_rgb(i["path"]) for i in infos]
    log = os.path.join(out_dir, "densification.log")

    method = getattr(args, "method", "pmvs")
    if method == "pmvs":
        programs.require("pmvs2")
        formats.export_pmvs(out_dir, scene, images,
                            level=getattr(args, "level", 1),
                            csize=getattr(args, "csize", 2),
                            threshold=getattr(args, "threshold", 0.7),
                            wsize=getattr(args, "wsize", 7),
                            min_image_num=getattr(args, "min_image_num", 3),
                            device=device)
        pmvs_dir = os.path.join(out_dir, "PMVS")
        use_cmvs = getattr(args, "use_cmvs", False) and programs.has("cmvs")
        if use_cmvs:
            # cluster into bounded subproblems, then per-cluster pmvs2
            _run([programs.paths["cmvs"], pmvs_dir + "/",
                  str(getattr(args, "max_cluster_size", 100))], log)
            _run([programs.paths["genOption"], pmvs_dir + "/"], log)
            options = sorted(glob.glob(os.path.join(pmvs_dir, "option-*")))
            options = [o for o in options if not o.endswith(".patch")]
            for opt in options:
                _run([programs.paths["pmvs2"], pmvs_dir + "/",
                      os.path.basename(opt)], log)
            clouds = sorted(glob.glob(
                os.path.join(pmvs_dir, "models", "option-*.ply")))
            dense = os.path.join(out_dir, "dense.ply")
            model_ops.combine_clouds(clouds, dense)
        else:
            _run([programs.paths["pmvs2"], pmvs_dir + "/",
                  "pmvs_options.txt"], log)
            produced = os.path.join(pmvs_dir, "models",
                                    "pmvs_options.txt.ply")
            dense = os.path.join(out_dir, "dense.ply")
            shutil.copy(produced, dense)
    elif method == "mve":
        programs.require("dmrecon", "scene2pset")
        ps_names = [os.path.basename(i["path"]) for i in infos]
        formats.export_mve2(out_dir, scene, images, ps_names, device=device)
        mve_scene = os.path.join(out_dir, "MVE")
        scale = getattr(args, "scale", 2)
        _run([programs.paths["dmrecon"], "-s", str(scale), mve_scene], log)
        dense = os.path.join(out_dir, "dense.ply")
        _run([programs.paths["scene2pset"], "-F", str(scale), mve_scene,
              dense], log)
    elif method == "smvs":
        programs.require("smvsrecon")
        ps_names = [os.path.basename(i["path"]) for i in infos]
        formats.export_mve2(out_dir, scene, images, ps_names, device=device)
        mve_scene = os.path.join(out_dir, "MVE")
        _run(smvs_command(programs.paths["smvsrecon"], mve_scene, args), log)
        dense = os.path.join(out_dir, "dense.ply")
        clouds = sorted(glob.glob(os.path.join(mve_scene, "smvs-*.ply")))
        if clouds:
            model_ops.combine_clouds(clouds, dense)
    else:
        raise ValueError(f"unknown densification method {method}")

    from regard3d_tpu_torch.export.ply import read_ply
    n_pts = len(read_ply(dense).xyz)
    return {"method": method, "dense_cloud": dense, "num_points": n_pts}


def run_surface(project, densification_id: int, out_dir: str, args,
                programs: Optional[ExternalPrograms] = None,
                device=None) -> Dict:
    """Surface generation + colorization: the in-process FFT Poisson
    (``tpu``) or external tools."""
    from regard3d_tpu_torch.export import model_ops

    programs = programs or ExternalPrograms()
    dobj = project.objects[densification_id]
    dense = dobj.results["dense_cloud"]
    log = os.path.join(out_dir, "surface.log")
    method = getattr(args, "method", "poisson")

    if method == "tpu":
        # in-process FFT Poisson + marching tetrahedra + density trim
        from regard3d_tpu_torch.export.ply import PlyData, read_ply, write_ply
        from regard3d_tpu_torch.surface import poisson as native_poisson

        cloud = read_ply(dense)
        if cloud.normals is None:
            raise RuntimeError(
                "surface --method tpu needs an oriented dense cloud "
                "(densify --method tpu produces normals)")
        verts, faces = native_poisson.reconstruct(
            cloud.xyz, cloud.normals,
            depth=getattr(args, "depth", 8),
            samples_per_node=getattr(args, "samples_per_node", 1.0),
            point_weight=getattr(args, "point_weight", 4.0),
            trim_threshold=getattr(args, "trim_threshold", 7.0),
            device=device)
        surf = os.path.join(out_dir, "surface.ply")
        write_ply(surf, PlyData(xyz=verts, faces=faces))
    elif method == "poisson":
        programs.require("PoissonRecon")
        raw = os.path.join(out_dir, "surface_raw.ply")
        _run([programs.paths["PoissonRecon"], "--in", dense, "--out", raw,
              "--depth", str(getattr(args, "depth", 9)),
              "--samplesPerNode", str(getattr(args, "samples_per_node", 1.0)),
              "--pointWeight", str(getattr(args, "point_weight", 4.0)),
              "--density"], log)
        surf = os.path.join(out_dir, "surface.ply")
        if programs.has("SurfaceTrimmer"):
            _run([programs.paths["SurfaceTrimmer"], "--in", raw, "--out",
                  surf, "--trim", str(getattr(args, "trim_threshold", 7.0))],
                 log)
        else:
            shutil.copy(raw, surf)
    elif method == "fssr":
        programs.require("fssrecon", "meshclean")
        raw = os.path.join(out_dir, "surface_raw.ply")
        surf = os.path.join(out_dir, "surface.ply")
        for cmd in fssr_commands(programs.paths["fssrecon"],
                                 programs.paths["meshclean"],
                                 dense, raw, surf, args):
            _run(cmd, log)
    else:
        raise ValueError(f"unknown surface method {method}")

    colorize = getattr(args, "colorize", "vertices")
    final = os.path.join(out_dir, "surface_colored.ply")
    if colorize == "vertices":
        model_ops.colorize_mesh_from_cloud(
            surf, dense, final, k=getattr(args, "color_neighbors", 3))
    elif colorize == "textures":
        tex_out = os.path.join(out_dir, "textured")
        if getattr(args, "texture_method", "tpu") == "texrecon":
            # an explicit texrecon request raises when the binary is
            # missing; only the default method runs in-process
            programs.require("texrecon")
            # texrecon needs the MVE scene from the densification step
            mve_scene = os.path.join(project._step_dir(dobj), "MVE")
            _run(texrecon_command(programs.paths["texrecon"], mve_scene,
                                  surf, tex_out, args), log)
            final = tex_out + ".obj"
        else:
            # in-process texturing (no external binaries)
            from regard3d_tpu_torch.surface.texture import \
                texture_project_mesh
            final = texture_project_mesh(project, densification_id, surf,
                                         tex_out, args, device=device)

    return {"method": method, "surface": final}
