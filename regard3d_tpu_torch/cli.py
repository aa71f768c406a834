"""Command-line interface — the controller surface replacing the wx GUI.

Counterpart of ``regard3d_tpu/cli.py``: the same subcommands, options,
defaults and project store, so a project written by either CLI loads in the
other. One top-level option more, ``--device`` (default ``cuda``), passed to
every driver; the compute subcommands (matches, sfm, export, densify,
surface) raise with no card unless ``--device cpu`` is given, and
``project.json`` never records the device. ``--profile DIR`` writes a
``torch.profiler`` Chrome trace (``DIR/trace.json``): on a card, its
kernels, copies and launch calls, as a JAX trace holds the device's work
and the runtime's dispatch (on the CPU, the operators). ``launch -n N --
<subcommand>`` runs a subcommand in N coordinated processes
(``dist/launch.py``): ``matches`` shards its work over them, ``sfm
--dist-ba`` shards its final bundle adjustment, and secondaries skip every
other subcommand; only the primary writes the project.

Maps the reference's GUI workflow (``Regard3DMainFrame`` orchestration
methods: addComputeMatches / triangulate / createDensePointcloud /
createSurface / export*, src/Regard3DMainFrame.h:80-186) onto subcommands:

    r3d init <dir>                       create a project
    r3d import <dir> <images...>         add a picture set (EXIF+sensor DB)
    r3d matches <dir> [options]          feature extraction + matching
    r3d sfm <dir> [options]              triangulation (incremental/global)
    r3d export <dir> --format ...        exporter menu
    r3d densify <dir> [options]          dense MVS: in-process plane sweep
                                         (--method tpu) or external tools
                                         (CMVS/PMVS, MVE, SMVS)
    r3d surface <dir> [options]          external surface + texturing
    r3d info <dir>                       show the project tree
    r3d launch -n N -- <subcommand> ...  N coordinated processes

Run ``python -m regard3d_tpu_torch.cli --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# subcommands that run the port's torch code: they resolve --device first
COMPUTE_COMMANDS = ("matches", "sfm", "export", "densify", "surface")


def _params(args):
    """JSON-safe copy of the argparse namespace for the project store (the
    device is left out, so projects stay interchangeable)."""
    return {k: v for k, v in vars(args).items()
            if k not in ("fn", "project", "device")
            and isinstance(v, (str, int, float, bool, list, type(None)))}


def _progress(label):
    def cb(done, total):
        sys.stderr.write(f"\r{label}: {done}/{total}    ")
        sys.stderr.flush()
        if done == total:
            sys.stderr.write("\n")
    return cb


def cmd_init(args):
    from regard3d_tpu_torch.pipeline.project import Project
    Project.create(args.project)
    print(f"created project at {args.project}")


def cmd_import(args):
    from regard3d_tpu_torch.ingest import exif as exif_mod, intrinsics, sensor_db
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    infos = []
    udb = None
    if args.user_camera_db:
        udb = sensor_db.UserCameraDB(args.user_camera_db)
    sdb = sensor_db.SensorDB(args.sensor_db)
    for path in args.images:
        info = exif_mod.read_exif(path)
        width_mm = sensor_db.lookup_sensor_width(info.maker, info.model,
                                                 udb, sdb)
        vi = intrinsics.focal_prior(info, width_mm)
        infos.append({
            "path": os.path.abspath(path), "width": info.width,
            "height": info.height, "maker": info.maker, "model": info.model,
            "focal_mm": info.focal_length_mm, "sensor_width_mm": width_mm,
            "focal_px": vi.focal_px, "from_exif": vi.from_exif,
            "gps": ([info.latitude, info.longitude, info.altitude]
                    if info.has_gps else None),
        })
    ps = p.add_picture_set(args.name, [i["path"] for i in infos])
    ps.params["image_info"] = infos
    p.save()
    n_exif = sum(1 for i in infos if i["from_exif"])
    print(f"picture set {ps.id}: {len(infos)} images "
          f"({n_exif} with EXIF focal priors)")


def _load_pictureset(p, ps_id=None):
    sets = [o for o in p.objects.values() if o.kind == "pictureset"]
    if not sets:
        raise SystemExit("no picture set — run `import` first")
    ps = p.objects[ps_id] if ps_id is not None else sets[-1]
    infos = ps.params["image_info"]
    from regard3d_tpu_torch.ingest import image_io
    images = [image_io.load_gray(i["path"]) for i in infos]
    return ps, infos, images


def _pick(p, kind, obj_id=None):
    """Select a pipeline object: explicit id, else the last finished one
    (the GUI lets any tree node be selected; --id is the CLI equivalent)."""
    if obj_id is not None:
        o = p.objects.get(obj_id)
        if o is None or o.kind != kind:
            raise SystemExit(f"no {kind} object with id {obj_id}")
        return o
    objs = [o for o in p.objects.values() if o.kind == kind
            and o.state == "finished"]
    if not objs:
        raise SystemExit(f"no finished {kind} step")
    return objs[-1]


def cmd_delete(args):
    """Delete a pipeline object and its whole subtree (the GUI's
    delete-object action; files under the step dirs are removed)."""
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    if args.id not in p.objects:
        raise SystemExit(f"no object with id {args.id}")
    kind = p.objects[args.id].kind
    p.remove(args.id, delete_files=not args.keep_files)
    p.save()
    print(f"deleted {kind} [{args.id}] and its subtree")


def _handshake_out_dir(project_dir: str, token: str) -> str:
    """A secondary's wait for the primary's token-stamped handshake, which
    names the step directory of a multi-process ``matches``."""
    from regard3d_tpu_torch.dist import launch as launch_mod
    hs = os.path.join(project_dir, ".matches_handshake")
    deadline = time.time() + min(600.0, launch_mod.timeout_s())
    while True:
        try:
            with open(hs) as fh:
                d = json.load(fh)
            if d.get("token") == token:
                return d["out_dir"]
        except (OSError, ValueError):
            pass
        if time.time() > deadline:
            raise TimeoutError("no matches handshake from the primary")
        time.sleep(0.5)


def cmd_matches(args):
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline.features import SENSITIVITY_PRESETS
    from regard3d_tpu_torch.pipeline.project import Project
    # multi-process matching (r3d launch -n N -- matches): the primary owns
    # every project mutation; secondaries learn the step directory from a
    # token-stamped handshake file and work on their shards
    proc_count = int(os.environ.get("R3D_NUM_PROCESSES", "1"))
    proc_id = int(os.environ.get("R3D_PROCESS_ID", "0"))
    token = os.environ.get("R3D_COORDINATOR", "local")
    p = Project.load(args.project)
    if proc_id == 0:
        ps, infos, images = _load_pictureset(p)
        obj = p.add_compute_matches(ps.id, _params(args))
        out_dir = p.prepare(obj.id)
        if proc_count > 1:
            with open(os.path.join(args.project, ".matches_handshake"),
                      "w") as fh:
                json.dump({"token": token, "out_dir": out_dir}, fh)
    else:
        out_dir = _handshake_out_dir(args.project, token)
        p = Project.load(args.project)
        _, infos, images = _load_pictureset(p)
    t0 = time.time()
    try:
        thr = SENSITIVITY_PRESETS.get(args.sensitivity, 0.0007)
        focals = np.asarray([i["focal_px"] for i in infos])
        stats = cm.run_compute_matches(
            images, out_dir, threshold=thr,
            cfg=cm.MatchConfig(ratio=args.ratio, matcher=args.matcher,
                               mutual=args.mutual,
                               ransac_iters=args.ransac_iters),
            focals=focals, max_keypoints=args.max_keypoints,
            detector=args.detector,
            progress=_progress("matching"),
            pairs=(cm.sequential_pairs(len(images), args.window)
                   if args.window else None),
            retrieval_k=args.retrieval_k, device=args.device,
            proc_id=proc_id, proc_count=proc_count)
    except Exception as e:
        if proc_id == 0:
            p.fail(obj.id, str(e))
        raise
    if proc_id == 0:
        p.finish(obj.id, stats, time.time() - t0)
    print(json.dumps(stats, indent=1, default=str))


def cmd_sfm(args):
    from regard3d_tpu_torch.core.types import CAMERA_MODEL_CODES
    from regard3d_tpu_torch.ingest import intrinsics as intr_mod
    from regard3d_tpu_torch.pipeline import triangulation_step as ts
    from regard3d_tpu_torch.pipeline.project import Project
    initial_pair = None
    if args.initial_pair:
        a, b = args.initial_pair.split(",")
        initial_pair = (int(a), int(b))
    params = ts.TriangulationParams(
        engine=args.engine, initial_pair=initial_pair,
        initializer=args.initializer,
        rotation_averaging=args.rotation_averaging,
        translation_averaging=args.translation_averaging,
        refine_intrinsics=not args.no_refine_intrinsics,
        use_gps=args.use_gps, f64=args.f64, dist_ba=args.dist_ba)
    from regard3d_tpu_torch.dist import launch as launch_mod
    primary = launch_mod.is_primary()
    p = Project.load(args.project)
    mobj = _pick(p, "matches", args.id)
    ps, infos, images = _load_pictureset(p, mobj.parent_id)

    model_code = CAMERA_MODEL_CODES[args.camera_model]
    views = [intr_mod.ViewIntrinsics(i["focal_px"], i["width"], i["height"],
                                     model_code, i["from_exif"])
             for i in infos]
    intr_id, intr, models, widths, heights = intr_mod.build_intrinsics(
        views, model_code)

    if not primary:
        # secondaries take part in the collective compute only: no project
        # mutation, their artifacts in a directory that is then removed
        import tempfile
        with tempfile.TemporaryDirectory(prefix="r3d_secondary_") as out:
            ts.run_triangulation(
                p.paths(mobj.id).matches_dir, out, images, intr_id, intr,
                models, params=params, center_priors=_center_priors(
                    args, infos), device=args.device, write_artifacts=False)
        return
    obj = p.add_triangulation(mobj.id, _params(args))
    out_dir = p.prepare(obj.id)
    t0 = time.time()
    try:
        stats = ts.run_triangulation(
            p.paths(mobj.id).matches_dir, out_dir, images,
            intr_id, intr, models, params=params,
            image_names=[os.path.basename(i["path"]) for i in infos],
            center_priors=_center_priors(args, infos), device=args.device)
    except Exception as e:
        p.fail(obj.id, str(e))
        raise
    p.finish(obj.id, stats, time.time() - t0)
    print(json.dumps(stats, indent=1, default=str))


def _center_priors(args, infos):
    """GPS centre priors in a local ENU frame with ``--use-gps`` (None
    without it, or with fewer than three GPS images)."""
    if not args.use_gps:
        return None
    from regard3d_tpu_torch.ingest import geodesy
    gps = [i.get("gps") for i in infos]
    if sum(g is not None for g in gps) < 3:
        print("warning: <3 images carry GPS; ignoring --use-gps",
              file=sys.stderr)
        return None
    ecef = np.asarray([geodesy.lla_to_ecef(*g) if g is not None
                       else (np.nan,) * 3 for g in gps])
    valid = np.isfinite(ecef).all(1)
    local, origin, Renu = geodesy.local_enu_frame(ecef[valid])
    center_priors = np.full((len(gps), 3), np.nan)
    center_priors[valid] = local
    return center_priors


def cmd_export(args):
    from regard3d_tpu_torch.core import sfm_data
    from regard3d_tpu_torch.export import formats
    from regard3d_tpu_torch.ingest import image_io
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    tobj = _pick(p, "triangulation", args.id)
    scene = sfm_data.load_npz(p.paths(tobj.id).scene_npz)
    ps, infos, _ = _load_pictureset(
        p, p.objects[tobj.parent_id].parent_id)
    names = [os.path.basename(i["path"]) for i in infos]
    out = args.out or os.path.join(p.project_dir, f"export_{args.format}")
    os.makedirs(out, exist_ok=True)
    if args.format in ("pmvs", "bundler", "mve", "meshlab", "sfmoutput",
                       "externalmvs"):
        images = [image_io.load_rgb(i["path"]) for i in infos]
    if args.format == "bundler":
        formats.export_bundler(out, scene, names)
    elif args.format == "pmvs":
        formats.export_bundler(out, scene, names)
        formats.export_pmvs(out, scene, images, device=args.device)
    elif args.format == "nvm":
        formats.export_nvm(os.path.join(out, "scene.nvm"), scene, names)
    elif args.format == "mvstexturing":
        formats.export_mvs_texturing(out, scene, names)
    elif args.format == "meshlab":
        formats.export_meshlab(out, scene, [i["path"] for i in infos])
    elif args.format == "mve":
        formats.export_mve2(out, scene, images, names, device=args.device)
    elif args.format == "openmvs":
        from regard3d_tpu_torch.export import openmvs
        openmvs.export_openmvs(os.path.join(out, "scene.mvs"), scene, names)
    elif args.format == "sfmoutput":
        from regard3d_tpu_torch.export import sfm_output
        sfm_output.export_sfm_output(os.path.join(out, "SfM_output"),
                                     scene, images, names, device=args.device)
    elif args.format == "externalmvs":
        from regard3d_tpu_torch.export import external_mvs
        external_mvs.export_external_mvs(out, scene, images, names,
                                         device=args.device)
    else:
        raise SystemExit(f"unknown format {args.format}")
    print(f"exported {args.format} to {out}")


def cmd_densify(args):
    from regard3d_tpu_torch.pipeline import external
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    tobj = _pick(p, "triangulation", args.id)
    obj = p.add_densification(tobj.id, _params(args))
    out_dir = p.prepare(obj.id)
    t0 = time.time()
    try:
        stats = external.run_densification(p, tobj.id, out_dir, args,
                                           device=args.device)
    except Exception as e:
        p.fail(obj.id, str(e))
        raise
    p.finish(obj.id, stats, time.time() - t0)
    print(json.dumps(stats, indent=1, default=str))


def cmd_surface(args):
    from regard3d_tpu_torch.pipeline import external
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    dobj = _pick(p, "densification", args.id)
    obj = p.add_surface(dobj.id, _params(args))
    out_dir = p.prepare(obj.id)
    t0 = time.time()
    try:
        stats = external.run_surface(p, dobj.id, out_dir, args,
                                     device=args.device)
    except Exception as e:
        p.fail(obj.id, str(e))
        raise
    p.finish(obj.id, stats, time.time() - t0)
    print(json.dumps(stats, indent=1, default=str))


def cmd_preview(args):
    """Keypoint / match preview images + SVGs (MatchingResults dialog
    parity)."""
    from regard3d_tpu_torch.ingest import image_io
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline import features as fm, preview
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    mobj = _pick(p, "matches", args.id)
    ps, infos, images = _load_pictureset(p, mobj.parent_id)
    mdir = p.paths(mobj.id).matches_dir
    out = args.out or os.path.join(p.project_dir, "previews")
    os.makedirs(out, exist_ok=True)

    if args.pair:
        a, b = (int(x) for x in args.pair.split(","))
        xy1, s1, an1, _ = fm.load_features(mdir, a)
        xy2, s2, an2, _ = fm.load_features(mdir, b)
        matches = cm.load_matches_txt(os.path.join(
            mdir, f"matches.{args.kind}.txt")).get((a, b))
        if matches is None:
            raise SystemExit(f"no matches for pair {a},{b}")
        im = preview.draw_matches(images[a], xy1, images[b], xy2, matches)
        path = os.path.join(out, f"matches_{a}_{b}_{args.kind}.png")
        im.save(path)
        print(f"wrote {path} ({len(matches)} matches)")
    else:
        v = args.view
        xy, sc, an, _ = fm.load_features(mdir, v)
        im = preview.draw_keypoints(images[v], xy, sc, an, rich=args.rich)
        path = os.path.join(out, f"keypoints_{v}.png")
        im.save(path)
        svg = os.path.join(out, f"keypoints_{v}.svg")
        preview.keypoints_svg(svg, infos[v]["path"], infos[v]["width"],
                              infos[v]["height"], xy, sc)
        print(f"wrote {path} + {svg} ({len(xy)} keypoints)")


def cmd_pairs(args):
    """Best validated pairs, ranked — the initial-pair list the reference's
    triangulation dialog shows (OpenMVGHelper::getBestValidatedPairs,
    src/utils/OpenMVGHelper.cpp:273-419)."""
    from regard3d_tpu_torch.pipeline import compute_matches as cm
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    mobj = _pick(p, "matches", args.id)
    ps = p.objects[mobj.parent_id]
    names = [os.path.basename(i["path"])
             for i in ps.params.get("image_info", [])]
    rows = cm.best_validated_pairs(p.paths(mobj.id).matches_dir,
                                   kind=args.kind, limit=args.limit)
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print(f"{'rank':>4} {'i':>4} {'j':>4} {'geom':>6} {'putat':>6} "
          f"{'surv':>6}  images")
    for r, row in enumerate(rows):
        label = ""
        if names:
            label = (f"{names[row['i']]} <-> {names[row['j']]}"
                     if row["i"] < len(names) and row["j"] < len(names)
                     else "")
        print(f"{r:>4} {row['i']:>4} {row['j']:>4} {row['geometric']:>6} "
              f"{row['putative']:>6} {row['survival']:>6.2f}  {label}")


def cmd_launch(args):
    """``r3d launch -n N -- <subcommand> ...``: the subcommand in N
    coordinated processes (``dist/launch.py``). The children take this
    command's ``--device`` unless their arguments give one; a compute
    subcommand's device is resolved before any process starts. A failed
    rank stops the others; every wait of a rank is bounded by
    ``R3D_DIST_TIMEOUT_S``."""
    from regard3d_tpu_torch import runtime
    from regard3d_tpu_torch.dist import launch as launch_mod
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if not rest:
        raise SystemExit("usage: r3d launch -n N -- <subcommand> [args...]")
    if not (rest[0] == "--device" or rest[0].startswith("--device=")):
        rest = ["--device", args.device] + rest
    child = build_parser().parse_args(rest)
    if child.cmd in COMPUTE_COMMANDS:
        runtime.resolve_device(child.device)     # raises with no card
    sys.exit(launch_mod.launch_local(
        args.num_processes, rest,
        devices_per_process=args.devices_per_process,
        log_dir=args.log_dir))


def cmd_camera_db(args):
    """User camera DB management (UserCameraDB dialog parity)."""
    from regard3d_tpu_torch.ingest.sensor_db import UserCameraDB
    from regard3d_tpu_torch.pipeline.settings import Settings
    path = args.db or Settings().get("user_camera_db_path") or os.path.join(
        os.path.expanduser("~"), ".config", "regard3d_tpu", "user_cameras.db")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    db = UserCameraDB(path)
    if args.action == "list":
        for maker, model, width in db.all_entries():
            print(f"{maker};{model};{width}")
    elif args.action == "add":
        db.add(args.maker, args.model, args.sensor_width)
        print(f"added {args.maker} {args.model} = {args.sensor_width} mm")
    elif args.action == "remove":
        db.remove(args.maker, args.model)
        print(f"removed {args.maker} {args.model}")
    db.close()


def cmd_image_info(args):
    """Per-image EXIF + sensor-DB report (ImageInfoThread parity)."""
    from regard3d_tpu_torch.ingest import exif as exif_mod, geodesy, sensor_db
    sdb = sensor_db.SensorDB(args.sensor_db)
    for path in args.images:
        info = exif_mod.read_exif(path)
        w = sensor_db.lookup_sensor_width(info.maker, info.model,
                                          sensor_db=sdb)
        line = (f"{os.path.basename(path)}: {info.width}x{info.height} "
                f"maker='{info.maker}' model='{info.model}' "
                f"focal={info.focal_length_mm}mm sensor_width="
                f"{w if w else 'unknown'}")
        if info.has_gps:
            x, y, z = geodesy.lla_to_ecef(info.latitude, info.longitude,
                                          info.altitude)
            line += (f" gps=({info.latitude:.6f},{info.longitude:.6f},"
                     f"{info.altitude:.1f}) ecef=({x:.1f},{y:.1f},{z:.1f})")
        print(line)


def cmd_info(args):
    from regard3d_tpu_torch.pipeline.project import Project
    p = Project.load(args.project)
    for o in sorted(p.objects.values(), key=lambda o: o.id):
        depth = len(p.ancestors(o.id))
        extra = ""
        if o.kind == "pictureset":
            extra = f" ({len(p.image_lists.get(o.id, []))} images)"
        print("  " * depth + f"[{o.id}] {o.kind}{extra} — {o.state}"
              + (f" ({o.running_time_s:.1f}s)" if o.running_time_s else ""))


def build_parser():
    ap = argparse.ArgumentParser(prog="r3d",
                                 description="SfM pipeline on PyTorch/CUDA")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every compute step (cuda; cpu "
                         "runs the plain PyTorch path)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("init")
    s.add_argument("project")
    s.set_defaults(fn=cmd_init)

    s = sub.add_parser("import")
    s.add_argument("project")
    s.add_argument("images", nargs="+")
    s.add_argument("--name", default="pictures")
    s.add_argument("--sensor-db", default=None)
    s.add_argument("--user-camera-db", default=None)
    s.set_defaults(fn=cmd_import)

    s = sub.add_parser("matches")
    s.add_argument("project")
    s.add_argument("--sensitivity", default="normal",
                   choices=["minimal", "normal", "high", "ultra"])
    s.add_argument("--detector", default="fast-akaze",
                   help="fast-akaze | akaze | gftt | orb | brisk | mser | "
                        "tbmr (GUI menu + experimental code paths, "
                        "src/Regard3DFeatures.cpp:574-683)")
    s.add_argument("--ratio", type=float, default=0.8,
                   help="NN ratio test (GUI presets 0.6/0.7/0.8/0.9)")
    s.add_argument("--matcher", default="brute-force",
                   help="matcher menu preset (FLANN/KGraph/BF/MRPT/HNSW "
                        "names accepted); fast presets select the bf16 "
                        "tensor-core kernel, precise presets f32")
    s.add_argument("--mutual", action="store_true",
                   help="cross-check: keep only mutual nearest neighbours")
    s.add_argument("--max-keypoints", type=int, default=4096)
    s.add_argument("--ransac-iters", type=int, default=1024)
    s.add_argument("--window", type=int, default=0,
                   help="sequential pair pruning: pair each view with its "
                        "next N successors instead of exhaustively "
                        "(ordered captures at large view counts)")
    s.add_argument("--retrieval-k", type=int, default=0,
                   help="with --window: add each image's top-K most "
                        "similar images (pooled-descriptor retrieval) as "
                        "pairs — recovers loop closures a window misses")
    s.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace "
                        "(trace.json) to this directory")
    s.set_defaults(fn=cmd_matches)

    s = sub.add_parser("sfm")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--engine", default="incremental2",
                   choices=["incremental", "incremental2", "global"])
    s.add_argument("--initial-pair", default=None,
                   help="view ids 'a,b' (incremental v1)")
    s.add_argument("--initializer", default="maxpair",
                   choices=["maxpair", "stellar"])
    s.add_argument("--camera-model", default="radial_k3",
                   choices=["pinhole", "radial_k1", "radial_k3",
                            "brown_t2", "fisheye"])
    s.add_argument("--rotation-averaging", default="l2",
                   choices=["l1", "l2"])
    s.add_argument("--translation-averaging", default="softl1",
                   choices=["l1", "l2_chordal", "softl1"])
    s.add_argument("--no-refine-intrinsics", action="store_true")
    s.add_argument("--f64", action="store_true",
                   help="run triangulation + BA in float64 (Ceres runs "
                        "double; use for ATE-parity experiments)")
    s.add_argument("--use-gps", action="store_true",
                   help="anchor the reconstruction to EXIF GPS priors")
    s.add_argument("--dist-ba", action="store_true",
                   help="final BA sharded over ALL devices/processes "
                        "(run under `r3d launch -n N -- sfm ... --dist-ba`)")
    s.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace "
                        "(trace.json) to this directory")
    s.set_defaults(fn=cmd_sfm)

    s = sub.add_parser("export")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--format", required=True,
                   choices=["bundler", "pmvs", "nvm", "meshlab", "mve",
                            "openmvs", "sfmoutput", "externalmvs",
                            "mvstexturing"])
    s.add_argument("--out", default=None)
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("densify")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--method", default="pmvs",
                   choices=["pmvs", "mve", "smvs", "tpu"])
    s.add_argument("--level", type=int, default=1)
    s.add_argument("--num-planes", type=int, default=96,
                   help="depth hypotheses (tpu plane sweep)")
    s.add_argument("--num-sources", type=int, default=6,
                   help="source views per reference view (tpu)")
    s.add_argument("--csize", type=int, default=2)
    s.add_argument("--threshold", type=float, default=0.7)
    s.add_argument("--wsize", type=int, default=7)
    s.add_argument("--min-image-num", type=int, default=3)
    s.add_argument("--use-cmvs", action="store_true")
    s.add_argument("--max-cluster-size", type=int, default=100)
    s.add_argument("--scale", type=int, default=2, help="MVE scale")
    # SMVS menu (src/R3DProject.h:201-213, R3DDensificationProcess.cpp:171)
    s.add_argument("--input-scale", type=int, default=2,
                   help="SMVS input scale")
    s.add_argument("--output-scale", type=int, default=2,
                   help="SMVS output scale")
    s.add_argument("--shading", action="store_true",
                   help="SMVS shading-based optimization (-S)")
    s.add_argument("--no-sgm", dest="sgm", action="store_false",
                   help="disable SMVS semi-global matching")
    s.add_argument("--alpha", type=float, default=1.0,
                   help="SMVS surface smoothing factor (--alpha)")
    s.set_defaults(fn=cmd_densify)

    s = sub.add_parser("surface")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--method", default="poisson",
                   choices=["poisson", "fssr", "tpu"])
    s.add_argument("--depth", type=int, default=9)
    s.add_argument("--samples-per-node", type=float, default=1.0)
    s.add_argument("--point-weight", type=float, default=4.0)
    s.add_argument("--trim-threshold", type=float, default=7.0)
    # FSSR menu (src/R3DProject.h:155-170, R3DSurfaceGenProcess.cpp:152-161)
    s.add_argument("--scale-factor", type=float, default=1.0,
                   help="FSSR scale factor multiplier")
    s.add_argument("--refine-octree-levels", type=int, default=0,
                   help="FSSR octree refinement levels")
    s.add_argument("--conf-threshold", type=float, default=1.0,
                   help="FSSR meshclean confidence threshold")
    s.add_argument("--min-component-size", type=int, default=1000,
                   help="FSSR meshclean minimum component size")
    s.add_argument("--colorize", default="vertices",
                   choices=["vertices", "textures"])
    s.add_argument("--color-neighbors", type=int, default=3)
    # texturing (reference: texrecon flags, src/R3DSurfaceGenProcess.cpp:172)
    s.add_argument("--texture-method", default="tpu",
                   choices=["tpu", "texrecon"])
    s.add_argument("--texel-res", type=int, default=8)
    s.add_argument("--outlier-removal", default="gauss_damping",
                   choices=["none", "gauss_clamping", "gauss_damping"])
    s.add_argument("--seam-leveling", default="global",
                   choices=["none", "global"])
    s.add_argument("--no-visibility-test", dest="visibility_test",
                   action="store_false",
                   help="skip the geometric visibility test (texrecon)")
    s.add_argument("--no-local-seam-leveling", dest="local_seam_leveling",
                   action="store_false",
                   help="skip local seam leveling (texrecon)")
    s.set_defaults(fn=cmd_surface)

    s = sub.add_parser("info")
    s.add_argument("project")
    s.set_defaults(fn=cmd_info)

    s = sub.add_parser("delete")
    s.add_argument("project")
    s.add_argument("id", type=int)
    s.add_argument("--keep-files", action="store_true")
    s.set_defaults(fn=cmd_delete)

    s = sub.add_parser("preview")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--view", type=int, default=0)
    s.add_argument("--pair", default=None, help="view ids 'a,b'")
    s.add_argument("--kind", default="putative",
                   choices=["putative", "f", "e", "h"])
    s.add_argument("--rich", action="store_true", default=True)
    s.add_argument("--out", default=None)
    s.set_defaults(fn=cmd_preview)

    s = sub.add_parser("launch")
    s.add_argument("-n", "--num-processes", type=int, default=2)
    s.add_argument("--devices-per-process", type=int, default=1)
    s.add_argument("--log-dir", default=None)
    s.add_argument("rest", nargs=argparse.REMAINDER,
                   help="r3d subcommand + args to run in every process")
    s.set_defaults(fn=cmd_launch)

    s = sub.add_parser("pairs")
    s.add_argument("project")
    s.add_argument("--id", type=int, default=None,
                   help="explicit parent step id (default: last finished)")
    s.add_argument("--kind", default="f", choices=["putative", "f", "e", "h"])
    s.add_argument("--limit", type=int, default=20)
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_pairs)

    s = sub.add_parser("camera-db")
    s.add_argument("action", choices=["list", "add", "remove"])
    s.add_argument("--maker", default="")
    s.add_argument("--model", default="")
    s.add_argument("--sensor-width", type=float, default=0.0)
    s.add_argument("--db", default=None)
    s.set_defaults(fn=cmd_camera_db)

    s = sub.add_parser("image-info")
    s.add_argument("images", nargs="+")
    s.add_argument("--sensor-db", default=None)
    s.set_defaults(fn=cmd_image_info)
    return ap


def main(argv=None):
    from regard3d_tpu_torch.dist import launch as launch_mod
    multiproc = launch_mod.init_from_env()     # join a multi-process job
    args = build_parser().parse_args(argv)
    # cross-process subcommands: `sfm` (the --dist-ba collective polish)
    # and `matches` (sharded, merged on the primary); every other one would
    # race on the same artifact files, so secondaries skip it
    if (multiproc and not launch_mod.is_primary()
            and args.cmd not in ("sfm", "matches")):
        print(f"r3d: secondary process skipping non-distributed "
              f"subcommand {args.cmd!r}", file=sys.stderr)
        return
    if args.cmd in COMPUTE_COMMANDS:
        from regard3d_tpu_torch import runtime
        runtime.resolve_device(args.device)     # raises with no card
    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        import torch
        # on a card, the operator events of the filter's ~800k operations
        # would dominate the trace's size and the time to record it
        acts = ([ProfilerActivity.CUDA]
                if torch.device(args.device).type == "cuda"
                else [ProfilerActivity.CPU])
        with profile(activities=acts) as prof:
            args.fn(args)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"profiler trace written to {profile_dir}", file=sys.stderr)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
