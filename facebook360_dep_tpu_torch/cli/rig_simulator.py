"""RigSimulator equivalent: synthetic ground-truth dataset generator. The
port of ``facebook360_dep_tpu/cli/rig_simulator.py``.

Raytraces a procedurally textured scene into every rig camera on the card
and writes the project tree (color pyramid + true disparity) so the full
pipeline can be validated end to end against known depth
(rig/RigSimulator.cpp:37-64; scenes: textured sphere shell, box room, or a
triangle-mesh room with floating occluders). Optional equirect ground-truth
outputs mirror the reference's true 1/depth equirects.

    python -m facebook360_dep_tpu_torch.cli.rig_simulator --dest <root> --scene occluders \\
        --num_cameras 16 --resolution 2048 --levels 10 --eqr_width 2048
"""

from __future__ import annotations

import argparse
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import resolve_device
from ..core import camera as cam, imagetypes, io
from ..render import synthetic

log = logging.getLogger("simulator")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rig_size(rig: cam.Rig) -> tuple[int, int]:
    w, h = (int(v) for v in rig.cameras.resolution[0].tolist())
    return w, h


def _build_mode_rig(args) -> cam.Rig:
    """Rig construction per --mode (RigSimulator.cpp:724-768)."""
    res = (args.resolution, int(args.resolution * 4 / 3))  # ftheta portrait default shape
    distortion = synthetic.PRODUCTION_FTHETA_DISTORTION if args.distortion else (0.0,) * 3
    if args.mode == "pinhole_ring":
        w = args.resolution
        return synthetic.make_outward_ring_rig(args.num_cams_in_ring, (w, int(w * 0.75)), ring_radius=args.rig_radius)
    if args.mode == "ftheta_ring":
        return synthetic.make_ftheta_ring_rig(args.num_cams_in_ring, args.rig_radius, res,
                                              circle_fov_deg=args.ftheta_image_circle_fov, distortion=distortion)
    if args.mode in ("dodecahedron", "icosahedron"):
        return synthetic.make_polyhedron_rig(args.mode, args.rig_radius, res,
                                             circle_fov_deg=args.ftheta_image_circle_fov, distortion=distortion)
    if args.mode == "rig_from_json":
        assert args.rig_in or args.rig, "--rig_in is required for mode=rig_from_json"
        return cam.load_rig(args.rig_in or args.rig)
    raise SystemExit(f"unexpected mode: {args.mode}")


def _run_mode(args, dev) -> bool:
    """Reference mode dispatch; returns True when a mode fully handled the
    run (no project tree requested)."""
    half_extents = tuple(float(v) for v in args.box_half_extents.split(","))
    ew = args.eqr_width or 1024
    eh = args.eqr_height or ew // 2
    scene = args.scene if args.scene != "occluders" else "sphere"
    if args.mode == "mono_eqr":
        assert args.dest_mono and args.dest_mono_depth, \
            "--dest_mono and --dest_mono_depth are required for mono_eqr"
        ecolor, edisp = synthetic.ground_truth_equirect(None, ew, eh, scene, args.radius, half_extents, args.seed,
                                                        device=dev)
        ecolor, edisp = _np(ecolor), _np(edisp)
        io.write_color(args.dest_mono, ecolor, bit_depth=16)
        if args.dest_mono_depth.endswith(".pfm"):
            io.write_disparity(args.dest_mono_depth, edisp)
        else:
            # the reference writes invDepth * 255 as an image (RigSimulator.cpp:707)
            io.write_color(args.dest_mono_depth, np.repeat(edisp[..., None], 3, -1))
        log.info("wrote %s + %s", args.dest_mono, args.dest_mono_depth)
    elif args.mode == "stereo_eqr":
        assert args.dest_left and args.dest_right and args.dest_stereo, \
            "--dest_left/right/stereo are required for stereo_eqr"
        left, right = synthetic.render_ods_equirect(
            ew, eh, args.interpupillary_radius / 100.0,  # cm -> m, flag is cm
            scene, args.radius, half_extents, args.seed, device=dev)
        left, right = _np(left), _np(right)
        io.write_color(args.dest_left, left, bit_depth=16)
        io.write_color(args.dest_right, right, bit_depth=16)
        io.write_color(args.dest_stereo, np.concatenate([left, right], axis=0), bit_depth=16)
        log.info("wrote ODS pair %s / %s / %s", args.dest_left, args.dest_right, args.dest_stereo)
    else:
        rig = _build_mode_rig(args)
        if args.rig_out:
            os.makedirs(os.path.dirname(os.path.abspath(args.rig_out)), exist_ok=True)
            cam.save_rig(args.rig_out, rig)
            log.info("wrote rig %s (%d cameras)", args.rig_out, rig.num_cameras)
        if args.dest_cam_images:
            w, h = _rig_size(rig)
            if args.scene == "box":
                colors, _ = synthetic.render_box_scene(rig, (w, h), half_extents, seed=args.seed, device=dev)
            else:
                colors, _ = synthetic.render_sphere_scene(rig, (w, h), args.radius, seed=args.seed, device=dev)
            colors = _np(colors)
            os.makedirs(args.dest_cam_images, exist_ok=True)
            for i, cid in enumerate(rig.ids):
                io.write_color(os.path.join(args.dest_cam_images, f"{cid}.png"), colors[i], bit_depth=16)
            log.info("wrote %d camera images to %s", rig.num_cameras, args.dest_cam_images)
        if args.dest:
            args._mode_rig = rig
            return False  # continue into the project-tree flow with this rig
    return True


def pyramid_sizes(w: int, h: int, levels: int) -> list[tuple[int, int]]:
    """The simulator's pyramid: each level 2/3 of the one above, at least 4."""
    sizes = []
    for _ in range(levels):
        sizes.append((w, h))
        w, h = max(w * 2 // 3, 4), max(h * 2 // 3, 4)
    return sizes


def write_pyramids(dest, frame, cam_ids, colors: np.ndarray, sizes) -> None:
    """Each camera's colors (N, H, W, 3) area-resized to every pyramid size
    and written as PNG16 into color_levels, the cameras on a thread pool
    (the resize's numpy and the PNG's zlib release the GIL)."""
    def one(i):
        for level, (sw, sh) in enumerate(sizes):
            cdir = imagetypes.image_dir(dest, "color_levels", level, cam_ids[i])
            os.makedirs(cdir, exist_ok=True)
            img = colors[i] if (sw, sh) == colors.shape[2:0:-1] else io.resize_image(colors[i], (sw, sh))
            io.write_color(os.path.join(cdir, frame + ".png"), img, bit_depth=16)

    with ThreadPoolExecutor(max_workers=min(len(cam_ids), os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(len(cam_ids))))


def main(argv=None, *, device=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rig", default="", help="rig json (empty = built-in test ring rig)")
    p.add_argument("--dest", default="", help="output project root")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--radius", type=float, default=5.0, help="scene sphere radius (m)")
    p.add_argument("--scene", default="sphere", choices=["sphere", "box", "occluders"])
    p.add_argument("--num_occluders", type=int, default=4,
                   help="floating occluder boxes in the occluders scene")
    p.add_argument("--box_half_extents", default="6,6,3", help="box room half extents (m)")
    p.add_argument("--eqr_width", type=int, default=0,
                   help="if > 0, also write true color/disparity equirects this wide")
    p.add_argument("--eqr_height", type=int, default=0, help="equirect height (0 = width/2)")
    p.add_argument("--num_cameras", type=int, default=8, help="built-in rig size")
    p.add_argument("--resolution", type=int, default=512, help="built-in rig width")
    p.add_argument("--levels", type=int, default=4, help="pyramid levels to emit")
    p.add_argument("--seed", type=int, default=7)
    # reference mode machinery (RigSimulator.cpp:95-121,698-785)
    p.add_argument("--mode", default="", choices=[
        "", "mono_eqr", "stereo_eqr", "pinhole_ring", "ftheta_ring",
        "dodecahedron", "icosahedron", "rig_from_json"])
    p.add_argument("--rig_in", default="", help="rig json for mode=rig_from_json")
    p.add_argument("--rig_out", default="", help="write the generated rig json here")
    p.add_argument("--dest_mono", default="", help="mono equirect color path")
    p.add_argument("--dest_mono_depth", default="", help="mono 1/depth path (.pfm = exact)")
    p.add_argument("--dest_left", default="", help="ODS left-eye equirect path")
    p.add_argument("--dest_right", default="", help="ODS right-eye equirect path")
    p.add_argument("--dest_stereo", default="", help="top-bottom stereo pair path")
    p.add_argument("--dest_cam_images", default="", help="per-camera render directory")
    p.add_argument("--skybox_path", default="", help=(
        "accepted for flag parity: the analytic sphere/box scenes enclose "
        "the rig, so no ray can miss into a skybox (RigSimulator.cpp:120)"))
    p.add_argument("--num_cams_in_ring", type=int, default=14)
    p.add_argument("--rig_radius", type=float, default=0.33, help="camera ring/sphere radius (m)")
    p.add_argument("--ftheta_image_circle_fov", type=float, default=166.667)
    p.add_argument("--interpupillary_radius", type=float, default=3.2,
                   help="half IPD in cm (RigSimulator.cpp:79)")
    p.add_argument("--distortion", type=lambda v: str(v).lower() in ("1", "true"),
                   default=True, help="apply the production FTHETA distortion to generated rigs")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    if args.mode:
        if _run_mode(args, dev):
            return
    assert args.dest, "--dest is required (or use --mode with dest_* outputs)"

    if getattr(args, "_mode_rig", None) is not None:
        rig = args._mode_rig
        w, h = _rig_size(rig)
    elif args.rig:
        rig = cam.load_rig(args.rig)
        w, h = _rig_size(rig)
    else:
        w = args.resolution
        h = int(args.resolution * 0.75)
        rig = synthetic.make_test_rig(args.num_cameras, (w, h), ring_radius=0.25)

    os.makedirs(os.path.join(args.dest, "rigs"), exist_ok=True)
    cam.save_rig(os.path.join(args.dest, "rigs/rig_calibrated.json"), rig)
    sizes = pyramid_sizes(w, h, args.levels)

    half_extents = tuple(float(v) for v in args.box_half_extents.split(","))
    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        if args.scene == "occluders":
            # BVH-raytraced room + floating boxes: geometry the analytic
            # sphere/box path cannot render (BoundingVolumeHierarchy.h)
            from ..render import raytrace

            mesh = raytrace.box_room_with_occluders(room_half_extents=half_extents, seed=args.seed + f,
                                                    num_occluders=args.num_occluders)
            bvh = raytrace.build_bvh(mesh.vertices)
            colors, gt = raytrace.render_mesh_scene(rig, (w, h), mesh, bvh, device=dev)
        elif args.scene == "box":
            colors, gt = synthetic.render_box_scene(rig, (w, h), half_extents=half_extents, seed=args.seed + f,
                                                    device=dev)
        else:
            colors, gt = synthetic.render_sphere_scene(rig, (w, h), radius=args.radius, seed=args.seed + f,
                                                       device=dev)
        write_pyramids(args.dest, frame, rig.ids, _np(colors), sizes)
        del colors
        # ground-truth disparity at full res
        gt = _np(gt)
        for i, cam_id in enumerate(rig.ids):
            tdir = os.path.join(args.dest, "truth", cam_id)
            os.makedirs(tdir, exist_ok=True)
            io.write_disparity(os.path.join(tdir, frame + ".pfm"), gt[i])
        if args.eqr_width > 0:
            ew = args.eqr_width
            if args.scene == "occluders":
                ecolor, edisp = raytrace.ground_truth_equirect_mesh(mesh, ew, ew // 2, bvh, device=dev)
            else:
                ecolor, edisp = synthetic.ground_truth_equirect(rig, ew, ew // 2, args.scene, args.radius,
                                                                half_extents, args.seed + f, device=dev)
            edir = os.path.join(args.dest, "truth_eqr")
            os.makedirs(edir, exist_ok=True)
            io.write_color(os.path.join(edir, frame + "_color.png"), _np(ecolor), bit_depth=16)
            io.write_disparity(os.path.join(edir, frame + "_disparity.pfm"), _np(edisp))
        log.info("rendered frame %s (%d cameras, %d levels)", frame, len(rig.ids), args.levels)


if __name__ == "__main__":
    main()
