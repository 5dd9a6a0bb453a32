"""Generate a synthetic .bin sphere sequence for end-to-end app runs.

The bundled reference dataset ships only two frames (samples/sphere_images_
{1,10}.bin), which exercises pair registration but not the SLAM loop. This
tool ray-casts the tests/room_scene.py textured box room through the
8-sensor rig (the construction-spec extrinsics) along a closed loop trajectory and writes
reference-wire-format archives (io/boost_archive.write_frame360_bin, the
byte-compatible Frame360.h:333-345 format), so every app that consumes
sphere_images_%d.bin directories (odometry, KF odometry, both SLAM apps,
load_sequence, labelize...) can run a full multi-frame session — keyframe
selection, nearby-KF connections, loop closure on trajectory re-entry,
partitioning — with known ground-truth poses for gating.

The loop: a radius-r circle in the ground (y-z) plane around the room
centre with tangential yaw, closing after --frames steps (circumference
2*pi*r > the 6 m loop-closure trajectory-gap gate at the default r=1.1).
Two interior pillars (off the rig's path) occlude the walls differently
from different viewpoints — the empty box is visible in full from
everywhere, so without them the keyframe criterion never trips and the
whole loop tracks against one keyframe.
Ground-truth rig poses are saved alongside as poses_gt.txt (one 4x4
row-major per line).

The output directory is also a complete reference-layout data root for the
rig it was rendered with (write_nominal_data_root): the construction-spec
extrinsics, identity CLAMS depth models and the matcher configuration, so
every app runs on it with `--calib-root <out>` and nothing outside the
repository.

Usage: python tools/make_synthetic_sequence.py --out <dir>
           [--frames 40] [--radius 1.1] [--start 1]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def loop_pose(theta: float, radius: float, center=(0.0, 0.6, -0.3)) -> np.ndarray:
    """Rig pose on the circle: position on the ring, yawed about the
    vertical (x) axis so the rig turns with the tangent."""
    cx, cy, cz = center
    pose = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    # yaw about x (the sphere convention's vertical: Frame360.h:589-592)
    pose[1, 1], pose[1, 2] = c, -s
    pose[2, 1], pose[2, 2] = s, c
    pose[1, 3] = cy + radius * np.sin(theta)
    pose[2, 3] = cz + radius * (np.cos(theta) - 1.0)
    pose[0, 3] = cx
    return pose


def write_nominal_data_root(root: str) -> None:
    """Write a reference-layout data root for the ideal rig:
    Calibration/Extrinsics/Rt_0{1..8}.txt from the construction specs
    (core/calibrator.construction_specs), identity CLAMS models in
    Calibration/Intrinsics/distortion_model{1..8}, and
    config_files/configLocaliser_sphericalOdometry.ini with the
    MatcherConfig defaults."""
    from rgbd360_tpu.core.calibrator import construction_specs
    from rgbd360_tpu.core.matcher import MatcherConfig
    from rgbd360_tpu.io.clams import identity_clams_model, write_clams_model

    ext = os.path.join(root, "Calibration", "Extrinsics")
    intr = os.path.join(root, "Calibration", "Intrinsics")
    cfg = os.path.join(root, "config_files")
    for d in (ext, intr, cfg):
        os.makedirs(d, exist_ok=True)
    model = identity_clams_model()
    for s, rt in enumerate(construction_specs()):
        np.savetxt(os.path.join(ext, f"Rt_0{s + 1}.txt"), rt, fmt="%.9g")
        write_clams_model(os.path.join(intr, f"distortion_model{s + 1}"), model)
    MatcherConfig().to_ini(os.path.join(cfg, "configLocaliser_sphericalOdometry.ini"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--loops", type=float, default=1.0,
                    help="total turns around the circle (e.g. 1.4 revisits "
                         "the start with >6 m trajectory gap, triggering the "
                         "loop-closure gates)")
    ap.add_argument("--radius", type=float, default=1.1)
    ap.add_argument("--start", type=int, default=1, help="first frame number")
    args = ap.parse_args(argv)

    from room_scene import raycast_room_sensor

    # pillars clear of the default radius-1.1 circle around (y,z)=(0.6,-0.3)
    obstacles = (
        (-1.5, 0.5, 2.0, 2.6, -2.2, -1.6),
        (-1.5, 0.5, -1.8, -1.2, -1.4, -0.8),
    )

    from rgbd360_tpu.io.boost_archive import RawFrame360, write_frame360_bin
    from rgbd360_tpu.io.calib import Calib360

    write_nominal_data_root(args.out)
    calib = Calib360.load(args.out)

    poses = []
    for i in range(args.frames):
        theta = 2.0 * np.pi * args.loops * i / args.frames
        pose = loop_pose(theta, args.radius)
        poses.append(pose)
        rgbs, depths = [], []
        for s in range(8):
            rt = pose @ np.asarray(calib.Rt[s], np.float64)
            rgb, depth = raycast_room_sensor(rt, obstacles=obstacles)
            rgbs.append(rgb)
            depths.append(depth)
        raw = RawFrame360(
            rgb=np.stack(rgbs), depth=np.stack(depths),
            timestamp=10_000_000 * (i + 1),
        )
        path = os.path.join(args.out, f"sphere_images_{args.start + i}.bin")
        write_frame360_bin(path, raw)
        print(f"{path}  |t|={np.linalg.norm(pose[:3, 3]):.3f}")

    with open(os.path.join(args.out, "poses_gt.txt"), "w") as f:
        for pose in poses:
            f.write(" ".join(f"{v:.9g}" for v in pose.ravel()) + "\n")
    print(f"{args.frames} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
