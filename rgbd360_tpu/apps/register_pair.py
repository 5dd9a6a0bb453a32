"""RegisterPairRGBD360 — align two spherical .bin frames
(reference Registration/RegisterPairRGBD360.cpp:56-171): PbMap match, then
dense Photo+ICP refinement (the reference uses GICP; the dense spherical
aligner is the accelerator-side superset), artifact dumps instead of the PCL viewer.

Usage: python -m rgbd360_tpu.apps.register_pair <a.bin> <b.bin> [--out DIR]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rgbd360_tpu.apps.common import default_matcher_config, load_calib, rot_offset
from rgbd360_tpu.core.frame360 import Frame360
from rgbd360_tpu.core.matcher import PLANAR_3DOF
from rgbd360_tpu.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_tpu.core.register_rgbd360 import RegisterRGBD360


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("frame1")
    ap.add_argument("frame2")
    ap.add_argument("--out", default=None, help="artifact output dir")
    ap.add_argument("--calib-root", default=None)
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    f1 = Frame360(calib, 0).build(args.frame1)
    f2 = Frame360(calib, 1).build(args.frame2)
    f1.get_planes()
    f2.get_planes()
    print(f"planes: {len(f1.planes)} / {len(f2.planes)}")

    registerer = RegisterRGBD360(default_matcher_config(args.calib_root))
    ok = registerer.register_pbmap(f1, f2, 25, PLANAR_3DOF)
    np.set_printoptions(suppress=True, precision=5)
    if ok:
        print(f"PbMap matches: {registerer.get_matched_planes()} "
              f"area {registerer.get_area_matched():.2f}")
        print("PbMap pose:\n", registerer.get_pose())
    else:
        print("PbMap registration failed; dense alignment from identity")

    aligner = RegisterPhotoICP(n_pyr_levels=5)
    aligner.set_target_frame(f1.sphere_rgb, f1.sphere_depth_mm)
    aligner.set_source_frame(f2.sphere_rgb, f2.sphere_depth_mm)
    off = rot_offset()
    guess = (off @ registerer.get_pose().astype(np.float64) @ np.linalg.inv(off)) if ok else np.eye(4)
    aligner.align_frames360(guess.astype(np.float32), PHOTO_DEPTH)
    pose_cloud = np.linalg.inv(off) @ aligner.get_optimal_pose().astype(np.float64) @ off
    print("Dense pose (cloud frame):\n", pose_cloud)
    print(f"residuals photo {aligner.av_photo_residual:.4f} depth "
          f"{aligner.av_depth_residual:.4f} SSO {aligner.sso:.4f} "
          f"entropy {aligner.calc_entropy():.2f}")

    if args.out:
        import os

        from rgbd360_tpu.utils.viz import save_ply, save_sphere_images

        os.makedirs(args.out, exist_ok=True)
        save_sphere_images(f1, args.out, "frame1")
        save_sphere_images(f2, args.out, "frame2")
        xyz1, rgb1 = f1.build_sphere_cloud_from_image()
        xyz2, rgb2 = f2.build_sphere_cloud_from_image()
        # the from-image cloud lives in the sphere frame: use the sphere pose
        ps = aligner.get_optimal_pose().astype(np.float64)
        xyz2 = np.asarray(xyz2).reshape(-1, 3) @ ps[:3, :3].T + ps[:3, 3]
        save_ply(os.path.join(args.out, "pair_registered.ply"),
                 np.concatenate([np.asarray(xyz1).reshape(-1, 3), xyz2]),
                 np.concatenate([np.asarray(rgb1).reshape(-1, 3), np.asarray(rgb2).reshape(-1, 3)]))
        print(f"artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
