"""Bisect the plane-extraction DEVICE program's 8 stages on the accelerator.

Each probe is a chained fori_loop over a prefix of the
pipeline, so stage cost = difference between consecutive probes.

Usage: python tools/profile_planes_device.py [--k 20]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.core.frame360 import Frame360
    from rgbd360_tpu.io.calib import Calib360
    from rgbd360_tpu.ops.bilateral import fast_bilateral_z
    from rgbd360_tpu.ops.normals import organized_normals
    from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2
    from rgbd360_tpu.ops.plane_stats import sensor_plane_stats
    from rgbd360_tpu.ops.planes_seg import refine_plane_labels, segment_planes

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    frame = Frame360(calib)
    frame.load_frame(os.path.join(ref, "samples/sphere_images_1.bin"))
    frame.undistort()

    depth = jnp.asarray(frame.depth_undistorted_m)
    rgb = jnp.asarray(frame.rgb)

    def sync():
        np.asarray(jnp.zeros(()) + 1.0)

    def cloud_stage(d, rgb_s):
        xyz = backproject_organized(d)
        xyz2, rgb2 = downsample_median2(xyz, rgb_s)
        zf = fast_bilateral_z(xyz2[..., 2])
        xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
        return xyz2, rgb2

    def upto(stage):
        def one(d, rgb_s):
            xyz2, rgb2 = cloud_stage(d, rgb_s)
            out = jnp.nansum(xyz2)
            if stage >= 1:
                normals = organized_normals(xyz2)
                out = out + jnp.nansum(normals)
            if stage >= 2:
                labels_pre = segment_planes(xyz2, normals)
                labels = labels_pre
                out = out + jnp.sum(labels)
            if stage >= 3:
                labels = refine_plane_labels(labels_pre, xyz2, normals)
                out = out + jnp.sum(labels)
            if stage >= 4:
                st = sensor_plane_stats(xyz2, rgb2, labels, labels_pre)
                out = out + jnp.sum(st.count) + jnp.nansum(st.mean)
                cand = st.candidate
            else:
                cand = jnp.zeros(xyz2.shape[:2], bool)
            return out.astype(jnp.float32), cand

        def batched(v):
            out, cand = jax.vmap(one)(v, rgb)
            total = jnp.sum(out)
            if stage >= 5:
                # THE production compaction (shared definition — the batched
                # 2D scatter outside the vmap; a vmapped per-sensor copy once
                # overstated this stage several-fold)
                from rgbd360_tpu.core.plane_extraction import (
                    MAX_CANDIDATES,
                    compact_candidate_indices,
                )

                hw = cand.shape[1] * cand.shape[2]
                cidx = compact_candidate_indices(
                    cand.reshape(8, hw), MAX_CANDIDATES
                )
                total = total + jnp.sum(cidx).astype(jnp.float32)
            return total

        @jax.jit
        def chain(d, k):
            def body(_, carry):
                v, acc = carry
                out = batched(v) * 1e-9
                return depth + (out * 1e-12).astype(jnp.float32), acc + out

            _, acc = jax.lax.fori_loop(0, k, body, (d, jnp.float32(0)))
            return acc

        return chain

    names = ["cloud", "+normals", "+segment", "+refine", "+stats", "+topk_cand"]
    prev = 0.0
    for stage, name in enumerate(names):
        chain = upto(stage)
        np.asarray(chain(depth, args.k))  # warm
        sync()
        t0 = time.perf_counter()
        np.asarray(chain(depth, args.k))
        ms = (time.perf_counter() - t0) / args.k * 1e3
        print(f"{name:12s}: {ms:7.1f} ms cumulative ({ms - prev:+6.1f} ms stage)")
        prev = ms


if __name__ == "__main__":
    main()
