"""Measure flood-fill schedule variants of segment_planes on the accelerator.

Variants: (sweeps per round, jumps per round). All must reach the same fixed
point; what differs is rounds-to-converge vs per-round cost.

Usage: python tools/profile_seg_variants.py [--k 20]
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
    from rgbd360_tpu.ops import planes_seg
    from rgbd360_tpu.ops.bilateral import fast_bilateral_z
    from rgbd360_tpu.ops.normals import organized_normals
    from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    frame = Frame360(calib)
    frame.load_frame(os.path.join(ref, "samples/sphere_images_1.bin"))
    frame.undistort()

    def prep(d, rgb_s):
        xyz = backproject_organized(d)
        xyz2, _ = downsample_median2(xyz, rgb_s)
        zf = fast_bilateral_z(xyz2[..., 2])
        xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
        return xyz2, organized_normals(xyz2)

    xyz2, normals = jax.jit(jax.vmap(prep))(frame.depth_undistorted_m, frame.rgb)
    xyz2, normals = jax.block_until_ready(xyz2), jax.block_until_ready(normals)

    def sync():
        np.asarray(jnp.zeros(()) + 1.0)

    def variant(n_jumps):
        def seg(xyz, nrm):
            return planes_seg.segment_planes(xyz, nrm, jumps=n_jumps)

        @jax.jit
        def chain(x, k):
            def body(_, carry):
                v, acc = carry
                lab = jax.vmap(seg)(v, normals)
                out = jnp.sum(lab).astype(jnp.float32) * 1e-9
                return xyz2 + (out * 1e-12), acc + out

            _, acc = jax.lax.fori_loop(0, k, body, (x, jnp.float32(0)))
            return acc

        return chain

    baseline = None
    for n_jumps in (2, 1, 0):
        chain = variant(n_jumps)
        np.asarray(chain(xyz2, args.k))
        sync()
        t0 = time.perf_counter()
        np.asarray(chain(xyz2, args.k))
        ms = (time.perf_counter() - t0) / args.k * 1e3
        # fixed-point identity check vs the default schedule
        lab = np.asarray(
            jax.jit(jax.vmap(lambda x, n: planes_seg.segment_planes(x, n, jumps=n_jumps)))(
                xyz2, normals
            )
        )
        if baseline is None:
            baseline = lab
        same = np.array_equal(lab, baseline)
        print(f"jumps={n_jumps}: {ms:7.1f} ms  fixed-point-identical={same}")


if __name__ == "__main__":
    main()
