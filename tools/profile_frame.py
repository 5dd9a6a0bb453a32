"""Per-stage timing of the frame-assembly pipeline on the accelerator
(undistort -> stitch -> cloud/planes feed): k chained calls inside one jit,
ended by block_until_ready.

Usage: python tools/profile_frame.py [--k 100]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    # the persistent compile cache (host-feature-keyed dir + min-compile-time)
    # is configured by the package import below — a literal dir here would
    # bypass the keying and reintroduce the cross-host AOT SIGILL hazard

    from rgbd360_tpu.io.boost_archive import read_frame360_bin
    from rgbd360_tpu.io.calib import Calib360
    from rgbd360_tpu.ops.image import gray_f32
    from rgbd360_tpu.ops.stitch import stitch_spherical
    from rgbd360_tpu.ops.undistort import undistort_depth
    from rgbd360_tpu.ops import photoicp

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    raw = read_frame360_bin(os.path.join(ref, "samples/sphere_images_1.bin"))
    rgb = jnp.asarray(raw.rgb)
    depth_mm = jnp.asarray(raw.depth)
    mults, counts, geom = calib.stacked_intrinsic_arrays()
    mults = jnp.asarray(mults)
    counts = jnp.asarray(counts)
    rt_inv = jnp.asarray(calib.Rt_inv)
    cam = jnp.asarray(calib.camera_matrix)

    def chain(fn, seed, k):
        @jax.jit
        def run(x):
            def body(_, carry):
                v, acc = carry
                out = fn(v)
                return seed + (out * 1e-12).astype(seed.dtype), acc + out

            _, acc = jax.lax.fori_loop(0, k, body, (seed, jnp.float32(0)))
            return acc

        run(seed).block_until_ready()
        t0 = time.perf_counter()
        run(seed).block_until_ready()
        return (time.perf_counter() - t0) / k * 1e3

    # undistort: perturb the input depth (value-bearing chain)
    d_m = depth_mm.astype(jnp.float32) * 0.001

    def undistort_fn(d):
        out = undistort_depth(d, mults, counts, bin_width=geom.bin_width,
                              bin_height=geom.bin_height, bin_depth=geom.bin_depth)
        return jnp.sum(out) * 1e-9

    print(f"undistort      : {chain(undistort_fn, d_m, args.k):8.3f} ms/frame")

    def stitch_fn(d):
        srgb, sdep = stitch_spherical(rgb, (d * 1000.0).astype(jnp.uint16), rt_inv, cam)
        return jnp.sum(sdep.astype(jnp.float32)) * 1e-9 + jnp.sum(srgb[0, 0].astype(jnp.float32)) * 1e-12

    print(f"stitch         : {chain(stitch_fn, d_m, args.k):8.3f} ms/frame")

    # pyramid+gradients of a stitched frame (the aligner's per-frame prep)
    srgb, sdep = stitch_spherical(rgb, depth_mm, rt_inv, cam)
    gray = gray_f32(srgb)
    sdep_m = sdep.astype(jnp.float32) * 0.001

    def pyr_fn(g):
        pyrs = photoicp.build_pyramid_set(g, sdep_m, 5, is_target=True, sphere_seam_mask=True)
        return sum(jnp.sum(p) for p in pyrs[0]) * 1e-9

    print(f"pyramids+grads : {chain(pyr_fn, gray, args.k):8.3f} ms/frame")


if __name__ == "__main__":
    main()
