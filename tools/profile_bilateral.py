"""Bisect fast_bilateral_z internals on the accelerator: splat / blur /
spatial-resize / depth-slice. Chained probes over the 8-sensor batch.

Usage: python tools/profile_bilateral.py [--k 30]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.core.frame360 import Frame360
    from rgbd360_tpu.io.calib import Calib360
    from rgbd360_tpu.ops import bilateral as B
    from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    frame = Frame360(calib)
    frame.load_frame(os.path.join(ref, "samples/sphere_images_1.bin"))
    frame.undistort()

    def prep(d, rgb_s):
        xyz = backproject_organized(d)
        xyz2, _ = downsample_median2(xyz, rgb_s)
        return xyz2[..., 2]

    zs = jax.block_until_ready(
        jax.jit(jax.vmap(prep))(frame.depth_undistorted_m, frame.rgb)
    )

    def sync():
        np.asarray(jnp.zeros(()) + 1.0)

    SIGMA_S, SIGMA_R, _PAD = B.SIGMA_S, B.SIGMA_R, B._PAD

    def upto(stage):
        def one(z):
            h, w = z.shape
            valid = jnp.isfinite(z)
            zv = jnp.where(valid, z, 0.0)
            zmin = jnp.min(jnp.where(valid, z, jnp.inf))
            zmin = jnp.where(jnp.isfinite(zmin), zmin, 0.0)
            gh = int(round(h / SIGMA_S)) + 1 + 2 * _PAD
            gw = int(round(w / SIGMA_S)) + 1 + 2 * _PAD
            gd = 200 + 1 + 2 * _PAD
            yy = jnp.arange(h, dtype=jnp.float32)[:, None] / SIGMA_S + _PAD
            xx = jnp.arange(w, dtype=jnp.float32)[None, :] / SIGMA_S + _PAD
            dd = jnp.clip((zv - zmin) / SIGMA_R + _PAD, 0.0, float(200 + _PAD))
            yi = jnp.clip(jnp.round(yy).astype(jnp.int32), 0, gh - 1)
            xi = jnp.clip(jnp.round(xx).astype(jnp.int32), 0, gw - 1)
            di = jnp.clip(jnp.round(dd).astype(jnp.int32), 0, gd - 1)
            yi = jnp.broadcast_to(yi, (h, w))
            xi = jnp.broadcast_to(xi, (h, w))
            flat = (yi * gw + xi) * gd + di
            feat = jnp.stack(
                [jnp.where(valid, zv, 0.0), jnp.where(valid, 1.0, 0.0)], axis=-1
            ).reshape(-1, 2)
            grid = (
                jnp.zeros((gh * gw * gd, 2), jnp.float32)
                .at[flat.reshape(-1)]
                .add(feat)
                .reshape(gh, gw, gd, 2)
            )
            out = jnp.sum(grid[..., 0])
            if stage >= 1:
                for axis in range(3):
                    grid = B._blur_axis(grid, axis)
                out = out + jnp.sum(grid[..., 0])
            if stage >= 2:
                y1d = yy[:, 0]
                x1d = xx[0, :]
                y0r = jnp.clip(jnp.floor(y1d).astype(jnp.int32), 0, gh - 2)
                x0c = jnp.clip(jnp.floor(x1d).astype(jnp.int32), 0, gw - 2)
                fy1 = y1d - y0r
                fx1 = x1d - x0c
                wy = (
                    jax.nn.one_hot(y0r, gh, dtype=jnp.float32) * (1 - fy1)[:, None]
                    + jax.nn.one_hot(y0r + 1, gh, dtype=jnp.float32) * fy1[:, None]
                )
                wx = (
                    jax.nn.one_hot(x0c, gw, dtype=jnp.float32) * (1 - fx1)[:, None]
                    + jax.nn.one_hot(x0c + 1, gw, dtype=jnp.float32) * fx1[:, None]
                )
                up = jnp.einsum("rg,gwdc->rwdc", wy, grid)
                up = jnp.einsum("xw,rwdc->rxdc", wx, up)
                out = out + jnp.sum(up[..., 0, 0])
            if stage >= 3:
                z0 = jnp.clip(jnp.floor(dd).astype(jnp.int32), 0, gd - 2)
                fz = dd - z0
                g0 = jnp.take_along_axis(up, z0[..., None, None], axis=2)[:, :, 0]
                g1 = jnp.take_along_axis(up, (z0 + 1)[..., None, None], axis=2)[:, :, 0]
                acc = g0 * (1 - fz)[..., None] + g1 * fz[..., None]
                out = out + jnp.sum(acc)
            return out

        @jax.jit
        def chain(x, k):
            def body(_, carry):
                v, acc = carry
                out = jnp.sum(jax.vmap(one)(v)) * 1e-9
                return zs + (out * 1e-12), acc + out

            _, acc = jax.lax.fori_loop(0, k, body, (x, jnp.float32(0)))
            return acc

        return chain

    prev = 0.0
    for stage, name in enumerate(["splat", "+blur", "+resize", "+zslice"]):
        chain = upto(stage)
        np.asarray(chain(zs, args.k))
        sync()
        t0 = time.perf_counter()
        np.asarray(chain(zs, args.k))
        ms = (time.perf_counter() - t0) / args.k * 1e3
        print(f"{name:10s}: {ms:7.1f} ms cumulative ({ms - prev:+6.1f} ms stage)")
        prev = ms


if __name__ == "__main__":
    main()
