"""Per-stage timing of the plane-extraction path on the accelerator.

Stages: device compute (chained k calls in one jit), device->host
transfer, host per-sensor fitting, host group+merge.

Usage: python tools/profile_planes.py [--k 20] [--reps 5]
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
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.core.frame360 import Frame360
    from rgbd360_tpu.core import plane_extraction as pe
    from rgbd360_tpu.io.calib import Calib360

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    frame = Frame360(calib)
    frame.load_frame(os.path.join(ref, "samples/sphere_images_1.bin"))
    frame.undistort()

    depth = jnp.asarray(frame.depth_undistorted_m)
    rgb = jnp.asarray(frame.rgb)

    def sync():
        np.asarray(jnp.zeros(()) + 1.0)

    # --- device compute, chained (value-bearing perturbation) ---
    @jax.jit
    def chain_device(d, k):
        def body(_, carry):
            v, acc = carry
            buf = pe.build_sensor_plane_stats(v, rgb)
            out = jnp.sum(buf[:: 1024].astype(jnp.float32)) * 1e-9
            return depth + (out * 1e-12).astype(jnp.float32), acc + out

        _, acc = jax.lax.fori_loop(0, k, body, (d, jnp.float32(0)))
        return acc

    np.asarray(chain_device(depth, args.k))  # warm
    sync()
    t0 = time.perf_counter()
    np.asarray(chain_device(depth, args.k))
    dev_ms = (time.perf_counter() - t0) / args.k * 1e3
    print(f"device compute  : {dev_ms:8.1f} ms/frame")

    # --- one-shot dispatch + transfer (what extract_frame_planes pays) ---
    buf = np.asarray(pe.build_sensor_plane_stats(depth, rgb))
    for rep in range(args.reps):
        sync()
        t0 = time.perf_counter()
        buf = np.asarray(pe.build_sensor_plane_stats(depth, rgb))
        t1 = time.perf_counter()
        print(f"dispatch+xfer   : {(t1 - t0) * 1e3:8.1f} ms/frame (rep {rep})")
    print(f"  transferred   : {buf.nbytes / 1e6:.2f} MB (one array)")

    # --- host fitting ---
    h, w = depth.shape[1] // 2, depth.shape[2] // 2
    rt = frame.calib.Rt
    for rep in range(args.reps):
        t0 = time.perf_counter()
        labels, cand_lab, cand_xyz, stats, n_cand = pe._unpack_stats_buffer(buf, h, w)
        local = []
        for s in range(8):
            planes = pe._planes_from_stats(
                stats[s], labels[s], cand_lab[s], cand_xyz[s], s, h * w
            )
            for p in planes:
                p.transform(rt[s].astype(np.float64))
            local.append(planes)
        t1 = time.perf_counter()
        import copy

        pristine = [[copy.deepcopy(p) for p in l] for l in local]
        t2 = time.perf_counter()
        pbmap = pe.merge_planes(pe.group_planes(pristine))
        t3 = time.perf_counter()
        print(
            f"host fit {(t1 - t0) * 1e3:7.1f} ms | deepcopy {(t2 - t1) * 1e3:6.1f} ms"
            f" | group+merge {(t3 - t2) * 1e3:6.1f} ms | planes {len(pbmap.planes)}"
        )

    # --- end-to-end, both configurations ---
    for need_inliers in (True, False):
        pe.extract_frame_planes(frame, need_inliers=need_inliers)  # warm
        for rep in range(args.reps):
            t0 = time.perf_counter()
            pbmap, local = pe.extract_frame_planes(frame, need_inliers=need_inliers)
            t1 = time.perf_counter()
            print(
                f"end-to-end      : {(t1 - t0) * 1e3:8.1f} ms/frame "
                f"(need_inliers={need_inliers})"
            )

    # --- steady-state pipelined rate (the SLAM-loop configuration):
    # one-frame lookahead overlaps device+transfer with host fitting ---
    n_stream = 4 * args.reps
    stream = [(i, frame) for i in range(n_stream)]
    list(pe.planes_pipeline(iter(stream[:2])))  # warm
    t0 = time.perf_counter()
    out = list(pe.planes_pipeline(iter(stream)))
    dt = (time.perf_counter() - t0) / n_stream * 1e3
    print(f"pipelined       : {dt:8.1f} ms/frame steady-state "
          f"({n_stream} frames, {len(out[-1][1].planes.planes)} planes)")


if __name__ == "__main__":
    main()
