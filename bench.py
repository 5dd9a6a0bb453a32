"""Benchmark: spherical Photo+ICP pair registrations per second on one GPU.

Dense photometric+depth coarse-to-fine registration of the bundled golden
pair (tests/golden/pair_1_10.npz: both stitched 1920x320 panoramas) at full
resolution, 5 pyramid levels, PHOTO_DEPTH, batched with vmap
(parallel/batch.align_batch). Throughput is batch*iters over the wall time
of `iters` calls, each ended by jax.block_until_ready. Refuses to run
without a CUDA device. Prints ONE json line.

Usage: python bench.py   (BENCH_BATCH, BENCH_ITERS override 8 and 10)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "pair_1_10.npz")

# Known-legitimate FULL iteration signatures (coarse->fine) on the golden
# pair under the reference stopping rule (maxIters 10, tol_residual 1e-3,
# tol_update 1e-4 — RegisterPhotoICP.h:4593-4611), each cross-checked on the
# CPU: (0,7,10,10,10) is the f32/f64 golden free run; the exact chain can
# stop the finest level early in a legitimate flat spot, (0,7,10,10,3) and
# (0,7,10,10,1). A corrupted landscape shows first as a moved coarse prefix
# (the denormal-flush lesson: [4,10,9,...]). The H100 signature is to be
# pinned alone once recorded and cross-checked.
ALLOWED_SIGNATURES = {(0, 7, 10, 10, 10), (0, 7, 10, 10, 3), (0, 7, 10, 10, 1)}

# Two-sided exact-finest-error band around the golden free run: known-good
# basins span 2.408-3.1 around golden 2.866, so [g-0.6, g+0.35] covers every
# legitimate basin. The UPPER bound catches divergence; the LOWER bound
# catches term-set thinning — a numerics artifact that silently drops
# residual terms makes the error metric itself smaller.
GOLDEN_ERR_BAND = (-0.6, 0.35)


def sanity_check(pose, error, ill_posed, num_iterations, golden=None):
    """Decide whether a result on the golden pair is a faithful registration.

    Pure host-side logic, importable by tests (tests/test_bench_gate.py
    proves an injected finest-level early stop flips it to False).

    pose: (4,4) np.ndarray; error: float (finest-level error);
    num_iterations: length-5 sequence coarse->fine; golden: the loaded
    pair_1_10.npz (or None when the fixture is absent).
    Returns (ok, reasons) where reasons names every failed rail.
    """
    reasons = []
    t_norm = float(np.linalg.norm(np.asarray(pose)[:3, 3]))
    if not (0.01 < t_norm < 2.0):
        reasons.append(f"translation norm {t_norm:.4f} outside (0.01, 2.0)")
    if bool(np.asarray(ill_posed).any()):
        reasons.append("ill-posed system reported")
    if golden is not None:
        t_diff = float(np.linalg.norm(np.asarray(pose)[:3, 3] - golden["free_pose"][:3, 3]))
        if not t_diff < 0.1:
            reasons.append(f"translation vector {t_diff:.4f} m from golden basin (limit 0.1)")
        g_err = float(golden["free_error"])
        lo, hi = g_err + GOLDEN_ERR_BAND[0], g_err + GOLDEN_ERR_BAND[1]
        if not (lo < float(error) < hi):
            reasons.append(
                f"finest-level error {float(error):.4f} outside two-sided band "
                f"({lo:.3f}, {hi:.3f}) — too low means thinned term set, "
                f"too high means divergence"
            )
    sig = tuple(int(x) for x in np.asarray(num_iterations).reshape(-1))
    if sig not in ALLOWED_SIGNATURES:
        reasons.append(
            f"iteration signature {sig} not in the CPU-cross-checked set "
            f"{sorted(ALLOWED_SIGNATURES)} — a perf win must not come from "
            "computing less"
        )
    return (not reasons), reasons


def load_golden_pair(golden):
    """(gray_src, depth_src_m, gray_trg, depth_trg_m) f32 host arrays of the
    golden pair, converted exactly as Frame360 does (u8/255, mm*0.001)."""
    return (
        golden["gray_src_u8"].astype(np.float32) / 255.0,
        golden["depth_src_mm"].astype(np.float32) * 0.001,
        golden["gray_trg_u8"].astype(np.float32) / 255.0,
        golden["depth_trg_mm"].astype(np.float32) * 0.001,
    )


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` read in a child process that
    does not import JAX (the card stays with this one process); one
    "name, limit" entry per card, joined by "; "."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(out.stdout.strip().splitlines())


def main() -> int:
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"metric": "sphere_photoicp_pairs_per_sec", "sane": False,
                          "error": f"needs a CUDA device, found platform {dev.platform!r}"}))
        return 1
    card = gpu_name_and_power_limit()

    from rgbd360_tpu.parallel.batch import align_batch

    golden = np.load(GOLDEN)
    pair = [np.broadcast_to(a, (batch,) + a.shape).copy() for a in load_golden_pair(golden)]
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
    args = [jax.device_put(a) for a in (*pair, poses)]

    t0 = time.perf_counter()
    res = jax.block_until_ready(align_batch(*args))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(align_batch(*args))
    dt = time.perf_counter() - t0
    pairs_per_sec = batch * iters / dt

    ok, reasons = sanity_check(
        np.asarray(res.pose[0]), float(res.error[0]), np.asarray(res.ill_posed),
        np.asarray(res.num_iterations[0]), golden=golden,
    )
    out = {
        "metric": "sphere_photoicp_pairs_per_sec",
        "value": pairs_per_sec,
        "unit": "pairs/s",
        "batch": batch,
        "iters": iters,
        "setup_compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "iteration_signature": [int(x) for x in np.asarray(res.num_iterations[0])],
        "translation_norm_m": float(np.linalg.norm(np.asarray(res.pose[0])[:3, 3])),
        "sane": ok,
    }
    if reasons:
        out["sanity_failures"] = reasons
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
