"""Profiler trace of batched pair registration on a CUDA device.

Runs parallel.batch.align_batch on the golden pair (tests/golden/
pair_1_10.npz, 1920x320, 5 levels) and reports, with the card's name and
power limit:

  * the warm call time (host clock around block_until_ready);
  * each pyramid level's device time, from the trace, by the
    `align_level<k>` name scope ops/photoicp.align_frames360 puts on it,
    and each level's GN loop timed alone as a cross-check;
  * the device busy share of the traced window, the kernels that take the
    most device time, and the share of the cuBLAS matrix products (the
    6xN by Nx6 normal-equation dots);
  * the sweep's gather timed alone at the finest level's batch shape (XLA
    fuses it into its consumers, so the trace has no gather kernel), and
    its achieved bytes/s against the copy bandwidth this card reaches on a
    plain 1 GiB device copy. Bytes: per pixel one 4-byte index and one
    16-byte packed row read, one 16-byte row written;
  * the finest level's normal-equation product H = J^T J timed alone, as
    the cuBLAS dot and as an elementwise-product reduction.

XLA runs a call's kernels as CUDA graphs (command buffers), which a trace
shows as one opaque event; so this tool turns command buffers off
(--xla_gpu_enable_command_buffer=) to see each kernel, and its warm call
time is the time without them (chip_smoke.py phase 4 reports the default).

Usage: python tools/trace_align.py
Writes chiprun_out/trace_align/summary.json.
"""

import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "chiprun_out", "trace_align")
BATCH = 8
TRACED_CALLS = 3


def busy_ns(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(trace_dir: str):
    """(name, start_ns, duration_ns, stats) of every event on GPU 0's plane."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    data = ProfileData.from_file(path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((ev.name, ev.start_ns, ev.duration_ns, dict(ev.stats)))
    return out


def reduce_trace(events, n_calls):
    """Per-call device metrics from the kernel events of n_calls calls."""
    if not events:
        raise SystemExit("no device events in the trace")
    t0 = min(e[1] for e in events)
    t1 = max(e[1] + e[2] for e in events)
    busy = busy_ns([(s, s + d) for _n, s, d, _st in events])
    by_kernel = collections.Counter()
    by_level = collections.Counter()
    gemm_ns = 0
    for name, _s, d, st in events:
        text = " ".join(str(v) for v in (name, *st.values()))
        by_kernel[st.get("hlo_op", name)] += d
        m = re.search(r"align_level(\d)", text)
        by_level[int(m.group(1)) if m else None] += d
        if "gemm" in text.lower() or str(st.get("hlo_op", "")).startswith("cublas"):
            gemm_ns += d
    return {
        "window_ns_per_call": (t1 - t0) / n_calls,
        "busy_share": busy / (t1 - t0),
        "device_ns_per_call_by_level": {str(k): v / n_calls for k, v in sorted(
            by_level.items(), key=lambda kv: (kv[0] is None, kv[0] or 0))},
        "gemm_ns_per_call": gemm_ns / n_calls,
        "gemm_share_of_busy": gemm_ns / busy,
        "top_kernels_ns_per_call": [(k, v / n_calls) for k, v in by_kernel.most_common(25)],
        "stat_keys_seen": sorted({k for *_x, st in events for k in st}),
    }


def standalone_level_ms(jax, xs, golden, reps=5):
    """Host-clock time of each pyramid level's GN loop run alone (batched,
    from the golden incoming pose of that level) — a cross-check on the
    trace's per-level attribution."""
    from rgbd360_tpu.ops import photoicp

    n = int(golden["n_levels"])

    def pyr(gs, ds, gt, dt):
        return (photoicp.build_pyramid_set(gs, ds, n, is_target=False, sphere_seam_mask=True),
                photoicp.build_pyramid_set(gt, dt, n, is_target=True, sphere_seam_mask=True))

    src, trg = jax.jit(jax.vmap(pyr))(*xs[:4])
    out = {}
    for k, lvl in enumerate(range(n - 1, -1, -1)):
        pose = np.broadcast_to(golden["free_level_pose_in"][k].astype(np.float32),
                               (xs[0].shape[0], 4, 4)).copy()
        f = jax.jit(jax.vmap(lambda s, t, p, lvl=lvl: photoicp.align_level_sphere(
            photoicp.make_level_data(s, t, lvl), p, photoicp.PHOTO_DEPTH)))
        jax.block_until_ready(f(src, trg, pose))
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            jax.block_until_ready(f(src, trg, pose))
            ts.append(time.perf_counter() - t)
        out[str(lvl)] = float(np.median(ts)) * 1e3
    return out


def _median_ms(jax, f, *args, reps=10):
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def isolated_gather(jax, jnp, batch, n):
    """(ms, bytes/s) of the sweep's row gather alone: (batch, n, 4) i32
    rows taken at random indices, as ops/photoicp._gather_rows does."""
    rng = np.random.default_rng(0)
    rows = jax.device_put(rng.integers(0, 2**31, (batch, n, 4)).astype(np.int32))
    idx = jax.device_put(rng.integers(0, n, (batch, n)).astype(np.int32))
    f = jax.jit(jax.vmap(lambda p, i: jnp.take(p, i, axis=0, mode="clip")))
    ms = _median_ms(jax, f, rows, idx)
    return ms, batch * n * (4 + 16 + 16) / (ms * 1e-3)


def normal_product_ms(jax, jnp, batch, n):
    """H = J^T J for (batch, n, 6) f32 Jacobians, timed two ways at full
    f32: the dot the sweep traces (cuBLAS at HIGHEST precision) and the
    same sum as elementwise products reduced by XLA."""
    rng = np.random.default_rng(1)
    jac = jax.device_put(rng.standard_normal((batch, n, 6)).astype(np.float32))
    dot = jax.jit(lambda j: jnp.einsum("bni,bnj->bij", j, j))
    ew = jax.jit(lambda j: (j[..., :, None] * j[..., None, :]).sum(axis=1))
    return {"dot_highest": _median_ms(jax, dot, jac), "elementwise_sum": _median_ms(jax, ew, jac)}


def copy_bandwidth(jax, jnp, nbytes=1 << 30, reps=5):
    """Bytes/s of a plain device copy (read + write) of nbytes."""
    x = jnp.ones(nbytes // 4, jnp.float32)
    f = jax.jit(lambda a: a * 1.0001)
    f(x).block_until_ready()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        f(x).block_until_ready()
        ts.append(time.perf_counter() - t)
    return 2 * nbytes / float(np.median(ts))


def main() -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    import jax
    import jax.numpy as jnp

    import bench
    from rgbd360_tpu.parallel.batch import align_batch

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a CUDA device, found platform {dev.platform!r}")
    card = bench.gpu_name_and_power_limit()

    golden = np.load(bench.GOLDEN)
    pair = [np.broadcast_to(a, (BATCH,) + a.shape).copy()
            for a in bench.load_golden_pair(golden)]
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (BATCH, 4, 4)).copy()
    xs = [jax.device_put(a) for a in (*pair, poses)]
    res = jax.block_until_ready(align_batch(*xs))
    ts = []
    for _ in range(5):
        t = time.perf_counter()
        jax.block_until_ready(align_batch(*xs))
        ts.append(time.perf_counter() - t)

    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as trace_dir:  # raw traces are large
        jax.profiler.start_trace(trace_dir)
        for _ in range(TRACED_CALLS):
            jax.block_until_ready(align_batch(*xs))
        jax.profiler.stop_trace()
        summary = reduce_trace(device_events(trace_dir), TRACED_CALLS)

    iters = np.asarray(res.num_iterations[0])  # coarse -> fine
    h, w = pair[0].shape[1:]
    bw = copy_bandwidth(jax, jnp)
    g_ms, g_bps = isolated_gather(jax, jnp, BATCH, h * w)
    summary["l0_normal_product_ms"] = normal_product_ms(jax, jnp, BATCH, h * w)
    summary["standalone_level_ms"] = standalone_level_ms(jax, xs, golden)
    summary.update(
        xla_flags=os.environ["XLA_FLAGS"],
        card=card,
        device_kind=dev.device_kind,
        batch=BATCH,
        warm_call_ms_median=float(np.median(ts)) * 1e3,
        warm_call_ms_all=[t * 1e3 for t in ts],
        iteration_signature=[int(i) for i in iters],
        copy_bandwidth_bytes_per_s=bw,
        l0_gather_alone_ms=g_ms,
        l0_gather_bytes_per_s=g_bps,
        l0_gather_share_of_copy_bandwidth=g_bps / bw,
    )
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels_ns_per_call"},
                     indent=1))
    for name, ns in summary["top_kernels_ns_per_call"][:15]:
        print(f"{ns / 1e3:10.1f} us/call  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
