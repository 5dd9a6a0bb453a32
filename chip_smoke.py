"""Smoke run of the system's main paths on a CUDA device, at full size.

One process drives the card (children that touch it run strictly before
the parent does). Phases, in order; any failure ends the run with a
non-zero exit code and no result line:

  1. device       a child process checks that JAX sees a CUDA device (never
                  a CPU fallback); versions, XLA_FLAGS and the card's name
                  and power limit (nvidia-smi) are printed
  2. gpu tests    `pytest -m gpu` in a child with JAX_PLATFORMS=cuda
  3. golden       full-width 1920x320 parity on tests/golden/pair_1_10.npz
                  against the f64 reference run: per-level residual, H, g,
                  SSO and counts at the golden poses; the forced-schedule
                  pose; the free run's basin and iteration signature
  4. batch        parallel.batch.align_batch at batch 8 on the golden pair
  5. kf-slam      apps.kf_sphere_slam.main on a seeded synthetic loop, plus
                  the plane program and fit run twice on one frame

Usage:
  python chip_smoke.py               one card, phases 1-5
  python chip_smoke.py --four-cards  four cards: only the sharded paths
                                     (__graft_entry__.sharded_parity) at
                                     1920x320, batch 8, each against its
                                     single-device result

The last line of standard output is the JSON result
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "pair_1_10.npz")

# KF-SLAM phase: the generator's default closed loop, 40 frames on a circle
# of radius 1.1 m (0.17 m between frames), rendered from fixed geometry by
# tools/make_synthetic_sequence.py.
SLAM_FRAMES = 40
SLAM_RADIUS = 1.1
# Bound on the keyframe trajectory error (RMS position residual after a
# rigid Kabsch fit to poses_gt.txt). The CPU backend measures 0.0056 m on
# this sequence (keyframes at frames 1 and 8); the bound leaves room for
# the card's last-bit differences without admitting a lost track (a
# 16-frame loop of radius 0.8 m, which tracks poorly, measures 0.31 m).
SLAM_ATE_BOUND_M = 0.05
SLAM_MIN_KEYFRAMES = 2

_PROBE = (
    "import json, jax; d = jax.devices()[0]; "
    "print(json.dumps({'platform': d.platform, 'kind': d.device_kind, "
    "'count': len(jax.devices())}))"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_device_platform(platform: str) -> None:
    """Refuse anything but a CUDA device: a CPU run must never pass for a
    card run."""
    if platform != "gpu":
        fail(f"JAX found no CUDA device (platform {platform!r}); this script "
             "runs only on the card")


def result_line(dev) -> str:
    """The exact last line: device as JAX reports it."""
    import jax

    return json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    })


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device(n_cards: int) -> str:
    probe = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=600
    )
    if probe.returncode != 0:
        fail(f"device probe exited {probe.returncode}: {probe.stderr.strip()[-2000:]}")
    info = json.loads(probe.stdout.strip().splitlines()[-1])
    check_device_platform(info["platform"])
    if info["count"] < n_cards:
        fail(f"needs {n_cards} CUDA devices, JAX sees {info['count']}")

    import jax
    import jaxlib

    sys.path.insert(0, REPO)
    import bench

    card = bench.gpu_name_and_power_limit()
    log(f"[device] {info['kind']} x{info['count']}  jax {jax.__version__}  "
        f"jaxlib {jaxlib.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    return card


# ---------------------------------------------------------------------------
# phase 2: card-marked tests (before this process touches the device)
# ---------------------------------------------------------------------------

GPU_TEST_FILES = ("tests/test_golden_parity.py", "tests/test_precision.py")


def phase_gpu_tests() -> None:
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-p", "no:cacheprovider",
             f"--junitxml={xml}", *GPU_TEST_FILES],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
        )
        sys.stdout.write(proc.stdout[-4000:])
        if proc.returncode != 0:
            fail(f"pytest -m gpu exited {proc.returncode}: {proc.stderr[-2000:]}")
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors", "skipped")}
    if n["tests"] == 0 or n["failures"] or n["errors"] or n["skipped"]:
        fail(f"gpu-marked tests did not all run and pass: {n}")
    log(f"[gpu tests] {n['tests']} passed on the card")


# ---------------------------------------------------------------------------
# phase 3: golden parity at full width
# ---------------------------------------------------------------------------


def phase_golden(golden, card: str) -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import bench
    import golden_ref
    from rgbd360_tpu.ops import linalg6, photoicp
    from rgbd360_tpu.ops.sphere import sphere_xyz_lut

    log(f"[golden] matmul precision in force: {jax.config.jax_default_matmul_precision}")
    n = int(golden["n_levels"])
    gs, ds, gt, dt = (jnp.asarray(a) for a in bench.load_golden_pair(golden))

    @functools.partial(jax.jit, static_argnames=("n_levels",))
    def pyramids(gs, ds, gt, dt, n_levels):
        src = photoicp.build_pyramid_set(gs, ds, n_levels, is_target=False, sphere_seam_mask=True)
        trg = photoicp.build_pyramid_set(gt, dt, n_levels, is_target=True, sphere_seam_mask=True)
        return src, trg

    @functools.partial(jax.jit, static_argnames=("lv",))
    def sweep_at(src, trg, pose, lv):
        level = photoicp.make_level_data(src, trg, lv)
        xyz, valid = sphere_xyz_lut(level.depth_src, 0.3, 6.0)
        return photoicp.fused_sweep_sphere(
            level.gray_src.reshape(-1), photoicp.pack_target_channels(level),
            level.gray_src.shape, xyz, valid, pose, photoicp.PHOTO_DEPTH,
        )

    src, trg = pyramids(gs, ds, gt, dt, n)
    # tolerances of tests/test_golden_parity.py::test_per_level_residuals_vs_golden
    for k, lv in enumerate(range(n - 1, -1, -1)):
        pose = jnp.asarray(golden["free_level_pose_in"][k], jnp.float32)
        err, H, g, sso, _pe2, n_photo, _de2, n_depth = jax.device_get(sweep_at(src, trg, pose, lv))
        err_g = float(golden["free_level_err_in"][k])
        H_g, g_g = golden["free_level_H_in"][k], golden["free_level_g_in"][k]
        d_err = abs(float(err) - err_g) / err_g
        d_H = float(np.abs(H / np.abs(H_g).max() - H_g / np.abs(H_g).max()).max())
        d_g = float(np.abs(g / np.abs(g_g).max() - g_g / np.abs(g_g).max()).max())
        d_sso = abs(float(sso) - float(golden["free_level_sso_in"][k]))
        d_np = abs(int(n_photo) - int(golden["free_level_n_photo_in"][k]))
        d_nd = abs(int(n_depth) - int(golden["free_level_n_depth_in"][k]))
        log(f"[golden] L{lv}: err rel {d_err:.2e} (<5e-4)  H {d_H:.2e} (<5e-4)  "
            f"g {d_g:.2e} (<5e-3)  sso {d_sso:.2e} (<1e-3)  "
            f"counts photo {d_np} depth {d_nd} (<=50)")
        if not (d_err < 5e-4 and d_H <= 5e-4 and d_g <= 5e-3 and d_sso < 1e-3
                and d_np <= 50 and d_nd <= 50):
            fail(f"level {lv} drifted from the golden f64 sweep")

    # forced schedule (test_forced_schedule_pose_below_1e3): poses composed
    # on the host in f64 so the gate measures the sweep path alone
    kf = int(golden["forced_iters"])
    pose = np.eye(4)
    for lv in range(n - 1, -1, -1):
        for _ in range(kf):
            _e, H, g, *_ = sweep_at(src, trg, jnp.asarray(pose, jnp.float32), lv)
            x, ok = linalg6.solve6_sym(H, g)
            if not bool(ok):
                fail(f"forced schedule: ill-posed system at level {lv}")
            pose = golden_ref.pseudo_exp(-np.asarray(x, np.float64)) @ pose
    d_pose = float(np.abs(pose - golden["forced_pose"]).max())
    log(f"[golden] forced-schedule pose max |diff| vs f64 reference {d_pose:.2e} (<1e-3)")
    if not d_pose < 1e-3:
        fail("forced-schedule pose drifted from the f64 reference")

    res = jax.device_get(photoicp.align_spheres_jit(
        gs, ds, gt, dt, jnp.eye(4), method=photoicp.PHOTO_DEPTH, n_levels=n,
    ))
    sig = tuple(int(x) for x in res.num_iterations)
    ok, reasons = bench.sanity_check(res.pose, float(res.error), res.ill_posed,
                                     res.num_iterations, golden=golden)
    log(f"[golden] free run: iteration signature {sig} (allowed "
        f"{sorted(bench.ALLOWED_SIGNATURES)}), |t| {np.linalg.norm(res.pose[:3, 3]):.4f} m "
        f"(golden {np.linalg.norm(golden['free_pose'][:3, 3]):.4f}), "
        f"error {float(res.error):.4f} (golden {float(golden['free_error']):.4f})")
    if not ok:
        fail(f"free run failed the sanity rails: {reasons}")


# ---------------------------------------------------------------------------
# phase 4: batched pair registration
# ---------------------------------------------------------------------------


def phase_batch(golden, card: str, batch: int = 8, reps: int = 10) -> None:
    import jax

    import bench
    from rgbd360_tpu.parallel.batch import align_batch

    pair = [np.broadcast_to(a, (batch,) + a.shape).copy() for a in bench.load_golden_pair(golden)]
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
    args = [jax.device_put(a) for a in (*pair, poses)]

    t0 = time.perf_counter()
    res = jax.block_until_ready(align_batch(*args))
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(align_batch(*args))
        times.append(time.perf_counter() - t0)
    res = jax.device_get(res)
    for b in range(batch):
        ok, reasons = bench.sanity_check(res.pose[b], float(res.error[b]), res.ill_posed[b],
                                         res.num_iterations[b], golden=golden)
        if not ok:
            fail(f"batch pair {b} failed the sanity rails: {reasons}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    med = float(np.median(times))
    log(f"[batch] align_batch batch {batch} at 320x1920: set-up (compile + first call) "
        f"{setup_s:.2f} s; warm call median {med * 1e3:.2f} ms "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}, {reps} calls) = "
        f"{batch / med:.2f} pairs/s; peak_bytes_in_use {peak}; card {card}")
    log(f"[batch] iteration signature {tuple(int(x) for x in res.num_iterations[0])}, "
        "all pairs inside the sanity rails")


# ---------------------------------------------------------------------------
# phase 5: KF-SLAM app end to end
# ---------------------------------------------------------------------------


class _FrameClock:
    """stdout wrapper that timestamps the app's per-frame status lines
    ("frame N: status ..."). The planes worker thread prints too, so writes
    are serialized and a status may share a line with a warning."""

    _STATUS = re.compile(r"frame (\d+): (\S+)")

    def __init__(self, inner):
        self.inner = inner
        self.buf = ""
        self.stamps = []  # (perf_counter, frame number, status)
        self.lock = threading.Lock()

    def write(self, s):
        with self.lock:
            self.inner.write(s)
            self.buf += s
            while "\n" in self.buf:
                line, self.buf = self.buf.split("\n", 1)
                now = time.perf_counter()
                for n, status in self._STATUS.findall(line):
                    self.stamps.append((now, int(n), status))
        return len(s)

    def flush(self):
        self.inner.flush()


def trajectory_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS position residual after the rigid (Kabsch) fit of est onto gt:
    the SLAM map frame and the ground-truth world frame differ by a rigid
    transform."""
    ce, cg = est.mean(axis=0), gt.mean(axis=0)
    u, _s, vt = np.linalg.svd((est - ce).T @ (gt - cg))
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    resid = (est - ce) @ rot.T + cg - gt
    return float(np.sqrt((resid ** 2).sum(axis=1).mean()))


def run_kf_slam(seq_dir: str, out_dir: str):
    """Run the KF-SLAM app through its main(); returns (status by frame
    number, per-frame wall times in s, first-frame time in s)."""
    from rgbd360_tpu.apps.kf_sphere_slam import main as slam_main

    clock = _FrameClock(sys.stdout)
    t_start = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        rc = slam_main([seq_dir, "--calib-root", seq_dir, "--out", out_dir])
    if rc != 0:
        fail(f"kf_sphere_slam exited {rc}")
    status = {n: st for _t, n, st in clock.stamps}
    dts = np.diff([t_start] + [t for t, _n, _st in clock.stamps])
    return status, dts[1:], float(dts[0])


def keyframe_ate(seq_dir: str, out_dir: str, status: dict) -> tuple:
    kf_frames = [n for n in sorted(status) if "keyframe" in status[n]]
    traj = np.loadtxt(os.path.join(out_dir, "trajectory_kf_slam.txt")).reshape(-1, 4, 4)
    gt = np.loadtxt(os.path.join(seq_dir, "poses_gt.txt")).reshape(-1, 4, 4)
    if len(kf_frames) != len(traj):
        fail(f"{len(kf_frames)} keyframe status lines but {len(traj)} trajectory poses")
    return kf_frames, trajectory_rmse(traj[:, :3, 3], gt[[n - 1 for n in kf_frames], :3, 3])


def plane_sets_twice(seq_dir: str):
    """The fused plane-statistics program and the host plane fit, twice on
    one frame. The program's float scatter-adds (ops/plane_stats.py,
    ops/planes_seg.py) run as atomics on the card, so sums may differ in the
    last bits from run to run, and a pixel whose refine decision sits on a
    threshold may change label (which can renumber or reorder the per-label
    stat rows). So the runs are compared as the SLAM loop consumes them: as
    fitted plane sets; the label mismatch is reported, not gated. Returns
    (label mismatch fraction, plane counts, max normal angle deg,
    max |d| diff m, max relative area diff)."""
    import types

    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.apps.common import load_calib
    from rgbd360_tpu.core.plane_extraction import (
        _fit_from_stats_buffer,
        _unpack_stats_buffer,
        build_sensor_plane_stats,
    )
    from rgbd360_tpu.io.boost_archive import read_frame360_bin

    raw = read_frame360_bin(os.path.join(seq_dir, "sphere_images_1.bin"))
    depth_m = jnp.asarray(raw.depth.astype(np.float32) * 0.001)  # identity CLAMS models
    frame = types.SimpleNamespace(depth_undistorted_m=depth_m, calib=load_calib(seq_dir))
    prog = jax.jit(build_sensor_plane_stats, static_argnames=("ship_labels",))
    bufs = [np.asarray(prog(depth_m, jnp.asarray(raw.rgb), ship_labels=True)) for _ in range(2)]
    h, w = raw.depth.shape[1] // 2, raw.depth.shape[2] // 2
    lab_a, lab_b = (_unpack_stats_buffer(b, h, w, ship_labels=True)[0] for b in bufs)
    pa, pb = (_fit_from_stats_buffer(frame, b, True)[0].planes for b in bufs)
    ang = dd = da = 0.0
    for p in pa:
        q = max(pb, key=lambda q: float(np.dot(p.normal, q.normal))
                - float(np.linalg.norm(np.asarray(p.center) - np.asarray(q.center))))
        cos = float(np.clip(np.dot(p.normal, q.normal), -1.0, 1.0))
        ang = max(ang, float(np.degrees(np.arccos(cos))))
        dd = max(dd, abs(float(p.d) - float(q.d)))
        da = max(da, abs(float(p.area_hull) - float(q.area_hull)) / max(float(p.area_hull), 1e-9))
    return float((lab_a != lab_b).mean()), (len(pa), len(pb)), ang, dd, da


def phase_kf_slam(card: str) -> None:
    sys.path.insert(0, REPO)
    from tools.make_synthetic_sequence import main as gen

    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "seq")
        out = os.path.join(tmp, "out")
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            if gen(["--out", seq, "--frames", str(SLAM_FRAMES), "--radius", str(SLAM_RADIUS)]) != 0:
                fail("synthetic sequence generation failed")
        status, dts, first = run_kf_slam(seq, out)
        for artifact in ("map.html", "pose_graph.g2o", "trajectory_kf_slam.txt"):
            if not os.path.exists(os.path.join(out, artifact)):
                fail(f"KF-SLAM artifact {artifact} missing")
        kf_frames, ate = keyframe_ate(seq, out, status)
        log(f"[kf-slam] {len(status)} frames, keyframes at frames {kf_frames}; keyframe "
            f"trajectory RMSE {ate:.4f} m (bound {SLAM_ATE_BOUND_M} m)")
        log(f"[kf-slam] first frame (includes compiles) {first:.2f} s; later frames "
            f"median {np.median(dts) * 1e3:.1f} ms, p90 {np.percentile(dts, 90) * 1e3:.1f} ms "
            f"({len(dts)} frames); card {card}")
        if len(kf_frames) < SLAM_MIN_KEYFRAMES:
            fail(f"only {len(kf_frames)} keyframes selected (need {SLAM_MIN_KEYFRAMES})")
        if not ate < SLAM_ATE_BOUND_M:
            fail(f"keyframe trajectory RMSE {ate:.4f} m over the {SLAM_ATE_BOUND_M} m bound")
        mismatch, counts, ang, dd, da = plane_sets_twice(seq)
    log(f"[kf-slam] plane program + fit run twice on frame 1: label mismatch "
        f"{mismatch:.2e}; planes {counts[0]} vs {counts[1]} (equal), max normal "
        f"angle {ang:.2e} deg (<=0.5), max |d| diff {dd:.2e} m (<=0.01), max relative "
        f"hull-area diff {da:.2e} (<=0.05)")
    if not (counts[0] == counts[1] and ang <= 0.5 and dd <= 0.01 and da <= 0.05):
        fail("plane sets differ between two runs beyond atomics-order noise")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four_cards(golden, card: str, batch: int = 8) -> None:
    import jax

    import __graft_entry__
    import bench

    devices = jax.devices()[:4]
    pair = [np.broadcast_to(a, (batch,) + a.shape).copy() for a in bench.load_golden_pair(golden)]
    # distinct pose guesses, so every pair of the batch is its own problem
    rng = np.random.default_rng(0)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
    poses[:, :3, 3] = rng.uniform(-0.02, 0.02, (batch, 3))
    t0 = time.perf_counter()
    report = __graft_entry__.sharded_parity(devices, *pair, poses, n_levels=5,
                                            log=lambda m: log(f"[four-cards] {m}"))
    log(f"[four-cards] all sharded paths match single device "
        f"({time.perf_counter() - t0:.1f} s incl. compiles; card {card}): {report}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    card = phase_device(n_cards)
    if not args.four_cards:
        phase_gpu_tests()

    import jax

    dev = jax.devices()[0]
    check_device_platform(dev.platform)
    golden = np.load(GOLDEN)
    if args.four_cards:
        phase_four_cards(golden, card)
    else:
        phase_golden(golden, card)
        phase_batch(golden, card)
        phase_kf_slam(card)
    print(result_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
