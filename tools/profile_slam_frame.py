"""Per-stage bisect of the KF-SLAM frame loop on a real sequence.

A per-stage breakdown of the SLAM frame (not measured on the H100 yet),
separating:

  - frame build       (load + undistort + stitch dispatch; host-blocking part)
  - planes dispatch   (build_sensor_plane_stats jit call issue)
  - planes collect    (np.asarray sync on the stats buffer = RTT + residual
                       device time not hidden by the lookahead)
  - planes host fit   (_fit_from_stats_buffer: qhull + plane objects)
  - register_pbmap    (host interpretation-tree match)
  - Dense alignment   (facade bracket: dispatch + packed-fetch sync)
  - process_frame     (total, per returned frame kind)

Usage:  python tools/profile_slam_frame.py [seq_dir] [n_frames]
(defaults /tmp/room_seq, all frames). Mirrors the reference's stdout timing
oracle stage names where they exist (Frame360.h:295-308,626-627;
RegisterRGBD360.h:298-299; RegisterPhotoICP.h:4522,4776).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbd360_tpu.utils.timing import stage, stage_timing, timing_summary

stage_timing(True)

import rgbd360_tpu.core.plane_extraction as pe
from rgbd360_tpu.apps.common import default_matcher_config, load_calib, sequence_frames
from rgbd360_tpu.core.kf_slam import KFSphereSLAM
from rgbd360_tpu.core.register_rgbd360 import RegisterRGBD360


def timed_frames(gen):
    it = iter(gen)
    while True:
        with stage("frame build (load+undistort+stitch dispatch)"):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def profiled_pipeline(frames_iter, pre_collect=None):
    """The REAL planes_pipeline — it carries its own stage brackets
    (no-ops unless timing is enabled), so the profiler measures the shipped
    schedule rather than a hand-maintained copy of it."""
    return pe.planes_pipeline(frames_iter, pre_collect=pre_collect)


def main():
    # the profiler measures the SHIPPED schedule only: fused per-frame
    # device program + speculative align dispatch; outcome identity of the
    # speculative path is gated by test_speculative_align_is_outcome_identical.
    args = list(sys.argv[1:])
    seq = args[0] if args else "/tmp/room_seq"
    limit = int(args[1]) if len(args) > 1 else 10**9

    orig_reg = RegisterRGBD360.register_pbmap
    pb_strength = []  # (ok, n_matches, area) of the TRACKING call per frame

    def reg_wrapped(self, *a, **k):
        with stage("register_pbmap (host)"):
            ok = orig_reg(self, *a, **k)
        pb_strength.append(
            (bool(ok), len(self.get_matched_planes()), float(self.get_area_matched()))
        )
        return ok

    RegisterRGBD360.register_pbmap = reg_wrapped

    # the sequence directory is its own data root (make_synthetic_sequence)
    calib = load_calib(seq)
    slam = KFSphereSLAM(matcher_config=default_matcher_config(seq))
    slam.aligner.prewarm()

    times, kinds, pb_track = [], [], []
    t_prev = time.perf_counter()
    for frame_no, frame in profiled_pipeline(
        timed_frames(sequence_frames(calib, seq, 1, 1, defer_device=True)),
        pre_collect=slam.prefetch_align,
    ):
        pb_at = len(pb_strength)
        with stage("process_frame"):
            kind = slam.process_frame(frame)
        # first register_pbmap inside this frame = the TRACKING call (the
        # nearby-KF scan may add more on keyframe frames)
        pb_track.append(pb_strength[pb_at] if len(pb_strength) > pb_at else None)
        t_now = time.perf_counter()
        times.append((t_now - t_prev) * 1e3)
        kinds.append(kind)
        t_prev = t_now
        print(f"frame {frame_no}: {kind} {times[-1]:.1f} ms")
        if len(times) >= limit:
            break

    # speculative-dispatch accounting: wasted dispatches occupy the device
    # conveyor without ever being read — the adaptive skip policy's miss
    # rate is the lever
    n_spec = slam._spec_seq
    print(
        f"\nspec dispatches={n_spec} consumed={slam._spec_hits} "
        f"wasted={n_spec - slam._spec_hits}  kinds={''.join(k[5] if k.startswith('skip_') else k[0] for k in kinds)}"
    )
    # predictor fodder: the TRACKING registration's strength per frame vs
    # the NEXT frame's outcome (does a weak pbmap success predict that the
    # next frame needs the dense align?)
    print("pbmap TRACKING strength (ok,matches,area) -> next kind:")
    for i, st_ in enumerate(pb_track):
        nxt = kinds[i + 1] if i + 1 < len(kinds) else "-"
        if st_ is None:
            print(f"  frame#{i}: (no pbmap call) -> {nxt}")
        else:
            print(f"  frame#{i}: ok={st_[0]} m={st_[1]} a={st_[2]:.1f} -> {nxt}")
    print("\n==== per-kind frame wall (after 5-frame warmup) ====")
    arr = np.array(times[5:])
    ks = kinds[5:]
    for k in sorted(set(ks)):
        sel = arr[[i for i, x in enumerate(ks) if x == k]]
        print(f"{k}: n={len(sel)} median={np.median(sel):.1f} ms p90={np.percentile(sel, 90):.1f} ms")
    print(f"ALL steady-state: median={np.median(arr):.1f} ms")

    print("\n==== stage summary (mean over all frames incl. warmup) ====")
    for name, (total, count, mean) in sorted(timing_summary().items()):
        print(f"{name:48s} n={count:3d} mean={mean:8.2f} ms total={total:9.1f} ms")


if __name__ == "__main__":
    main()
