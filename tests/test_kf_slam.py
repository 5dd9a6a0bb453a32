"""Keyframe-selection SLAM semantics (reference SLAM/KFsphere_SLAM.cpp).

The control flow — strong-PbMap frame skipping, the dense avDepthResidual
keyframe criterion, the nearby-KF connection scan with skip/switch, dual
dense+PbMap edges, optimization on new connections — is host-side logic, so
it is driven here with scripted registration results over a 20-frame
synthetic sequence (asserting ≪20 keyframes and multi-edges), plus a smoke
test on the real bundled pair through the real dense aligner.
"""

import os
import numpy as np
import pytest

from rgbd360_tpu.core import kf_slam
from rgbd360_tpu.core.kf_slam import KFSphereSLAM


class _Frame:
    """Minimal stand-in carrying what the tracker touches."""

    def __init__(self, fid):
        self.fid = fid
        self.sphere_rgb = fid  # opaque tokens handed to the fake aligner
        self.sphere_depth_mm = fid
        self.planes = None
        self.id = None
        self.node = None
        self.pose = None


def _pose(tx, ty=0.0, rz_deg=0.0):
    p = np.eye(4)
    a = np.deg2rad(rz_deg)
    p[0, 0] = p[1, 1] = np.cos(a)
    p[0, 1] = -np.sin(a)
    p[1, 0] = np.sin(a)
    p[0, 3] = tx
    p[1, 3] = ty
    return p


class FakeRegisterer:
    """Scripted RegisterPbMap: script[(kf_token, frame_token)] ->
    (ok, matches, area, pose). Default: weak failure."""

    def __init__(self, script):
        self.script = script
        self._last = (False, 0, 0.0, np.eye(4))

    def register_pbmap(self, kf_frame, frame, max_planes, mode):
        key = (kf_frame.fid, frame.fid)
        self._last = self.script.get(key, (False, 0, 0.0, np.eye(4)))
        return self._last[0]

    def get_pose(self):
        return self._last[3].astype(np.float32)

    def get_matched_planes(self):
        return {i: i for i in range(self._last[1])}

    def get_area_matched(self):
        return self._last[2]

    def get_info_mat(self):
        return np.eye(6, dtype=np.float32) * 10.0


class FakeAligner:
    """Scripted dense aligner: script[(target_token, source_token)] ->
    (residual, rel_pose_cloud_frame). The tracker hands the aligner
    sphere-frame seeds and expects sphere-frame optima; the fake converts
    its cloud-frame script through the same 157.5deg conjugation."""

    def __init__(self, script):
        self.script = script
        from rgbd360_tpu.apps.common import rot_offset

        self._off = rot_offset()
        self._target = None
        self._source = None
        self._resid = None
        self._pose_ref = None

    def set_target_frame(self, rgb, depth):
        self._target = rgb

    def set_source_frame(self, rgb, depth):
        self._source = rgb

    def align_frames360(self, seed, method, occlusion=0):
        key = (self._target, self._source)
        assert key in self.script, f"unscripted dense align {key}"
        self._resid, rel_cloud = self.script[key]
        self._pose_ref = self._off @ rel_cloud @ np.linalg.inv(self._off)
        return self._pose_ref.astype(np.float32)

    def get_optimal_pose(self):
        return self._pose_ref.astype(np.float32)

    def get_hessian(self):
        return np.eye(6, dtype=np.float32) * 100.0

    @property
    def av_depth_residual(self):
        return self._resid

    @property
    def sso(self):
        return 0.8


def test_kf_selection_scenario():
    """20 frames -> 3 keyframes: strong-PbMap skips, dense-residual skips,
    a dual-edged keyframe, a loop-closure keyframe, and a skip-near-KF with
    nearestKF switch (reference :354-470, :542-553)."""
    strong = (True, 7, 15.0, _pose(0.01))
    agree = (True, 4, 8.0, _pose(0.22))  # >= 4 matches, area > 6, agrees with dense
    weak = (False, 0, 0.0, np.eye(4))

    kf0, kf6, kf10 = 0, 6, 10
    pb_script = {}
    dense_script = {}
    for f in (1, 2, 3, 4):
        pb_script[(kf0, f)] = strong
    pb_script[(kf0, 5)] = weak
    dense_script[(kf0, 5)] = (0.5, _pose(0.1))  # tracked, no KF
    pb_script[(kf0, 6)] = agree
    dense_script[(kf0, 6)] = (1.2, _pose(0.2))  # keyframe (dual edge: pose agrees)
    for f in (7, 8, 9):
        pb_script[(kf6, f)] = strong
    pb_script[(kf6, 10)] = weak
    dense_script[(kf6, 10)] = (1.0, _pose(0.3))  # keyframe candidate
    # nearby scan hits kf0 (within 2.5 m): dense connection + PbMap LC edge.
    # The scan result must differ from the previous dense result by > 0.2 m
    # (reference :430 SKIPS near-identical consecutive results as degenerate
    # — the round-3 fix of the previously inverted check): 0.55 vs 0.3.
    dense_script[(kf0, 10)] = (1.5, _pose(0.55))
    pb_script[(kf0, 10)] = (True, 6, 30.0, _pose(0.55))  # > 5 matches, area > 25
    for f in (11, 12, 13, 14):
        pb_script[(kf10, f)] = strong
    pb_script[(kf10, 15)] = weak
    dense_script[(kf10, 15)] = (1.1, _pose(0.05))  # candidate...
    # ...but actually near kf0: skip+switch (0.4 differs from 0.05 by > 0.2,
    # so the :430 degenerate-result skip does not engage)
    dense_script[(kf0, 15)] = (0.4, _pose(0.4))
    dense_script[(kf6, 15)] = (1.9, _pose(0.1))  # unreachable: the kf0 hit returns first
    for f in (16, 17, 18, 19):
        pb_script[(kf0, f)] = strong  # nearest switched to kf0

    slam = KFSphereSLAM(
        registerer=FakeRegisterer(pb_script), aligner=FakeAligner(dense_script)
    )
    statuses = [slam.process_frame(_Frame(f)) for f in range(20)]

    assert statuses[0] == "first_keyframe"
    assert statuses[1:5] == ["skip_pbmap"] * 4
    assert statuses[5] == "skip_tracked"
    assert statuses[6] == "keyframe"
    assert statuses[7:10] == ["skip_pbmap"] * 3
    assert statuses[10] == "keyframe+lc"
    assert statuses[11:15] == ["skip_pbmap"] * 4
    assert statuses[15] == "skip_near_kf"
    assert statuses[16:] == ["skip_pbmap"] * 4

    # 3 keyframes out of 20 frames — bounded map growth
    assert len(slam.world) == 3
    assert slam.n_keyframes_selected == 3
    # nearestKF switched back to kf id 0 by the near-KF skip
    assert slam.nearest_kf == 0
    # edges: kf1 gets dense+PbMap dual edges to kf0; kf2 gets dense edge to
    # kf1 plus dense+PbMap loop-closure edges to kf0 -> 5 total
    assert len(slam.optimizer.edges) == 5
    assert slam.n_loop_closures == 2
    # the loop closure triggered an optimization
    assert len(slam.world.optimized_poses) == 3


def test_kf_slam_real_pair(sample_frames, reference_root):
    """Real bundled pair: the dense residual is low (~0.29 < 0.9) but the
    27 cm jump from the identity seed violates the 0.2 m continuous-motion
    gate (KFsphere_SLAM.cpp:388), so the reference promotes the frame to a
    keyframe with a dense edge to the first."""
    from rgbd360_tpu.apps.common import default_matcher_config

    f1, f2 = sample_frames
    f1.get_planes()
    f2.get_planes()
    slam = KFSphereSLAM(matcher_config=default_matcher_config(), n_pyr_levels=5)
    assert slam.process_frame(f1) == "first_keyframe"
    status = slam.process_frame(f2)
    assert status == "keyframe"
    assert len(slam.world) == 2
    assert slam.nearest_kf == 1
    # the dense edge to KF 0 exists with the registered ~0.23-0.33 m motion
    rel, info = slam.world.connection_kfs[1][0]
    assert 0.15 < np.linalg.norm(rel[:3, 3]) < 0.45


def test_loop_drift_correction_end_to_end(calib):
    """Integrated loop-closure drift correction: real room frames, real
    PbMap registrations for the edges, odometry drift injected on the chain;
    the loop-closure edge plus graph optimization must pull the final pose
    back toward ground truth (the end-to-end point of SURVEY §1 L6)."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from room_scene import room_frame

    from rgbd360_tpu.core.graph_optimizer import GraphOptimizer
    from rgbd360_tpu.core.matcher import PLANAR_3DOF
    from rgbd360_tpu.core.register_rgbd360 import RegisterRGBD360

    def pose_y(y, z=0.0):
        p = np.eye(4)
        p[1, 3] = y
        p[2, 3] = z
        return p

    gt = [pose_y(0.0), pose_y(0.45, -0.15), pose_y(0.08, 0.05)]  # loop back
    frames = [room_frame(calib, g, i) for i, g in enumerate(gt)]

    reg = RegisterRGBD360()
    rels = []
    for a, b in ((0, 1), (1, 2)):
        assert reg.register_pbmap(frames[a], frames[b], 25, PLANAR_3DOF)
        rels.append((reg.get_pose().astype(np.float64), reg.get_info_mat()))

    # inject odometry drift: 6 cm off along y on each chain edge
    drift = np.eye(4)
    drift[1, 3] = 0.06
    drifted_rels = [(drift @ rel, info) for rel, info in rels]

    opt = GraphOptimizer()
    poses = [np.eye(4)]
    for rel, _ in drifted_rels:
        poses.append(poses[-1] @ rel)
    for p in poses:
        opt.add_vertex(p)
    for i, (rel, info) in enumerate(drifted_rels):
        opt.add_edge(i, i + 1, rel, info)

    drift_err = np.linalg.norm(poses[2][:3, 3] - gt[2][:3, 3])
    assert drift_err > 0.1  # the injected drift is visible

    # loop closure: real registration frame2 -> frame0, undrifted
    assert reg.register_pbmap(frames[0], frames[2], 25, PLANAR_3DOF)
    lc_rel = reg.get_pose().astype(np.float64)
    # weight the loop edge by its (real) information matrix
    opt.add_edge(0, 2, lc_rel, reg.get_info_mat())
    opt.optimize_graph(iterations=15)
    optimized = opt.get_poses()

    opt_err = np.linalg.norm(optimized[2][:3, 3] - gt[2][:3, 3])
    assert opt_err < 0.6 * drift_err, f"drift {drift_err:.3f} -> optimized {opt_err:.3f}"
    assert opt_err < 0.08, f"optimized error {opt_err:.3f} m"


def test_speculative_align_is_outcome_identical(calib, monkeypatch):
    """prefetch_align (the planes_pipeline pre_collect hook) dispatches the
    step-2 tracking alignment early; _dense_align reuses the in-flight
    result when frame/keyframe/seed match. The speculative run must produce
    EXACTLY the per-frame kinds and trajectory of the plain run — same
    jitted program, same inputs, just issued earlier. STRONG_PBMAP gates
    are raised so every frame reaches the dense step (a box room tracks
    too well to exercise the reuse path otherwise)."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from room_scene import room_frame

    monkeypatch.setattr(kf_slam, "STRONG_PBMAP_MATCHES", 99)

    def pose_y(y):
        p = np.eye(4)
        p[1, 3] = y
        return p

    gt = [pose_y(0.0), pose_y(0.12), pose_y(0.5), pose_y(0.62)]

    def run(spec):
        slam = KFSphereSLAM(speculative_align=spec)
        kinds = []
        for i, g in enumerate(gt):
            f = room_frame(calib, g, i)
            if spec:
                slam.prefetch_align(f)  # what planes_pipeline's hook does
            kinds.append(slam.process_frame(f))
        traj = [np.asarray(p).copy() for p in slam.world.trajectory_poses]
        return (kinds, traj, slam._spec_hits) if spec else (kinds, traj)

    kinds_plain, traj_plain = run(False)
    kinds_spec, traj_spec, hits = run(True)
    assert kinds_plain == kinds_spec
    assert "skip_tracked" in kinds_plain or "keyframe" in kinds_plain  # non-vacuous
    # the reuse path must actually FIRE: outcome identity alone cannot detect
    # a regressed spec key (the fallback recomputes identical results, so the
    # feature could be silently dead while every assert stays green)
    assert hits > 0, "speculative reuse never fired — spec key regressed"
    np.testing.assert_array_equal(np.stack(traj_plain), np.stack(traj_spec))
