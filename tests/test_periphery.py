"""ICP, cloud filters, calibrator, viz dumps, ini parser."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from rgbd360_tpu.core.calibrator import (
    Calibrator,
    PairCalibrator,
    PlaneCorrespondences,
    construction_specs,
)
from rgbd360_tpu.io.ini import parse_ini
from rgbd360_tpu.ops import se3
from rgbd360_tpu.ops.filter_cloud import filter_euclidean, filter_voxel
from rgbd360_tpu.ops.icp import icp_point_to_plane_sphere


def _box_depth(h, w, pose=np.eye(4)):
    """Analytic spherical depth of a box scene seen from `pose` (camera pose
    in the box frame): per ray, the closest intersection with the 6 walls."""
    angle = 2 * np.pi / w
    rows = (0.5 * h - 0.5 - np.arange(h))[:, None] * angle
    cols = np.arange(w)[None, :] * angle
    u = np.stack(
        [
            np.broadcast_to(np.sin(rows), (h, w)),
            -np.cos(rows) * np.sin(cols),
            -np.cos(rows) * np.cos(cols),
        ],
        axis=-1,
    )
    # walls n.X = d in world; camera at pose: ray X = c + s * R u
    R, c = pose[:3, :3], pose[:3, 3]
    u_w = u @ R.T
    walls = [
        (np.array([1.0, 0, 0]), 2.0), (np.array([-1.0, 0, 0]), 2.0),
        (np.array([0, 1.0, 0]), 2.5), (np.array([0, -1.0, 0]), 2.5),
        (np.array([0, 0, 1.0]), 3.0), (np.array([0, 0, -1.0]), 3.0),
    ]
    depth = np.full((h, w), np.inf)
    for n, d in walls:
        denom = u_w @ n
        s = np.where(np.abs(denom) > 1e-9, (d - c @ n) / np.where(np.abs(denom) > 1e-9, denom, 1.0), np.inf)
        s = np.where(s > 0, s, np.inf)
        depth = np.minimum(depth, s)
    return depth.astype(np.float32)


def test_icp_recovers_small_pose(rng):
    h, w = 64, 256
    xi = np.array([0.03, -0.02, 0.04, 0.01, -0.012, 0.008], np.float32)
    pose_true = np.asarray(se3.exp_se3(jnp.asarray(xi), pseudo=False), np.float64)
    # target camera at origin; source camera displaced by pose_true
    # (pose maps source-frame points into the target/world frame)
    depth_trg = _box_depth(h, w)
    depth_src = _box_depth(h, w, pose_true)

    res = icp_point_to_plane_sphere(
        jnp.asarray(depth_src), jnp.asarray(depth_trg), jnp.eye(4)
    )
    err = np.abs(np.asarray(res.pose) - pose_true).max()
    assert int(res.num_inliers) > 5000
    assert err < 2e-3
    # nearest-pixel association leaves a small residual floor
    assert float(res.fitness) < 1e-4


def test_filter_euclidean_box():
    xyz = np.array([[0, 0, 0], [5, 0, 0], [-1, 2, 3], [0, 5, 0], [np.nan, 0, 0]])
    out = filter_euclidean(xyz)
    assert len(out) == 2  # origin and (-1,2,3)


def test_filter_voxel_merges():
    xyz = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [1.0, 1.0, 1.0]])
    out = filter_voxel(xyz, leaf=0.1)
    assert len(out) == 2
    np.testing.assert_allclose(sorted(out[:, 0]), [0.015, 1.0], atol=1e-9)


def _pair_correspondences(rt_true, n_planes, rng):
    """Planes observed by sensor1 (identity) and sensor2 (rt_true^-1 view)."""
    rows = []
    R, t = rt_true[:3, :3], rt_true[:3, 3]
    for _ in range(n_planes):
        n1 = rng.normal(size=3)
        n1 /= np.linalg.norm(n1)
        d1 = rng.uniform(1, 4)
        # plane in sensor2 coords: n2 = R^T n1, d2 = d1 + n1 . t
        n2 = R.T @ n1
        d2 = d1 + float(n1 @ t)
        rows.append(np.concatenate([n1, [d1], n2, [d2]]))
    return np.stack(rows)


def test_pair_calibrator_recovers_pose(rng):
    rt_true = np.eye(4)
    a = 0.3
    rt_true[:3, :3] = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    )
    rt_true[:3, 3] = [0.1, -0.05, 0.03]
    pc = PairCalibrator()
    pc.correspondences = _pair_correspondences(rt_true, 12, rng)
    est = pc.calibrate_pair()
    assert est is not None
    np.testing.assert_allclose(est, rt_true, atol=1e-6)


def test_pair_calibrator_rejects_degenerate(rng):
    # all normals identical: rotation unobservable
    pc = PairCalibrator()
    n = np.array([1.0, 0, 0])
    pc.correspondences = np.stack(
        [np.concatenate([n, [1.0 + 0.1 * k], n, [1.2 + 0.1 * k]]) for k in range(5)]
    )
    assert pc.calibrate_rotation() is None


def test_calibrator_chain(rng):
    specs = construction_specs()
    corresp = PlaneCorrespondences()
    for s in range(1, 8):
        rel = np.linalg.inv(specs[s - 1]) @ specs[s]
        for row in _pair_correspondences(rel, 10, rng):
            corresp.add(s - 1, s, row[:3], row[3], row[4:7], row[7])
        assert corresp.conditioning(s - 1, s) < 8000
    cal = Calibrator(corresp)
    rt = cal.calibrate_chained()
    for s in range(8):
        np.testing.assert_allclose(rt[s], specs[s], atol=1e-5)


def _rig_correspondences(rts, pairs, n_planes, rng, noise_n=0.0, noise_d=0.0):
    """All-pair control planes from a ground-truth rig: world plane (n, d_w)
    observed by sensor s as n_obs = R_s^T n, d_obs = d_w + n . t_s (the mrpt
    d = -normal.center convention, see Calibrator docstring)."""
    corresp = PlaneCorrespondences()
    for (i, j) in pairs:
        for _ in range(n_planes):
            n = rng.normal(size=3)
            n /= np.linalg.norm(n)
            d_w = rng.uniform(1.0, 4.0)
            obs = []
            for s in (i, j):
                n_o = rts[s][:3, :3].T @ n
                d_o = d_w + float(n @ rts[s][:3, 3])
                if noise_n:
                    n_o = n_o + rng.normal(scale=noise_n, size=3)
                    n_o /= np.linalg.norm(n_o)
                if noise_d:
                    d_o = d_o + rng.normal(scale=noise_d)
                obs.append((n_o, d_o))
            corresp.add(i, j, obs[0][0], obs[0][1], obs[1][0], obs[1][1])
    return corresp


RING_PAIRS = [(s, s + 1) for s in range(7)] + [(0, 7)]  # incl. the wraparound


def _relative_pose_error(rt_est, rt_true, pairs):
    err = 0.0
    for (i, j) in pairs:
        rel_e = np.linalg.inv(rt_est[i]) @ rt_est[j]
        rel_t = np.linalg.inv(rt_true[i]) @ rt_true[j]
        err += np.abs(rel_e - rel_t).max()
    return err


def test_joint_calibrator_recovers_rig(rng):
    """The 21-DoF joint solve recovers a perturbed rig from noise-free
    all-pair correspondences including the 7<->0 wraparound (reference
    Calibrator.h:871-1180) up to the documented gauge (global rotation from
    the X-axis alignment, global recentering)."""
    specs = construction_specs()
    truth = specs.copy()
    for s in range(1, 8):
        w = rng.normal(scale=np.deg2rad(1.0), size=3)
        truth[s, :3, :3] = truth[s, :3, :3] @ _so3(w)
        truth[s, :3, 3] += rng.normal(scale=0.005, size=3)
    corresp = _rig_correspondences(truth, RING_PAIRS, 10, rng)
    cal = Calibrator(corresp)
    rt = cal.calibrate()
    assert _relative_pose_error(rt, truth, RING_PAIRS) < 1e-4
    assert cal.rotation_error2(rt) < 1e-10


def test_joint_beats_chained_on_noisy_ring(rng):
    """With observation noise, chaining adjacent pairs accumulates error
    around the ring (it never sees the 7<->0 constraint); the joint solve
    distributes it (VERDICT r1 missing #4 'done' criterion)."""
    specs = construction_specs()
    corresp = _rig_correspondences(specs, RING_PAIRS, 12, rng, noise_n=0.01, noise_d=0.003)
    joint = Calibrator(corresp)
    joint.calibrate()
    chained = Calibrator(corresp)
    chained.rt = construction_specs()
    chained.calibrate_chained()
    err_joint = _relative_pose_error(joint.rt, specs, RING_PAIRS)
    err_chain = _relative_pose_error(chained.rt, specs, RING_PAIRS)
    assert err_joint < err_chain


def _so3(w):
    from rgbd360_tpu.core.calibrator import _exp_so3

    return _exp_so3(np.asarray(w, float))


def test_ini_parser(reference_root):
    sec = parse_ini(
        os.path.join(reference_root, "config_files/configLocaliser_sphericalOdometry.ini")
    )
    assert float(sec["unary"]["dist_d"]) == 0.5
    assert float(sec["binary"]["angle_threshold"]) == 10.0
    assert float(sec["unary"]["hue_threshold"]) == 0.35


def test_viz_dumps(tmp_path, rng):
    from rgbd360_tpu.utils.viz import save_ply, save_pcd, save_png, save_trajectory

    img = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
    save_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "t.png").stat().st_size > 0
    xyz = rng.normal(size=(10, 3)).astype(np.float32)
    save_ply(str(tmp_path / "t.ply"), xyz, np.full((10, 3), 128, np.uint8))
    assert "element vertex 10" in (tmp_path / "t.ply").read_text()
    save_pcd(str(tmp_path / "t.pcd"), xyz)
    assert "POINTS 10" in (tmp_path / "t.pcd").read_text()
    save_trajectory(str(tmp_path / "traj.txt"), [np.eye(4)] * 3)
    assert len((tmp_path / "traj.txt").read_text().splitlines()) == 12


def test_laser_calibrator_app_demo(capsys):
    from rgbd360_tpu.apps.calibrate_laser import main as laser_main

    assert laser_main(["--demo"]) == 0
    out = capsys.readouterr().out
    assert "ground-truth error" in out


def test_tof_calibrator_app_demo(capsys):
    from rgbd360_tpu.apps.tof_calibrator import main as tof_main

    assert tof_main(["--demo"]) == 0
    out = capsys.readouterr().out
    assert "tof-from-rgbd extrinsic estimate" in out


def test_online_odometry_synthetic(tmp_path, capsys, nominal_root):
    """OnlineOdometryRGBD360 equivalent on the synthetic grabber source."""
    from rgbd360_tpu.apps.online_odometry import main as online_main

    assert online_main(
        ["--synthetic", "2", "--calib-root", nominal_root, "--out", str(tmp_path)]
    ) == 0
    assert (tmp_path / "trajectory_online.txt").exists()


def test_register_sequence_label_on_room(tmp_path, calib):
    """RegisterSequenceSphere_labelFast equivalent: unlabeled keyframes are
    skipped, labeled pairs are PbMap-registered (PLANAR_3DoF) and the chained
    pose recovers the synthetic motion."""
    import numpy as np
    from room_scene import room_frame

    from rgbd360_tpu.apps.register_sequence_label import run
    from rgbd360_tpu.core.labelization import labelize_frame

    rel = np.eye(4)
    rel[1, 3] = 0.25
    rel[2, 3] = -0.1
    f0 = room_frame(calib, np.eye(4), 0)
    f1 = room_frame(calib, None, 1)  # stays unlabeled -> must be skipped
    f2 = room_frame(calib, rel, 2)
    labelize_frame(f0, {p.id: f"face{p.id}" for p in f0.planes.planes[:4]})
    labelize_frame(f2, {p.id: f"face{p.id}" for p in f2.planes.planes[:4]})
    for i, f in enumerate((f0, f1, f2)):
        f.build_sphere_cloud_from_image()
        f.save(str(tmp_path), i)

    stats = run(str(tmp_path), out_dir=str(tmp_path / "out"))
    assert stats["labelized"] == 1 and stats["unlabelized"] == 1
    final = stats["trajectory"][-1]
    assert abs(np.linalg.norm(final[:3, 3]) - np.linalg.norm(rel[:3, 3])) < 0.08
    assert (tmp_path / "out" / "trajectory.txt").exists()


def test_sequence_frames_prefetched(calib, reference_root):
    """apps/common.sequence_frames: the C++-prefetched sequence iterator
    yields built frames identical to the synchronous Frame360.build path."""
    import jax.numpy as jnp

    from rgbd360_tpu.apps.common import sequence_frames
    from rgbd360_tpu.core.frame360 import Frame360

    seq = list(sequence_frames(calib, os.path.join(reference_root, "samples"), 1, 9))
    assert [n for n, _ in seq] == [1, 10]
    direct = Frame360(calib, 1).build(
        os.path.join(reference_root, "samples", "sphere_images_1.bin")
    )
    np.testing.assert_array_equal(
        np.asarray(seq[0][1].sphere_depth_mm), np.asarray(direct.sphere_depth_mm)
    )
    np.testing.assert_array_equal(
        np.asarray(seq[0][1].sphere_rgb), np.asarray(direct.sphere_rgb)
    )


def test_stage_timing_brackets(calib, reference_root, capsys):
    """utils/timing: the reference's stage-timing stdout oracle (Frame360.h
    :295-308,:403-404,:626-627) — brackets print and accumulate when enabled,
    are silent when disabled."""
    from rgbd360_tpu.core.frame360 import Frame360
    from rgbd360_tpu.utils.timing import reset_timing, stage_timing, timing_summary

    path = os.path.join(reference_root, "samples", "sphere_images_1.bin")
    stage_timing(True)
    reset_timing()
    try:
        Frame360(calib, 0).build(path)
    finally:
        stage_timing(False)
    out = capsys.readouterr().out
    assert "Frame360.loadFrame took" in out
    assert "Frame360.stitchSphericalImage took" in out
    summary = timing_summary()
    assert summary["Frame360.undistort"][1] == 1
    reset_timing()
    Frame360(calib, 0).build(path)
    assert "took" not in capsys.readouterr().out
    assert not timing_summary()


def test_load_stereo_app_smoke(tmp_path, capsys, rng):
    """LoadFrame360_stereo app end-to-end: PNG + raw depth -> artifacts +
    getPlanesStereo table (reference Visualization/LoadFrame360_stereo.cpp)."""
    from PIL import Image

    from rgbd360_tpu.apps.load_stereo import main as stereo_main
    from rgbd360_tpu.core.frame360_stereo import write_stereo_depth

    h, w = 64, 256
    rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "pano.png")
    depth = np.full((h, w), 3.0, np.float32)
    depth[:20] = 1.5
    write_stereo_depth(str(tmp_path / "pano_d.bin"), depth)
    out = tmp_path / "out"
    assert (
        stereo_main(
            [str(tmp_path / "pano.png"), str(tmp_path / "pano_d.bin"),
             "--out", str(out), "--planes"]
        )
        == 0
    )
    assert (out / "stereo_cloud.pcd").exists()
    assert (out / "stereo_rgb.png").exists()
    text = capsys.readouterr().out
    assert "planes:" in text and "depth coverage" in text


def test_map_html_viewer(tmp_path):
    """Explorable offline map artifact (replacement for the reference's live
    viewer, Map360_Visualizer.h:95-319): trajectory, frusta, plane hulls,
    LC edges and a cloud all embedded in one self-contained HTML file."""
    from types import SimpleNamespace

    from rgbd360_tpu.core.map360 import Map360
    from rgbd360_tpu.core.pbmap import PbMap, Plane
    from rgbd360_tpu.utils.map_html import map_to_html

    world = Map360()
    hull = np.array([[0, 0, 2.0], [1, 0, 2.0], [1, 1, 2.0], [0, 1, 2.0]])
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = i * 0.5
        plane = Plane(
            id=0, normal=np.array([0.0, 0.0, -1.0]), center=hull.mean(0),
            curvature=0.01, hull=hull, area_hull=1.0,
            main_color=np.array([0.2, 0.4, 0.6]),
        )
        xyz = np.zeros((100, 3), np.float32)
        frame = SimpleNamespace(
            planes=PbMap([plane]),
            sphere_cloud=(xyz, np.full((100, 3), 128, np.uint8)),
        )
        world.add_keyframe(frame, T)
    world.add_connection(0, 1, np.eye(4), np.eye(6))
    world.add_connection(0, 3, np.eye(4), np.eye(6))  # the LC edge
    world.optimized_poses = list(world.trajectory_poses)

    out = tmp_path / "map.html"
    map_to_html(str(out), world, cloud_stride=10)
    text = out.read_text()
    assert "<canvas" in text and "http" not in text.split("</title>")[1]
    import json as _json

    # `let` (not const): the live viewer (utils/live_viewer.py) reassigns D
    # when it polls for an updated snapshot of the same page template
    data = _json.loads(text.split("let D=")[1].split(";\n")[0])
    assert len(data["traj"]) == 4 and len(data["opt"]) == 4
    assert len(data["planes"]) == 4 and len(data["lc"]) == 1
    assert data["lc"][0] == [[0.0, 0.0, 0.0], [1.5, 0.0, 0.0]]
    # world-frame hulls: kf1's plane shifted by +0.5 in x
    assert data["planes"][1]["hull"][0][0] == 0.5
    assert len(data["pts"]) == 4 * 10 and len(data["ptc"]) == 4 * 10
    assert len(data["frusta"]) == 4 * 8
