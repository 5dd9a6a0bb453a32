"""LoopClosure360 — loop-closure search (reference include/LoopClosure360.h).

For each new keyframe: scan candidates (same-area KFs at least 6 m of
trajectory apart within a distance threshold, plus the selected KFs of other
areas within 5 m), register PbMaps (PLANAR_3DoF, accept at >=5 matches and
matched area > 15), refine with the dense spherical aligner seeded through
the 157.5 deg rotOffset conjugation, and accept when avDepthResidual < 2.0
— then add the graph edge, the map connection and the SSO handoff entry
(reference :108-378).

The reference runs this on a background thread synchronizing via the map
mutex and the connectionsLC handoff; here the same search is exposed both
synchronously (`process_new_keyframe`, deterministic, used by tests and the
apps) and as a daemon thread (`start`/`stop`) mirroring the reference's
threading (ctor at :83-94).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from rgbd360_tpu.core.map360 import Map360
from rgbd360_tpu.core.matcher import PLANAR_3DOF
from rgbd360_tpu.core.register_photoicp import PHOTO_DEPTH, RegisterPhotoICP
from rgbd360_tpu.core.register_rgbd360 import RegisterRGBD360

MIN_MATCHES = 5  # reference :297
MIN_AREA_MATCHED = 15.0  # reference :298
MAX_DEPTH_RESIDUAL = 2.0  # reference :316
MIN_TRAJECTORY_GAP = 6.0  # metres of trajectory between candidates (:173-179)
MAX_CANDIDATE_DIST = 5.0  # metres (:291-294)
# sphere-vs-cloud frame offset (:125-126); one shared 157.5-deg helper
from rgbd360_tpu.apps.common import rot_offset  # noqa: E402


class LoopClosure360:
    def __init__(
        self,
        map360: Map360,
        optimizer=None,
        config_file: Optional[str] = None,
        n_pyr_levels: int = 5,
    ):
        self.map = map360
        self.optimizer = optimizer
        self.registerer = RegisterRGBD360(config_file)
        self.aligner = RegisterPhotoICP(n_pyr_levels)
        self.rot_offset = rot_offset()
        # kf -> {other: sso} handoff to the SLAM loop (reference connectionsLC)
        self.connections_lc: Dict[int, Dict[int, float]] = {}
        self._queue: "queue.Queue[int]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- candidate scan (reference :173-294) -------------------------------------
    def _candidates(self, kf_id: int):
        """NB: callers must hold map.mutex — the threaded mode scans areas /
        selected_kfs that the SLAM loop's partitioner mutates (the reference
        reads these unlocked, a known-benign-by-usage race SURVEY §5 says
        not to replicate)."""
        m = self.map
        new_pose = m.trajectory_poses[kf_id]
        area = m.frames[kf_id].node
        cands = []
        for other in sorted(m.areas[area], reverse=True):
            if other == kf_id:
                continue
            gap = m.trajectory_increments[kf_id] - m.trajectory_increments[other]
            if gap < MIN_TRAJECTORY_GAP:
                continue
            dist = float(
                np.linalg.norm(new_pose[:3, 3] - m.trajectory_poses[other][:3, 3])
            )
            if dist < MAX_CANDIDATE_DIST:
                cands.append(other)
        for other_area, selected in enumerate(m.selected_kfs):
            if other_area == area or other_area >= len(m.areas) or not m.areas[other_area]:
                continue
            if selected >= kf_id:
                # threaded mode: the SLAM loop may have added keyframes (and
                # the partitioner elected them selected-KFs) after kf_id was
                # enqueued; a closure against a NEWER keyframe belongs to
                # that keyframe's own scan — and Map360.add_connection
                # requires kf1 < kf2, so accepting one here would abort
                # phase 3 mid-drain
                continue
            dist = float(
                np.linalg.norm(
                    new_pose[:3, 3] - m.trajectory_poses[selected][:3, 3]
                )
            )
            if dist < MAX_CANDIDATE_DIST:
                cands.append(selected)
        return cands

    # -- one keyframe (reference run() body, :108-378) ----------------------------
    def process_new_keyframe(self, kf_id: int) -> int:
        """Search loop closures for kf_id. Returns the number accepted.

        Candidate PbMaps are screened by one batched device compatibility
        evaluation (core/batch_match.py, a strict relaxation of the exact
        matcher) before the per-candidate registration — SURVEY §2.3's
        batched LC-candidate search."""
        m = self.map
        new_kf = m.frames[kf_id]
        accepted = 0
        with m.mutex:
            cands = self._candidates(kf_id)
        if len(cands) > 1 and new_kf.planes is not None and all(
            m.frames[c].planes is not None for c in cands
        ):
            from rgbd360_tpu.core.batch_match import prefilter_candidates

            counts, areas = prefilter_candidates(
                new_kf.planes,
                [m.frames[c].planes for c in cands],
                self.registerer.matcher.config,
                PLANAR_3DOF,
            )
            cands = [
                c for k, c in enumerate(cands)
                if counts[k] >= MIN_MATCHES and areas[k] > MIN_AREA_MATCHED
            ]
        # phase 1 (host): exact PbMap registration per candidate; survivors
        # carry their seed pose into the dense phase
        survivors = []  # (cand_id, seed pose in sphere frame)
        for cand in cands:
            cand_kf = m.frames[cand]
            ok = self.registerer.register_pbmap(cand_kf, new_kf, 25, PLANAR_3DOF)
            # reference gates STRICTLY greater than the thresholds (:297-298)
            if (
                not ok
                or len(self.registerer.get_matched_planes()) <= MIN_MATCHES
                or self.registerer.get_area_matched() <= MIN_AREA_MATCHED
            ):
                continue
            rel = self.registerer.get_pose()
            # dense refinement through the sphere-frame conjugation (:309-313).
            # Frame roles: TARGET = candidate (older), SOURCE = new keyframe,
            # so the optimal pose is X_cand^-1 X_new — the same direction as
            # the PbMap seed above, the tracking edges, and the optimizer's
            # edge convention z = X_i^-1 X_j (the previous swapped roles
            # seeded the aligner with the inverse and stored inverted
            # loop-closure constraints that pulled optimization the wrong way)
            guess = self.rot_offset @ rel @ np.linalg.inv(self.rot_offset)
            survivors.append((cand, guess))

        # phase 2 (device): dense refinement — ONE batched align for >=2
        # survivors (SURVEY §2.3 batched LC-candidate kernels; the reference
        # loops alignFrames360 per candidate, LoopClosure360.h:297-316),
        # the facade path for a single one
        results = []  # (cand_id, pose_sphere, av_depth, H, sso)
        if len(survivors) >= 2:
            results = self._refine_batch(new_kf, survivors)
        elif survivors:
            cand, guess = survivors[0]
            cand_kf = m.frames[cand]
            self.aligner.set_target_frame(cand_kf.sphere_rgb, cand_kf.sphere_depth_mm)
            self.aligner.set_source_frame(new_kf.sphere_rgb, new_kf.sphere_depth_mm)
            self.aligner.align_frames360(guess, PHOTO_DEPTH)
            # same ill-posed filter _refine_batch applies: a singular system
            # leaves the pose at the PbMap seed with a degenerate Hessian
            if not self.aligner.ill_posed:
                results = [
                    (
                        cand,
                        self.aligner.get_optimal_pose(),
                        float(self.aligner.av_depth_residual),
                        self.aligner.get_hessian(),
                        float(self.aligner.sso),
                    )
                ]

        # phase 3 (host): acceptance + graph wiring (:316-323)
        for cand, pose_sphere, av_depth, info, sso in results:
            if av_depth >= MAX_DEPTH_RESIDUAL:
                continue
            rel = (
                np.linalg.inv(self.rot_offset)
                @ pose_sphere.astype(np.float64)
                @ self.rot_offset
            )
            with m.mutex:  # the SLAM loop drains connections_lc and runs
                # optimize_graph under the same mutex (RLock: re-entrant for
                # the synchronous caller)
                if self.optimizer is not None:
                    self.optimizer.add_edge(cand, kf_id, rel, info)
                m.add_connection(cand, kf_id, rel, info)
                self.connections_lc.setdefault(kf_id, {})[cand] = sso
            accepted += 1
        return accepted

    def _refine_batch(self, new_kf, survivors):
        """One vmapped align_batch call over all surviving candidates: the
        new keyframe's panorama is broadcast as the source, each candidate's
        as the target. Pads to a small bucket size so repeated LC sweeps hit
        the same compiled executable. With more than one device present the
        bucket is split over the pair mesh (SURVEY §2.3: LC candidate
        refinement is one of the two map-level ops that scale across
        devices)."""
        import jax

        from rgbd360_tpu.parallel.batch import align_batch

        m = self.map
        b = len(survivors)
        bucket = 2
        while bucket < b:
            bucket *= 2
        # every keyframe carries its grayscale panorama from build time
        # (frame360.py sets sphere_gray once) — re-deriving it here with
        # eager gray_f32 would cost unjitted device ops plus a host round
        # trip per candidate on every LC sweep (CLAUDE.md: keep under jit)
        src_gray = np.asarray(new_kf.sphere_gray)
        src_depth = np.asarray(new_kf.sphere_depth_mm, np.float32) * 0.001
        gs, ds, gt, dt, seeds = [], [], [], [], []
        for k in range(bucket):
            cand, guess = survivors[min(k, b - 1)]
            cand_kf = m.frames[cand]
            gs.append(src_gray)
            ds.append(src_depth)
            gt.append(np.asarray(cand_kf.sphere_gray))
            dt.append(np.asarray(cand_kf.sphere_depth_mm, np.float32) * 0.001)
            seeds.append(guess.astype(np.float32))
        # shard the bucket over the largest power-of-two device count that
        # divides it (bucket is a power of two, so this is min(bucket,
        # 2^floor(log2(n_dev)))); a single device keeps the plain jit path
        n_dev = len(jax.devices())
        n_use = 1
        while n_use * 2 <= n_dev and bucket % (n_use * 2) == 0:
            n_use *= 2
        # keep the stacked bucket as HOST arrays: shard_pairs device_puts
        # each array once onto the mesh sharding, and align_batch's jit
        # uploads host operands directly — a jnp.asarray here would commit
        # all five full-panorama stacks to the default device first and pay
        # the transfer twice (review finding, round 4)
        args = (
            np.stack(gs),
            np.stack(ds),
            np.stack(gt),
            np.stack(dt),
            np.stack(seeds),
        )
        if n_use > 1:
            from rgbd360_tpu.parallel.mesh import (
                align_batch_sharded, make_mesh, shard_pairs,
            )

            mesh = make_mesh(jax.devices()[:n_use])
            res = align_batch_sharded(
                mesh, *shard_pairs(mesh, *args), n_levels=self.aligner.n_pyr_levels
            )
        else:
            res = align_batch(*args, n_levels=self.aligner.n_pyr_levels)
        poses = np.asarray(res.pose)
        av_depth = np.asarray(res.av_depth_residual)
        hessians = np.asarray(res.hessian)
        ssos = np.asarray(res.sso)
        ill = np.asarray(res.ill_posed)
        out = []
        for k, (cand, _guess) in enumerate(survivors):
            if ill[k]:
                continue
            out.append(
                (cand, poses[k], float(av_depth[k]), hessians[k], float(ssos[k]))
            )
        return out

    # -- background thread (reference ctor :83-94) ---------------------------------
    def notify_keyframe(self, kf_id: int) -> None:
        self._queue.put(kf_id)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    kf_id = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                try:
                    self.process_new_keyframe(kf_id)
                except Exception as exc:  # keep the thread alive like mrpt's
                    print(f"LoopClosure360: error on kf {kf_id}: {exc}")

        self._thread = threading.Thread(target=run, daemon=True, name="LoopClosure360")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
