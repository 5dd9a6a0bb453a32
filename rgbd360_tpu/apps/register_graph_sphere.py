"""RegisterGraphSphere — batch sphere-graph registration + partitioning
(reference Registration/RegisterGraphSphere.cpp:113-1453: per frame, PbMap-
register backwards against up to 5 previous spheres, chain the pose, add a
graph edge weighted by matched area; scan far-back frames for loop closures
(>8 matches, area>20); optimize the graph and spectrally partition the SSO
matrix).

Accelerator restructuring: the per-pair dense registrations are *batched on
device* — all selected pairs (odometry chain + every loop-closure candidate
that survives the batched PbMap compatibility prefilter) are stacked along a
leading axis and registered in chunks through parallel/batch.align_batch,
instead of the reference's one-pair-at-a-time loop. PbMap matching and graph
bookkeeping stay on host.

Usage: python -m rgbd360_tpu.apps.register_graph_sphere <dataset_dir>
       [--first 1] [--sample 1] [--max-frames 16] [--batch 8] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rgbd360_tpu.apps.common import default_matcher_config, load_calib, rot_offset, sequence_files
from rgbd360_tpu.core.frame360 import Frame360
from rgbd360_tpu.core.graph_optimizer import GraphOptimizer
from rgbd360_tpu.core.matcher import PLANAR_3DOF
from rgbd360_tpu.core.register_rgbd360 import RegisterRGBD360
from rgbd360_tpu.core.topological import recursive_spectral_partition
from rgbd360_tpu.utils.viz import save_trajectory

LC_MIN_MATCHES = 8  # strictly greater in the reference (:1129)
LC_MIN_AREA = 20.0
MAX_EDGE_RESIDUAL = 2.0  # LoopClosure360.h:316 accept gate
TRACK_BACK = 5  # numCheckRegistration (:936)
LC_SKIP_BACK = 6  # don't LC against the immediate chain neighbourhood


def register_graph(frames, batch_size: int = 8, matcher_config=None, progress=print):
    """Returns (poses, edges, sso, partition_labels). frames: list of
    Frame360 with planes extracted."""
    import jax.numpy as jnp

    from rgbd360_tpu.core.batch_match import prefilter_candidates
    from rgbd360_tpu.parallel.batch import align_batch

    n = len(frames)
    registerer = RegisterRGBD360(matcher_config)
    off = rot_offset()
    off_inv = np.linalg.inv(off)

    # --- select pairs + PbMap seeds/areas (host; cheap combinatorial work) ---
    pairs = []  # (i, j, seed_sphere_4x4, area_matched)
    for j in range(1, n):
        seeded = False
        for back in range(1, min(TRACK_BACK, j) + 1):
            i = j - back
            ok = registerer.register_pbmap(frames[i], frames[j], 25, PLANAR_3DOF)
            if ok:
                seed = off @ registerer.get_pose().astype(np.float64) @ off_inv
                pairs.append((i, j, seed, float(registerer.get_area_matched())))
                seeded = True
                break
        if not seeded:
            pairs.append((j - 1, j, np.eye(4), 0.0))

    # loop-closure candidates: batched compatibility prefilter over all
    # far-apart pairs, exact PbMap registration only on survivors
    lc_cands = [(i, j) for j in range(n) for i in range(j - LC_SKIP_BACK)]
    if lc_cands:
        by_j = {}
        for i, j in lc_cands:
            by_j.setdefault(j, []).append(i)
        from rgbd360_tpu.core.pbmap import PbMap

        for j, is_ in by_j.items():
            # pad candidates to power-of-two buckets: each distinct batch
            # shape costs a fresh 10-30 s device compile, and per-j counts
            # grow linearly; empty PbMaps pack to all-invalid rows that the
            # gates drop
            bucket = 1
            while bucket < len(is_):
                bucket *= 2
            cand_planes = [frames[i].planes for i in is_]
            cand_planes += [PbMap()] * (bucket - len(is_))
            counts, areas = prefilter_candidates(
                frames[j].planes,
                cand_planes,
                registerer.matcher.config,
                PLANAR_3DOF,
            )
            for k, i in enumerate(is_):
                if counts[k] > LC_MIN_MATCHES and areas[k] > LC_MIN_AREA:
                    ok = registerer.register_pbmap(frames[i], frames[j], 25, PLANAR_3DOF)
                    if (
                        ok
                        and len(registerer.get_matched_planes()) > LC_MIN_MATCHES
                        and registerer.get_area_matched() > LC_MIN_AREA
                    ):
                        seed = off @ registerer.get_pose().astype(np.float64) @ off_inv
                        pairs.append((i, j, seed, float(registerer.get_area_matched())))
                        progress(f"loop-closure candidate {i} <-> {j} "
                                 f"(area {registerer.get_area_matched():.1f})")

    progress(f"{len(pairs)} pairs selected ({n - 1} chain, {len(pairs) - n + 1} LC)")

    # --- batched dense registration of ALL pairs on device ------------------
    # cache the per-frame conversions: each is an eager dispatch and a
    # frame recurs across chain + LC chunks
    _pano_cache = {}

    def panorama(f):
        key = id(f)
        if key not in _pano_cache:
            _pano_cache[key] = (
                jnp.asarray(f.sphere_gray),
                f.sphere_depth_mm.astype(jnp.float32) * 0.001,
            )
        return _pano_cache[key]

    results = [None] * len(pairs)
    for c0 in range(0, len(pairs), batch_size):
        chunk = pairs[c0 : c0 + batch_size]
        pad = batch_size - len(chunk)
        gs, ds, gt, dt, seeds = [], [], [], [], []
        for (i, j, seed, _a) in chunk + [chunk[-1]] * pad:
            g2, d2 = panorama(frames[j])
            g1, d1 = panorama(frames[i])
            gs.append(g2)
            ds.append(d2)
            gt.append(g1)
            dt.append(d1)
            seeds.append(seed.astype(np.float32))
        res = align_batch(
            jnp.stack(gs), jnp.stack(ds), jnp.stack(gt), jnp.stack(dt),
            jnp.asarray(np.stack(seeds)),
        )
        for k in range(len(chunk)):
            results[c0 + k] = (
                np.asarray(res.pose[k]),
                float(res.av_depth_residual[k]),
                float(res.sso[k]),
                np.asarray(res.hessian[k]),
                bool(np.asarray(res.ill_posed)[k]),
            )
        progress(f"registered pairs {c0}..{c0 + len(chunk) - 1} on device")

    # --- graph assembly + optimization + partitioning -----------------------
    poses = [np.eye(4) for _ in range(n)]
    optimizer = GraphOptimizer(robust=True)
    sso = np.zeros((n, n))
    edges = []
    chain = {}
    chain_fallback = {}  # PbMap seed as a continuity backup
    for (i, j, seed, area), (pose_s, resid, sso_ij, H, ill) in zip(pairs, results):
        if j == i + 1:
            chain_fallback[j] = (i, off_inv @ seed.astype(np.float64) @ off)
        if ill or resid >= MAX_EDGE_RESIDUAL:
            # a diverged alignment must not constrain the graph (the
            # reference gates connections by residual: LC accepts < 2.0,
            # KF connections keep < 1.8)
            continue
        rel = off_inv @ pose_s.astype(np.float64) @ off
        info = H.astype(np.float64)
        edges.append((i, j, rel, info, resid))
        sso[i, j] = sso[j, i] = sso_ij
        if j not in chain or chain[j][0] < area:
            chain[j] = (area, i, rel)
    for j in range(1, n):
        if j in chain:
            _, i, rel = chain[j]
            poses[j] = poses[i] @ rel
        elif j in chain_fallback:
            # dense gated out: keep the chain CONTINUOUS from the PbMap seed
            # (or identity) — a hole would initialize every downstream pose
            # at the origin and wreck the optimizer's starting point
            i, rel = chain_fallback[j]
            poses[j] = poses[i] @ rel
        else:
            poses[j] = poses[j - 1]
    for p in poses:
        optimizer.add_vertex(p)
    for i, j, rel, info, _res in edges:
        optimizer.add_edge(i, j, rel, info)
    chi2 = optimizer.optimize_graph()
    poses = optimizer.get_poses()
    progress(f"graph optimized: {n} vertices, {len(edges)} edges, chi2={chi2:.4f}")

    labels = np.zeros(n, int)
    if n > 1:
        for a, members in enumerate(recursive_spectral_partition(sso)):
            for m in members:
                labels[m] = a
    return poses, edges, sso, labels, optimizer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset")
    ap.add_argument("--first", type=int, default=1)
    ap.add_argument("--sample", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=16)
    # default 8: the batch the pair benchmark runs (the H100 optimum is not
    # measured, ROADMAP S4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calib-root", default=None)
    args = ap.parse_args(argv)

    calib = load_calib(args.calib_root)
    frames = []
    for frame_no, path in sequence_files(args.dataset, args.first, args.sample):
        f = Frame360(calib, frame_no).build(path)
        f.get_planes(need_inliers=False)
        frames.append(f)
        print(f"loaded frame {frame_no} ({len(f.planes)} planes)")
        if len(frames) >= args.max_frames:
            break
    if len(frames) < 2:
        print("need at least 2 frames")
        return 1

    poses, edges, sso, labels, optimizer = register_graph(
        frames, args.batch, default_matcher_config(args.calib_root)
    )
    print(f"partition: {labels.tolist()} ({labels.max() + 1} areas)")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_trajectory(os.path.join(args.out, "graph_poses.txt"), poses)
        optimizer.save_graph(os.path.join(args.out, "sphere_graph.g2o"))
        np.savetxt(os.path.join(args.out, "sso.txt"), sso, fmt="%8.4f")
        np.savetxt(os.path.join(args.out, "partition.txt"), labels, fmt="%d")
        print(f"artifacts -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
