"""Per-frame plane extraction: Frame360.getPlanes equivalent.

Pipeline (reference include/Frame360.h:467-510 buildSphereCloud +
:615-638 getPlanes + :942-1081 getPlanesSensor + :742-832 groupPlanes +
:657-739 mergePlanes):

  device (one batched program over the 8 sensors):
      undistorted depth -> pinhole backprojection -> 2x median downsample ->
      fast bilateral (z) -> integral-image normals -> plane label propagation
  host (tiny combinatorial work):
      per-component plane parameters -> area/elongation filters -> per-sensor
      same-plane merge -> transform to rig frame -> cross-sensor groupPlanes
      (with the 8->1 wraparound) -> global mergePlanes

Constants from include/Miscellaneous.h:51-76 via config.GlobalParams.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.config import default_params
from rgbd360_tpu.core.pbmap import PbMap, Plane
from rgbd360_tpu.ops.bilateral import fast_bilateral_z
from rgbd360_tpu.ops.normals import organized_normals
from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2
from rgbd360_tpu.ops.plane_stats import MAX_LABELS, sensor_plane_stats
from rgbd360_tpu.ops.planes_seg import MIN_INLIERS, refine_plane_labels, segment_planes

MAX_CURVATURE = default_params.max_curvature_plane
MIN_AREA = default_params.min_area_plane
MAX_ELONGATION = default_params.max_elongation_plane


@jax.jit
def build_sensor_clouds(depth_undist_m: jnp.ndarray, rgb: jnp.ndarray):
    """(8,H,W) depth + (8,H,W,3) u8 -> per-sensor organized half-res clouds,
    normals and plane labels, all in sensor frames."""

    def one(depth, rgb_s):
        xyz = backproject_organized(depth)
        xyz2, rgb2 = downsample_median2(xyz, rgb_s)
        zf = fast_bilateral_z(xyz2[..., 2])
        xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
        normals = organized_normals(xyz2)
        labels_pre = segment_planes(xyz2, normals)
        # PCL segmentAndRefine's boundary refinement (Frame360.h:977)
        labels = refine_plane_labels(labels_pre, xyz2, normals)
        return xyz2, rgb2, normals, labels

    return jax.vmap(one)(depth_undist_m, rgb)


# Stats-buffer layout (one packed u8 array, so a frame's results cross to
# the host in one transfer):
#   A: per-pixel (label+1)<<1 | candidate  (u16, or u32 for >2^15-px sensors)
#   B: compacted hull candidates: labels (8, C) u16/u32 (0 = empty slot) and
#      coordinates (8, C, 3) f16 (hull vertices tolerate ~1-3 mm) — only the
#      ~5% octagon-boundary pixels cross the wire instead of the full cloud
#   C: per-label stats f32 (8, MAX_LABELS, _NF):
#      [label_id, count, mean(3), cov6(6), evals(3), normal(3), curvature,
#       hist(74), sum_rgb(3), mean_pre(3)]
#      count/mean/cov6: REFINED members (merge suffstats);
#      evals/normal/curvature/mean_pre: segment-stage fit (reported params —
#      PCL fits models pre-refine; Frame360.h:979-1002)
#   D: per-sensor candidate counts (8,) i32 (overflow detection)
_NF = 98
MAX_CANDIDATES = 4096  # ~2.5x the max observed on the bundled frames (1607)


def compact_candidate_indices(candf: jnp.ndarray, C: int) -> jnp.ndarray:
    """Stream-compact a (S, hw) bool candidate mask into the first-C pixel
    indices per sensor (ascending order; hw marks an empty slot): prefix sum
    + ONE batched 2D scatter. This is THE production compaction — the
    profiler/probe tools (tools/profile_planes_device.py,
    tools/probe_compaction.py 'scatter' arm) must price this definition,
    not a copy (a vmapped per-sensor 1D variant lowers to a much slower
    program and once misattributed its cost to this stage)."""
    S, hw = candf.shape
    pix = jax.lax.broadcasted_iota(jnp.int32, (S, hw), 1)
    pos = jnp.cumsum(candf.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(candf & (pos < C), pos, C)  # slot C absorbs the rest
    sensor = jax.lax.broadcasted_iota(jnp.int32, (S, hw), 0)
    return (
        jnp.full((S, C + 1), hw, jnp.int32).at[sensor, tgt].set(pix, mode="drop")[:, :C]
    )


@functools.partial(jax.jit, static_argnames=("ship_labels",))
def build_sensor_plane_stats(
    depth_undist_m: jnp.ndarray, rgb: jnp.ndarray, ship_labels: bool = True
):
    """Fused device program: clouds -> segmentation -> per-label statistics
    and hull candidates (ops/plane_stats.py), packed into ONE u8 buffer.

    ship_labels=False drops the per-pixel label image from the transfer
    (40% of the buffer) and ships each candidate's label instead — enough
    to fit planes and hulls; per-pixel inlier indices are then unavailable
    (extract_frame_planes(need_inliers=False), the SLAM-loop configuration)."""

    def one(depth, rgb_s):
        xyz = backproject_organized(depth)
        xyz2, rgb2 = downsample_median2(xyz, rgb_s)
        zf = fast_bilateral_z(xyz2[..., 2])
        xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
        normals = organized_normals(xyz2)
        labels_pre = segment_planes(xyz2, normals)
        labels = refine_plane_labels(labels_pre, xyz2, normals)
        st = sensor_plane_stats(xyz2, rgb2, labels, labels_pre)
        return st, xyz2

    st, xyz2 = jax.vmap(one)(depth_undist_m, rgb)
    h, w = st.labels.shape[1:]
    hw = h * w
    idx_dtype = jnp.uint16 if hw < 2**16 else jnp.uint32
    if ship_labels:
        labpack = ((st.labels + 1) << 1) | st.candidate.astype(jnp.int32)
        if hw * 2 + 1 < 2**16:
            labpack = labpack.astype(jnp.uint16)
        else:
            labpack = labpack.astype(jnp.uint32)

    # compacted candidates (first C in ascending pixel order): stream
    # compaction as prefix-sum + one scatter instead of a k=4096 top_k sort
    # (their relative cost on the H100 is not measured)
    C = MAX_CANDIDATES
    candf = st.candidate.reshape(8, hw)
    cidx = compact_candidate_indices(candf, C)
    slot_ok = cidx < hw
    cidx_safe = jnp.minimum(cidx, hw - 1)
    cxyz = jnp.take_along_axis(xyz2.reshape(8, hw, 3), cidx_safe[..., None], axis=1)
    cxyz = jnp.where(slot_ok[..., None], cxyz, jnp.nan).astype(jnp.float16)
    # per-candidate label (i32 label + 1, 0 = empty slot / unlabeled pixel)
    clab = jnp.take_along_axis(st.labels.reshape(8, hw), cidx_safe, axis=1)
    clab = jnp.where(slot_ok, clab + 1, 0).astype(idx_dtype)
    n_cand = jnp.sum(candf, axis=1).astype(jnp.int32)  # true counts (overflow check)
    cov6 = st.cov.reshape(*st.cov.shape[:-2], 9)[..., np.array([0, 1, 2, 4, 5, 8])]
    stats = jnp.concatenate(
        [
            st.label_id[..., None].astype(jnp.float32),
            st.count[..., None].astype(jnp.float32),
            st.mean,
            cov6,
            st.evals,
            st.normal,
            st.curvature[..., None],
            st.hist,
            st.sum_rgb,
            st.mean_pre,
        ],
        axis=-1,
    )  # (8, K, _NF)
    bufs = [
        jax.lax.bitcast_convert_type(clab, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(cxyz, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(stats, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(n_cand, jnp.uint8).reshape(-1),
    ]
    if ship_labels:
        bufs.insert(0, jax.lax.bitcast_convert_type(labpack, jnp.uint8).reshape(-1))
    return jnp.concatenate(bufs)


def _unpack_stats_buffer(buf: np.ndarray, h: int, w: int, ship_labels: bool = True):
    """Host-side views into the packed stats buffer (no copies).
    Returns (labels-or-None, cand_lab, cand_xyz, stats, n_cand)."""
    hw = h * w
    C = MAX_CANDIDATES
    lab_dtype = np.uint16 if hw * 2 + 1 < 2**16 else np.uint32
    idx_dtype = np.uint16 if hw < 2**16 else np.uint32
    labels = None
    off = 0
    if ship_labels:
        nA = 8 * hw * lab_dtype().itemsize
        lab = buf[:nA].view(lab_dtype).reshape(8, h, w)
        labels = (lab >> 1).astype(np.int32) - 1
        off = nA
    nI = 8 * C * idx_dtype().itemsize
    nX = 8 * C * 3 * 2
    nS = 8 * MAX_LABELS * _NF * 4
    cand_lab = buf[off : off + nI].view(idx_dtype).reshape(8, C).astype(np.int64) - 1
    off += nI
    cand_xyz = buf[off : off + nX].view(np.float16).reshape(8, C, 3)
    off += nX
    stats = buf[off : off + nS].view(np.float32).reshape(8, MAX_LABELS, _NF)
    n_cand = buf[off + nS :].view(np.int32)
    return labels, cand_lab, cand_xyz, stats, n_cand



def local_same_plane_merge(planes: List[Plane]) -> List[Plane]:
    """Per-sensor same-plane absorption right after extraction (reference
    getPlanesSensor tail, include/Frame360.h:1055-1068; the stereo variant
    repeats it at Frame360_stereo.h:959-978): each low-curvature plane is
    merged into the first earlier plane it coincides with (0.99 normal dot,
    0.05 m offset, 0.2 m hull proximity)."""
    merged: List[Plane] = []
    for plane in planes:
        absorbed = False
        if plane.curvature < MAX_CURVATURE:
            for prev in merged:
                if prev.curvature < MAX_CURVATURE and prev.is_same_plane(
                    plane, 0.99, 0.05, 0.2
                ):
                    prev.merge_plane(plane)
                    absorbed = True
                    break
        if not absorbed:
            plane.id = len(merged)
            merged.append(plane)
    return merged


def _planes_from_stats(
    stats: np.ndarray,  # (MAX_LABELS, _NF) one sensor's stat rows
    labels: Optional[np.ndarray],  # (H, W) i32 or None (need_inliers=False)
    cand_lab: np.ndarray,  # (C,) candidate labels (-1 = empty slot)
    cand_xyz: np.ndarray,  # (C, 3) f16 candidate coordinates
    sensor_id: int,
    hw: int,
) -> List[Plane]:
    """Device stats -> Plane objects (the fast path of the reference
    getPlanesSensor loop, include/Frame360.h:979-1075): per-component
    centroid/covariance/eigendecomposition come from the device; the host
    runs only the exact hull over the device's octagon candidates, the
    area/elongation filters and the local merge."""
    if labels is not None:
        flat = labels.reshape(-1)
        valid = flat >= 0
        px = np.flatnonzero(valid)
        lv = flat[valid]
        order = np.argsort(lv, kind="stable")
        sorted_px = px[order]
        sorted_lab = lv[order]
    # group candidate points by their label
    slot_ok = cand_lab >= 0
    clab = cand_lab[slot_ok]
    cxyz = cand_xyz[slot_ok].astype(np.float64)
    corder = np.argsort(clab, kind="stable")
    sorted_cl = clab[corder]
    sorted_cxyz = cxyz[corder]

    label_id = stats[:, 0].astype(np.int64)
    count = stats[:, 1].astype(np.int64)
    mean = stats[:, 2:5].astype(np.float64)  # refined members (suffstats)
    cov6 = stats[:, 5:11].astype(np.float64)
    evals = stats[:, 11:14].astype(np.float64)
    normal = stats[:, 14:17].astype(np.float64)
    curvature = stats[:, 17].astype(np.float64)
    hist = stats[:, 18:92].astype(np.float64)
    sum_rgb = stats[:, 92:95].astype(np.float64)
    mean_pre = stats[:, 95:98].astype(np.float64)  # reported center (pre fit)

    planes: List[Plane] = []
    # ascending label order = PCL's region discovery (scan) order, which is
    # the order the reference's getPlanesSensor loop visits regions in —
    # local_same_plane_merge absorbs into the FIRST earlier match, so plane
    # ORDER changes merge pairings (the top-K rows arrive count-sorted; a
    # count-ordered walk produced different local merges than the oracle)
    for k in sorted(range(len(label_id)), key=lambda i: label_id[i]):
        n = int(count[k])
        if n < MIN_INLIERS:
            continue  # top-K rows are count-sorted, but we walk label order
        if labels is not None:
            a = np.searchsorted(sorted_lab, label_id[k], side="left")
            b = np.searchsorted(sorted_lab, label_id[k], side="right")
            inl = sorted_px[a:b] + sensor_id * hw
        else:
            inl = None
        cov = np.empty((3, 3))
        cov[0, 0], cov[0, 1], cov[0, 2] = cov6[k, 0], cov6[k, 1], cov6[k, 2]
        cov[1, 1], cov[1, 2], cov[2, 2] = cov6[k, 3], cov6[k, 4], cov6[k, 5]
        cov[1, 0], cov[2, 0], cov[2, 1] = cov[0, 1], cov[0, 2], cov[1, 2]
        plane = Plane(
            id=len(planes),
            normal=normal[k].copy(),
            center=mean_pre[k].copy(),  # reported params: segment-stage fit
            curvature=float(curvature[k]),
            inliers=inl,
            n_pts=n,
            cov=cov,
            ss_center=mean[k].copy(),  # merge suffstats: refined members
        )
        ca = np.searchsorted(sorted_cl, label_id[k], side="left")
        cb = np.searchsorted(sorted_cl, label_id[k], side="right")
        cpts = sorted_cxyz[ca:cb]
        # exact small-plane prefilter: the convex hull lies inside the
        # candidate bounding box in the SAME in-plane basis the hull uses,
        # so bbox area < MIN_AREA implies hull area < MIN_AREA — the same
        # discard (:1034) without paying the hull chain + mass-center +
        # elongation for the many sub-threshold clutter components
        # (~60-70% of the per-frame hull calls on the bundled frames)
        if len(cpts) >= 3:
            u_b, v_b = plane.plane_basis()
            rel = cpts - plane.center
            pu = rel @ u_b
            pv = rel @ v_b
            if (pu.max() - pu.min()) * (pv.max() - pv.min()) < MIN_AREA:
                continue
        plane.compute_hull_area(cpts)
        if plane.area_hull < MIN_AREA:  # discard small planes (:1034)
            continue
        plane.d = float(-plane.normal @ plane.center)
        if plane.elongation > MAX_ELONGATION:  # discard narrow planes (:1041)
            continue
        total = hist[k].sum()
        plane.hist_counts = hist[k].copy()
        plane.hist_h = hist[k] / total if total > 0 else hist[k]
        plane.main_color = sum_rgb[k] / max(n, 1) / 255.0
        planes.append(plane)

    return local_same_plane_merge(planes)


def _planes_from_labels(
    xyz: np.ndarray, rgb: np.ndarray, labels: np.ndarray, sensor_id: int
) -> List[Plane]:
    """Component stats -> Plane objects (reference getPlanesSensor loop,
    include/Frame360.h:979-1075), still in the sensor frame."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    xyzf = xyz.reshape(-1, 3)
    rgbf = rgb.reshape(-1, 3)
    valid = flat >= 0
    ids, inverse, counts = np.unique(flat[valid], return_inverse=True, return_counts=True)
    planes: List[Plane] = []
    px_of = np.flatnonzero(valid)
    order = np.argsort(inverse, kind="stable")
    sorted_px = px_of[order]
    boundaries = np.concatenate([[0], np.cumsum(counts)])
    single_cloud_size = h * w

    for k in range(len(ids)):
        if counts[k] < MIN_INLIERS:
            continue
        inl = sorted_px[boundaries[k] : boundaries[k + 1]]
        pts = xyzf[inl]
        center = pts.mean(axis=0)
        cov = (pts - center).T @ (pts - center) / len(pts)
        evals, evecs = np.linalg.eigh(cov)
        normal = evecs[:, 0]
        if normal @ center > 0:  # flip toward the sensor (Frame360.h:988-992)
            normal = -normal
        curvature = float(evals[0] / max(evals.sum(), 1e-12))

        plane = Plane(
            id=len(planes),
            normal=normal,
            center=center,
            curvature=curvature,
            inliers=inl + sensor_id * single_cloud_size,
            points=pts,
            colors=rgbf[inl],
        )
        plane.compute_hull_area(pts)
        if plane.area_hull < MIN_AREA:  # discard small planes (:1034)
            continue
        plane.d = float(-plane.normal @ plane.center)
        if plane.elongation > MAX_ELONGATION:  # discard narrow planes (:1041)
            continue
        plane.compute_colors()
        planes.append(plane)

    return local_same_plane_merge(planes)


def _same_surface(pj: Plane, pk: Plane, max_dist_hull: float, max_parallel: float) -> bool:
    """The vertex/edge proximity + parallel-offset test shared by groupPlanes
    and mergePlanes (reference include/Frame360.h:680-711, 785-811)."""
    h1, h2 = pj.hull, pk.hull
    if h1 is None or h2 is None or len(h1) < 2 or len(h2) < 2:
        return False
    diff = h1[:, None, :] - h2[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    offset = np.abs(diff @ pj.normal)
    if np.any((dist < max_dist_hull) & (offset < max_parallel)):
        return True
    # edge-to-edge distances, all pairs at once (the scalar per-pair loop
    # was the hottest remaining host op of plane extraction)
    from rgbd360_tpu.core.pbmap import dist3d_segment_segment_batch

    thr2 = max_dist_hull * max_dist_hull
    d2 = dist3d_segment_segment_batch(
        h1, np.roll(h1, -1, axis=0), h2, np.roll(h2, -1, axis=0)
    )
    return bool(np.any((d2 < thr2) & (offset < max_parallel)))


def group_planes(local_planes: List[List[Plane]]) -> PbMap:
    """Cross-sensor merge incl. the sensor 7->0 wraparound
    (reference include/Frame360.h:742-832)."""
    max_dist_hull = 0.5
    max_parallel = 0.09
    planes: List[Plane] = []
    for p in local_planes[0]:
        p.id = len(planes)
        planes.append(p)
    first_ids = {p.id for p in planes}
    prev_ids = set(first_ids)

    for sensor_id in range(1, 8):
        next_prev = set()
        for cand in local_planes[sensor_id]:
            target = None
            if cand.area_hull > 0.5 or cand.curvature < MAX_CURVATURE:
                # ascending id order: the reference iterates std::set<unsigned>
                # and merges into the FIRST match (:766-817) — when several
                # previous planes match, the target is order-dependent, and a
                # Python set's iteration order is not a contract
                for j in sorted(prev_ids):
                    pj = planes[j]
                    if pj.area_hull < 0.5 or pj.curvature > MAX_CURVATURE:
                        continue
                    if abs(pj.d - cand.d) >= 0.45:
                        continue
                    if pj.normal @ cand.normal <= 0.99:
                        continue
                    if _same_surface(pj, cand, max_dist_hull, max_parallel):
                        target = j
                        break
            if target is not None:
                next_prev.add(target)
                planes[target].merge_plane(cand)
            else:
                cand.id = len(planes)
                next_prev.add(cand.id)
                planes.append(cand)
        prev_ids = next_prev
        if sensor_id == 6:  # let sensor 7 also merge with sensor 0's planes
            prev_ids |= first_ids
    return PbMap(planes=planes)


def merge_planes(pbmap: PbMap) -> PbMap:
    """Global merge of coplanar patches (reference include/Frame360.h:657-739)."""
    planes = pbmap.planes
    j = 0
    while j < len(planes):
        k = j + 1
        merged_any = False
        while k < len(planes):
            pj, pk = planes[j], planes[k]
            same = False
            if pj.curvature < MAX_CURVATURE and pk.curvature < MAX_CURVATURE:
                if pj.normal @ pk.normal > 0.99 and abs(pj.d - pk.d) < 0.45:
                    same = _same_surface(pj, pk, 0.3, 0.06)
            if same:
                pj.merge_plane(pk)
                del planes[k]
                # (ids are reassigned wholesale after the merge loop)
                merged_any = True
                break  # re-evaluate j against all (reference :729-731)
            k += 1
        if not merged_any:
            j += 1
    for i, p in enumerate(planes):
        p.id = i
    return pbmap


def _fit_from_stats_buffer(frame, buf: np.ndarray, need_inliers: bool):
    """Host half of the getPlanes pipeline: unpack a fetched device stats
    buffer, fit per-sensor planes, transform to rig frame, group and merge.
    Shared by extract_frame_planes and planes_pipeline.collect so the
    overflow warnings and merge semantics exist exactly once."""
    h, w = frame.depth_undistorted_m.shape[1] // 2, frame.depth_undistorted_m.shape[2] // 2
    labels, cand_lab, cand_xyz, stats, n_cand = _unpack_stats_buffer(
        buf, h, w, ship_labels=need_inliers
    )
    if stats[:, -1, 1].max() >= MIN_INLIERS:
        print(
            "[plane_extraction] WARNING: >MAX_LABELS plane components on a "
            "sensor — smallest ones dropped (raise ops/plane_stats.MAX_LABELS)"
        )
    if n_cand.max() > MAX_CANDIDATES:
        print(
            f"[plane_extraction] WARNING: {int(n_cand.max())} hull candidates "
            f"on a sensor exceed the {MAX_CANDIDATES} shipping budget — hulls "
            "may shrink slightly (raise MAX_CANDIDATES)"
        )
    rt = frame.calib.Rt

    local: List[List[Plane]] = []
    for s in range(8):
        planes = _planes_from_stats(
            stats[s],
            labels[s] if labels is not None else None,
            cand_lab[s],
            cand_xyz[s],
            s,
            h * w,
        )
        for p in planes:
            p.transform(rt[s].astype(np.float64))
        local.append(planes)

    import copy

    # the global merge MUTATES planes (merge_plane re-estimates
    # normal/center/d/hull from cross-sensor point unions and rewrites ids);
    # local_planes must stay pristine per-sensor observations like the
    # reference's value-semantics copies (Frame360.h:742-832) — the
    # calibration apps derive adjacent-sensor correspondences from them, and
    # aliased merged planes would bias the solve toward the current Rt
    if not need_inliers:
        # SLAM-loop configuration: nothing consumes per-sensor observations
        # (only calibrate_rig does, and it runs the default mode), so merge
        # the originals and skip the pristine copies
        return merge_planes(group_planes(local)), None
    pbmap = merge_planes(group_planes([[copy.deepcopy(p) for p in l] for l in local]))
    return pbmap, local


def extract_frame_planes(frame, need_inliers: bool = True) -> Tuple[PbMap, List[List[Plane]]]:
    """Full getPlanes pipeline for a Frame360 (device-stats fast path).

    need_inliers=False skips shipping the per-pixel label image (Plane.inliers
    stays None) — the SLAM/odometry-loop configuration, where only plane
    geometry, hulls and histograms are consumed; calibration and labelization
    keep the default."""
    buf = np.asarray(
        build_sensor_plane_stats(
            frame.depth_undistorted_m, frame.rgb, ship_labels=need_inliers
        )
    )
    return _fit_from_stats_buffer(frame, buf, need_inliers)


@functools.partial(
    jax.jit,
    static_argnames=("ship_labels", "bin_width", "bin_height", "bin_depth"),
)
def fused_frame_program(
    rgb,
    depth_raw_mm,
    mults,
    counts,
    rt_inv,
    cam,
    *,
    ship_labels: bool,
    bin_width: int,
    bin_height: int,
    bin_depth: float,
):
    """The whole per-frame device pipeline as ONE program: CLAMS undistort +
    spherical stitch (+ gray) + plane-stats. Each stage is the same jitted
    function the step-by-step path runs (inlined here), so outputs are
    identical; fusing them turns 3-4 per-frame dispatches into one. The SLAM pipeline path uses this
    via Frame360.build_device_fused; the step-by-step methods remain for
    every other caller."""
    from rgbd360_tpu.ops.image import gray_f32
    from rgbd360_tpu.ops.stitch import stitch_spherical
    from rgbd360_tpu.ops.undistort import undistort_depth_mm

    depth_und = undistort_depth_mm(
        depth_raw_mm, mults, counts,
        bin_width=bin_width, bin_height=bin_height, bin_depth=bin_depth,
    )
    sphere_rgb, sphere_depth_mm = stitch_spherical(rgb, depth_raw_mm, rt_inv, cam)
    sphere_gray = gray_f32(sphere_rgb)
    stats = build_sensor_plane_stats(depth_und, rgb, ship_labels=ship_labels)
    return sphere_rgb, sphere_depth_mm, sphere_gray, depth_und, stats


def planes_pipeline(frames_iter, need_inliers: bool = False, pre_collect=None,
                    threaded: Optional[bool] = None):
    """One-frame-lookahead plane extraction over a (frame_no, frame)
    iterator: frame N+1's device program is dispatched BEFORE frame N's
    buffer is collected and host-fitted, so the device program + transfer
    and the host fitting overlap (dispatch is async; the overlap on the
    H100 is not measured).
    Yields (frame_no, frame) with frame.planes / frame.local_planes set,
    exactly as the sequential frame.get_planes(need_inliers=...) would.

    pre_collect(frame): optional hook called with frame N (panorama built)
    on the caller's thread, in frame order, before frame N is yielded —
    the SLAM loop uses it to speculatively dispatch frame N's tracking
    alignment so the device program overlaps the collect + host fit
    (KFSphereSLAM.prefetch_align). CONTRACT: the hook must not read
    frame.planes / frame.local_planes — in the threaded default the
    worker may already be fitting (or have fitted) them when the hook
    runs; only in sequential mode is the hook strictly pre-fit.

    threaded (default: env RGBD360_PIPELINE_THREAD, on): run each frame's
    stats sync + host plane fit on ONE worker thread, submitted right after
    that frame's device dispatch and joined at yield time — the
    numpy/qhull fit and the transfer wait then overlap the consumer's
    process_frame of the PREVIOUS frame and the next frame's load, instead
    of sitting serially on the loop's critical path. The worker runs pure
    host code (np.asarray on an already-enqueued async copy +
    _fit_from_stats_buffer, numpy-only) and touches only its own frame's
    attributes; every device-program dispatch — including the pre_collect
    speculation hook — stays on the caller's thread in the sequential
    order, so the device queue is identical and the yielded plane sets are
    bit-identical (tests/test_planes.py pins threaded == sequential)."""

    from rgbd360_tpu.utils.timing import stage

    if threaded is None:
        threaded = os.environ.get("RGBD360_PIPELINE_THREAD", "1") == "1"

    def dispatch(frame):
        if getattr(frame, "_deferred_build", False):
            # deferred-build frame (sequence_frames(defer_device=True) sets
            # the explicit marker): undistort + stitch + stats run as ONE
            # device program. The marker — not attribute sniffing — gates
            # this path so rawlog-style frames (depth must not be CLAMS-
            # undistorted, calib may lack intrinsic models) can never route
            # here by accident.
            fut = frame.build_device_fused(ship_labels=need_inliers)
        else:
            fut = build_sensor_plane_stats(
                frame.depth_undistorted_m, frame.rgb, ship_labels=need_inliers
            )
        # Enqueue the device->host copy NOW, right behind the stats program,
        # so a fetch first issued at collect() time does not wait behind
        # everything dispatched since (the dense align, frame N+1's build +
        # stats) on a backend that orders transfers with compute.
        try:
            fut.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass  # CPU/older runtimes: np.asarray in collect() still works
        return fut

    def collect(frame_no, frame, fut):
        # brackets are no-ops unless RGBD360_PRINT_TIMINGS is on; the stage
        # profiler (tools/profile_slam_frame.py) reads THESE brackets so it
        # always measures the shipped pipeline schedule, not a copy of it
        with stage("planes collect (sync)"):
            buf = np.asarray(fut)
        with stage("planes host fit"):
            frame.planes, frame.local_planes = _fit_from_stats_buffer(
                frame, buf, need_inliers
            )
        return frame_no, frame

    def hook(frame):
        if pre_collect is not None:
            with stage("speculative align dispatch"):
                pre_collect(frame)

    if threaded:
        # A DAEMON worker, not a ThreadPoolExecutor: the worker blocks in
        # np.asarray on the device, and concurrent.futures' exit handler
        # joins its (non-daemon) threads, so a stuck sync would make every
        # SLAM app unkillable by normal exit; a daemon thread lets the
        # process exit regardless.
        import queue
        import threading
        from concurrent.futures import Future

        q: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                item = q.get()
                if item is None:
                    return
                fut_out, frame_no, frame, fut_in = item
                try:
                    fut_out.set_result(collect(frame_no, frame, fut_in))
                except BaseException as e:  # surfaced at .result()
                    fut_out.set_exception(e)

        th = threading.Thread(target=worker, name="planes-fit", daemon=True)
        th.start()
        try:
            pending = None
            for frame_no, frame in frames_iter:
                if pending is not None:
                    hook(pending[1])
                with stage("planes dispatch"):
                    fut = dispatch(frame)
                # the worker only WAITS (the device->host copy was enqueued
                # at dispatch) and fits — all device dispatches stay here
                task = Future()
                q.put((task, frame_no, frame, fut))
                if pending is not None:
                    with stage("planes join (thread)"):
                        item = pending[2].result()
                    yield item
                pending = (frame_no, frame, task)
            if pending is not None:
                hook(pending[1])
                with stage("planes join (thread)"):
                    item = pending[2].result()
                yield item
        finally:
            q.put(None)
        return

    pending = None
    for frame_no, frame in frames_iter:
        # hook BEFORE dispatching frame N+1's stats so the speculative
        # alignment of frame N sits ahead of them in the device queue —
        # its result is consumed this frame, theirs only next frame
        if pending is not None:
            hook(pending[1])
        with stage("planes dispatch"):
            fut = dispatch(frame)
        if pending is not None:
            yield collect(*pending)
        pending = (frame_no, frame, fut)
    if pending is not None:
        hook(pending[1])
        yield collect(*pending)
