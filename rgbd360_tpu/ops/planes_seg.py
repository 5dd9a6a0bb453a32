"""Organized multi-plane segmentation as iterative label propagation.

Equivalent of PCL OrganizedMultiPlaneSegmentation with the reference's
configuration (include/Frame360.h:958-977: min inliers 80, angular threshold
0.039812 rad, distance threshold 0.02 m): two 4-connected pixels belong to
the same planar region when their normals agree within the angular threshold
and their plane offsets (n . p) differ by less than the distance threshold.
Region growing — inherently sequential in PCL — becomes a fixed-point
min-label flood fill. Each round propagates labels along entire connected
row/column runs with segmented min-scans (lax.associative_scan — one round
crosses any straight stretch of a region, log-depth, no gathers) and then
pointer-jumps twice (label <- label[label], the label-doubling shortcut
through already-learned minima). Plain one-pixel sweeps needed O(diameter)
rounds (~280 on the half-res grid) and pointer-jumping alone still stalled
on serpentine regions (64+ rounds measured on the bundled frame); the
scan+jump rounds converge in a handful. The fixed point — min label per
connected component — is identical whatever the schedule.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

ANGULAR_THRESHOLD = 0.039812  # rad (~2.3 deg)
DISTANCE_THRESHOLD = 0.02  # m
MIN_INLIERS = 80


@functools.partial(jax.jit, static_argnames=("max_sweeps", "jumps"))
def segment_planes(
    xyz: jnp.ndarray,  # (H, W, 3) NaN-invalid
    normals: jnp.ndarray,  # (H, W, 3) NaN-invalid
    # each scan round propagates along ENTIRE connected runs in all four
    # directions, so rounds-to-converge is bounded by the bend count of the
    # most serpentine region path, not the grid diameter; 4-9 rounds on real
    # frames. The while_loop exits on convergence (labels are monotone
    # non-increasing ints, so convergence is guaranteed); the cap is only a
    # runaway backstop and costs nothing when converged. None (default) uses
    # h*w — above the step count of ANY pixel path, so no input can be
    # silently truncated short of its fixed point (a maximally serpentine
    # region needs ~one round per bend, and a path has at most h*w pixels)
    max_sweeps: int | None = None,
    # thresholds default to the QVGA Frame360 configuration; the stereo
    # variant passes its own (reference Frame360_stereo.h:865-867)
    angular_threshold: float = ANGULAR_THRESHOLD,
    distance_threshold: float = DISTANCE_THRESHOLD,
    # pointer-jumps per round (schedule knob; every value reaches the same
    # fixed point). Whole-run scans already cross any straight stretch in
    # one round, so the doubling shortcut's label-chase gather rarely pays;
    # which value is fastest on the H100 is not measured
    # (tools/profile_seg_variants.py).
    jumps: int = 0,
):
    """Returns labels (H, W) int32: -1 invalid, else the component id (the
    smallest flat pixel index in the component)."""
    h, w = xyz.shape[:2]
    if max_sweeps is None:
        max_sweeps = h * w
    valid = jnp.all(jnp.isfinite(xyz), axis=-1) & jnp.all(jnp.isfinite(normals), axis=-1)
    n = jnp.where(valid[..., None], normals, 0.0)
    p = jnp.where(valid[..., None], xyz, 0.0)
    d = jnp.sum(n * p, axis=-1)  # plane offset per pixel
    cos_thr = jnp.cos(angular_threshold)

    def connected(sl_a, sl_b):
        """Edge predicate between two equally-shaped pixel slabs."""
        dot = jnp.sum(sl_a[0] * sl_b[0], axis=-1)
        return (
            sl_a[2]
            & sl_b[2]
            & (dot > cos_thr)
            & (jnp.abs(sl_a[1] - sl_b[1]) < distance_threshold)
        )

    a = (n, d, valid)
    right = jnp.zeros((h, w), bool).at[:, :-1].set(
        connected(tuple(x[:, :-1] for x in a), tuple(x[:, 1:] for x in a))
    )
    down = jnp.zeros((h, w), bool).at[:-1, :].set(
        connected(tuple(x[:-1, :] for x in a), tuple(x[1:, :] for x in a))
    )

    idx = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    BIG = h * w  # sentinel larger than any label
    labels0 = jnp.where(valid, idx, BIG)

    def _seg_scan(vals, conn, axis, reverse):
        """Segmented min-scan: propagate minima along runs of connected
        elements (conn[i] = connected to the scan-order predecessor)."""

        def comb(a, b):
            va, fa = a
            vb, fb = b
            return jnp.where(fb, jnp.minimum(va, vb), vb), fa & fb

        v, _ = jax.lax.associative_scan(comb, (vals, conn), axis=axis, reverse=reverse)
        return v

    false_col = jnp.zeros((h, 1), bool)
    false_row = jnp.zeros((1, w), bool)
    conn_lr = jnp.concatenate([false_col, right[:, :-1]], axis=1)
    conn_rl = jnp.concatenate([right[:, :-1], false_col], axis=1)
    conn_ud = jnp.concatenate([false_row, down[:-1, :]], axis=0)
    conn_du = jnp.concatenate([down[:-1, :], false_row], axis=0)

    def sweep(lab):
        # whole-run propagation in all four directions
        new = _seg_scan(lab, conn_lr, 1, False)
        new = jnp.minimum(new, _seg_scan(lab, conn_rl, 1, True))
        new = jnp.minimum(new, _seg_scan(new, conn_ud, 0, False))
        new = jnp.minimum(new, _seg_scan(new, conn_du, 0, True))
        return jnp.where(valid, new, BIG)

    def jump(lab):
        # label <- min(label, label[label]): every label is a pixel index of
        # a member of the same component (the sweep only pulls labels across
        # connected edges), so chasing it stays inside the component while
        # roughly doubling the distance information travels per round
        flat = jnp.concatenate([lab.reshape(-1), jnp.full((1,), BIG, lab.dtype)])
        chased = jnp.take(flat, jnp.minimum(lab.reshape(-1), BIG), mode="clip")
        return jnp.minimum(lab, chased.reshape(h, w))

    def cond(state):
        labels, changed, it = state
        return changed & (it < max_sweeps)

    def body(state):
        labels, _, it = state
        new = sweep(labels)
        for _ in range(jumps):
            new = jump(new)
        return new, jnp.any(new != labels), it + 1

    labels, _, _ = jax.lax.while_loop(cond, body, (labels0, jnp.bool_(True), jnp.int32(0)))
    return jnp.where(valid, labels, -1)


@functools.partial(jax.jit, static_argnames=("max_sweeps", "min_inliers"))
def refine_plane_labels(
    labels: jnp.ndarray,  # (H, W) i32 from segment_planes (-1 unlabeled)
    xyz: jnp.ndarray,  # (H, W, 3) NaN-invalid
    normals: jnp.ndarray,  # unused (kept for API stability; the PCL-faithful
    # models are least-squares point fits, not normal averages)
    max_sweeps: int | None = None,  # runaway backstop only: the while_loop
    # exits at the fixed point (absorbed bands on real frames converge in
    # tens of sweeps — the front advances one pixel per sweep). None = h*w,
    # above any pixel path length, so no input (even a stereo panorama with
    # a serpentine band longer than any fixed constant) is truncated short
    # of the oracle's unbounded fixed point
    distance_threshold: float = DISTANCE_THRESHOLD,
    min_inliers: int = MIN_INLIERS,
):
    """Boundary refinement after the flood fill — the 'refine' half of PCL's
    segmentAndRefine (reference include/Frame360.h:977): valid pixels left
    unlabeled (their normal was rejected near a depth edge) are absorbed by
    an adjacent region when their point fits that region's plane model within
    DISTANCE_THRESHOLD.

    PCL-faithful semantics (round 5, forced by the independent scalar oracle
    — tools/cpp_oracle/planes_oracle.cpp seg mode, tests/test_seg_oracle.py):

      * only ACCEPTED regions grow — components with >= min_inliers
        segment-stage pixels (PCL computes models in segment() for exactly
        those and its refinement comparator only grows model labels; the
        previous any-label growth let sub-threshold fragments inflate past
        the min-inlier filter);
      * the model is the segment-stage least-squares plane fit (centroid +
        covariance smallest eigenvector, the same quantity PCL stores in
        model_coefficients), not the mean of the per-pixel normals;
      * growth runs to the FIXED POINT, not a fixed dilation count (the
        previous 8-sweep cap left most of each absorbable band unlabeled —
        measured 1.8-6k px/sensor against the oracle on the bundled frames).

    Contested pixels (several fitting neighbour regions) take the largest
    label; PCL's own winner is scan-order-dependent, so the oracle mirrors
    this tie-break to keep the comparison about semantics, not schedule.
    """
    h, w = labels.shape
    hw = h * w
    if max_sweeps is None:
        max_sweeps = hw
    valid_xyz = jnp.all(jnp.isfinite(xyz), axis=-1)
    p = jnp.where(valid_xyz[..., None], xyz, 0.0)

    # segment-stage least-squares models per label: one full-hw scatter-add
    # for counts + coordinate sums, then — when the grid admits it — a
    # REBIN into KP = hw/min_inliers + 1 top-count slots for the second
    # moments and the eigendecomposition (pigeonhole: no label with
    # >= min_inliers pixels can fall outside the top-KP by count, so the
    # model SET is exactly the full-bin path's; the saving is mostly the
    # (hw+1)-row _eigh3x3, not measured on the H100).
    # The full-(hw+1)-bin path remains for grids where KP would be large
    # (e.g. a stereo panorama at min_inliers=40), where the top_k would
    # cost more than the eigh saves.
    from rgbd360_tpu.ops.plane_stats import _eigh3x3

    labf = labels.reshape(-1)
    bin_ = jnp.where(labf >= 0, labf, hw)
    pf = p.reshape(-1, 3)
    feat = jnp.concatenate([pf, jnp.ones((hw, 1), jnp.float32)], axis=-1)
    sums = jnp.zeros((hw + 1, 4), jnp.float32).at[bin_].add(feat)
    cnt_all = sums[:, 3]

    # clamp to hw: at min_inliers=1 the pigeonhole bound is hw+1 but top_k
    # can return at most hw slots (and all hw bins ARE the full set)
    KP = min(hw, hw // max(min_inliers, 1) + 1)
    if KP <= 512:
        topc, topi = jax.lax.top_k(cnt_all[:hw], KP)
        inv = jnp.full((hw + 1,), KP, jnp.int32).at[topi].set(
            jnp.arange(KP, dtype=jnp.int32)
        )
        pix_k = jnp.take(inv, bin_)  # (hw,) slot of each pixel's label
        cnt = topc
        centroid = sums[topi, :3] / jnp.maximum(cnt[:, None], 1.0)
        cpad = jnp.concatenate([centroid, jnp.zeros((1, 3), jnp.float32)], axis=0)
        d = pf - jnp.take(cpad, pix_k, axis=0)
        d = jnp.where(((labf >= 0) & (pix_k < KP))[:, None], d, 0.0)
        s2_bins, s2_idx, nb = KP + 1, pix_k, KP
    else:
        pix_k = bin_
        cnt = cnt_all
        centroid = sums[:, :3] / jnp.maximum(cnt[:, None], 1.0)
        d = pf - jnp.take(centroid, bin_, axis=0)
        d = jnp.where((labf >= 0)[:, None], d, 0.0)
        s2_bins, s2_idx, nb = hw + 1, bin_, hw + 1
    prods = jnp.stack(
        [
            d[:, 0] * d[:, 0], d[:, 0] * d[:, 1], d[:, 0] * d[:, 2],
            d[:, 1] * d[:, 1], d[:, 1] * d[:, 2], d[:, 2] * d[:, 2],
        ],
        axis=-1,
    )
    s2 = jnp.zeros((s2_bins, 6), jnp.float32).at[s2_idx].add(prods)[:nb]
    s2 = s2 / jnp.maximum(cnt[:nb, None], 1.0)
    cov = jnp.stack(
        [
            jnp.stack([s2[:, 0], s2[:, 1], s2[:, 2]], axis=-1),
            jnp.stack([s2[:, 1], s2[:, 3], s2[:, 4]], axis=-1),
            jnp.stack([s2[:, 2], s2[:, 4], s2[:, 5]], axis=-1),
        ],
        axis=-2,
    )
    _, n_min = _eigh3x3(cov)
    flip = jnp.sum(n_min * centroid[:nb], axis=-1) > 0  # toward-sensor (:988-992)
    n_model = jnp.where(flip[:, None], -n_min, n_min)
    d_model = jnp.sum(n_model * centroid[:nb], axis=-1)
    is_model = cnt[:nb] >= min_inliers

    NOLAB = jnp.int32(-1)

    # per-pixel model of the pixel's OWN region (model labels only): the
    # region models are fixed for all sweeps, so each pixel carries its
    # label's (normal, d) alongside the label — then every sweep's candidate
    # models come from 1-pixel SHIFTS of these carried planes (pure
    # elementwise work) instead of per-candidate gathers into the model
    # tables, which dominated this function's device time (4 candidate
    # labels x 2 gathers x 8 sweeps)
    own = jnp.clip(pix_k, 0, nb - 1)
    in_tbl = (labf >= 0) & (pix_k < nb)
    grows = (jnp.take(is_model, own) & in_tbl).reshape(h, w)
    mod_n = jnp.where(
        in_tbl[:, None], jnp.take(n_model, own, axis=0), 0.0
    ).reshape(h, w, 3)
    mod_d = jnp.where(in_tbl, jnp.take(d_model, own), 0.0).reshape(h, w)
    # non-model pixels must never seed growth: mark them with the NOLAB
    # sentinel in the label plane the sweeps read
    lab_grow0 = jnp.where(grows, labels, NOLAB)

    def shift(arr, dr, dc, fill):
        pad = [(max(dr, 0), max(-dr, 0)), (max(dc, 0), max(-dc, 0))] + [
            (0, 0)
        ] * (arr.ndim - 2)
        out = jnp.pad(arr, pad, constant_values=fill)
        return out[
            max(-dr, 0) : max(-dr, 0) + h, max(-dc, 0) : max(-dc, 0) + w
        ]

    def body(state):
        lab_grow, mod_n, mod_d, _changed, it = state
        # each neighbour label is tested against ITS OWN plane model: a
        # boundary pixel between a fitting region and a non-fitting one must
        # still be absorbed (taking only the max label and testing that one
        # candidate left such pixels unlabeled forever)
        best = jnp.full((h, w), NOLAB)
        best_n = jnp.zeros((h, w, 3), jnp.float32)
        best_d = jnp.zeros((h, w), jnp.float32)
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cand = shift(lab_grow, dr, dc, NOLAB)
            n_c = shift(mod_n, dr, dc, 0.0)
            d_c = shift(mod_d, dr, dc, 0.0)
            fit = jnp.abs(jnp.sum(n_c * p, axis=-1) - d_c) < distance_threshold
            take_it = (cand >= 0) & fit & (cand > best)
            best = jnp.where(take_it, cand, best)
            best_n = jnp.where(take_it[..., None], n_c, best_n)
            best_d = jnp.where(take_it, d_c, best_d)
        grow = (lab_grow < 0) & ~grows_static & valid_xyz & (best >= 0)
        lab_new = jnp.where(grow, best, lab_grow)
        mod_n = jnp.where(grow[..., None], best_n, mod_n)
        mod_d = jnp.where(grow, best_d, mod_d)
        return lab_new, mod_n, mod_d, jnp.any(grow), it + 1

    def cond(state):
        return state[3] & (state[4] < max_sweeps)

    # pixels labeled with a NON-model region keep their label and never
    # absorb (they are labeled, just not grow-eligible): exclude them from
    # the grow mask via this static plane
    grows_static = (labels >= 0) & ~grows

    lab_grow, _, _, _, _ = jax.lax.while_loop(
        cond, body, (lab_grow0, mod_n, mod_d, jnp.bool_(True), jnp.int32(0))
    )
    # stitch the untouched non-model labels back in
    return jnp.where(grows_static, labels, lab_grow)
