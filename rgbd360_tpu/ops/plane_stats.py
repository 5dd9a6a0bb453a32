"""On-device per-label plane statistics + hull-candidate extraction.

Moves the per-component fitting of plane extraction (reference
include/Frame360.h:979-1075 getPlanesSensor: centroid / covariance /
eigendecomposition / contour) from the host onto the device so that only
per-plane statistics, a hull-candidate mask and an f16 cloud cross to the
host instead of full f32 clouds.

The float scatter-adds below run as atomics on a GPU, so the sums may
differ in the last bits from run to run (chip_smoke.py bounds it).

Per sensor (vmapped to the 8-sensor batch):
  * scatter-add per-label counts and coordinate sums over the pixel-index
    labels from ops/planes_seg (bins are flat pixel indices — no compaction
    pass needed, the (H*W+1)-row scratch lives only inside the jit);
  * top-K label selection by count (K=64 generously exceeds the ~5-20
    regions PCL-equivalent segmentation produces on QVGA/2 frames);
  * second centered scatter pass -> per-label 3x3 covariance with no
    catastrophic cancellation (a raw-moment difference in f32 would lose
    the smallest eigenvalue, which IS the curvature gate quantity);
  * closed-form symmetric 3x3 eigensolver (trig method) -> eigenvalues,
    sensor-oriented normal, curvature;
  * the octagon-of-extremes hull prefilter as device reductions: per-label
    directional maxima over 8 directions in the plane basis, witness-pixel
    selection, then a point-in-octagon test per pixel. The candidate mask is
    conservative (boundary margin eps keeps every true hull vertex), so the
    host's exact monotone-chain hull over the candidates equals the hull
    over all inliers — same guarantee the host-side octagon prefilter gives;
  * per-label hue histogram (74 bins, mrpt calcPlaneHistH reconstruction —
    core/pbmap.rgb_to_hue_hist semantics) and RGB sums via one scatter-add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.ops.planes_seg import MIN_INLIERS  # noqa: F401  (re-export)

MAX_LABELS = 64  # top-K per-sensor label budget
HIST_H_BINS = 74
_OCT_EPS = 1e-5  # conservative inside-test margin (m^2 cross-product units)


class SensorPlaneStats(NamedTuple):
    """Two fit bases ride in one row (reference semantics: PCL fits
    model/centroid/curvature in segment(), BEFORE refinement, and Frame360
    reads regions[i] from those pre-refine fits, while the inlier
    set/hull/colors come from the REFINED labels; a merge then refits from
    the union of refined inliers — pbmap mergePlane2):

      * mean/cov/count: REFINED (post-refine) members — the sufficient
        statistics merges combine;
      * mean_pre/evals/normal/curvature: the segment-stage (pre-refine)
        fit — the reported plane parameters of unmerged planes."""

    labels: jnp.ndarray  # (H, W) i32 refined labels, -1 invalid
    candidate: jnp.ndarray  # (H, W) bool hull-candidate mask
    label_id: jnp.ndarray  # (K,) i32 original label of each selected row
    count: jnp.ndarray  # (K,) i32 refined inlier count (0 = empty slot)
    mean: jnp.ndarray  # (K, 3) f32 refined-member centroid
    cov: jnp.ndarray  # (K, 3, 3) f32 refined-member covariance (centered)
    evals: jnp.ndarray  # (K, 3) f32 descending eigenvalues (pre-refine fit)
    normal: jnp.ndarray  # (K, 3) f32 unit normal toward sensor (pre-refine)
    curvature: jnp.ndarray  # (K,) f32 lambda_min / trace (pre-refine)
    hist: jnp.ndarray  # (K, 74) f32 raw hue-histogram counts (refined)
    sum_rgb: jnp.ndarray  # (K, 3) f32 sums of RGB inlier colors (refined)
    mean_pre: jnp.ndarray  # (K, 3) f32 segment-stage centroid (reported)


def _eigh3x3(cov: jnp.ndarray):
    """Batched closed-form symmetric 3x3 eigendecomposition (trig method).

    cov: (..., 3, 3). Returns (evals (...,3) descending, evec_min (...,3)
    the eigenvector of the smallest eigenvalue)."""
    a00 = cov[..., 0, 0]
    a11 = cov[..., 1, 1]
    a22 = cov[..., 2, 2]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a12 = cov[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    # B = (A - q I) / p ; r = det(B) / 2
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(detb / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)  # largest
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    # near-diagonal matrices: fall back to sorted diagonal
    diag = jnp.stack([a00, a11, a22], axis=-1)
    dsort = jnp.sort(diag, axis=-1)[..., ::-1]
    tiny = p1 < 1e-20
    evals = jnp.where(
        tiny[..., None], dsort, jnp.stack([e1, e2, e3], axis=-1)
    )

    # eigenvector of the smallest eigenvalue: the largest cross product of
    # two rows of (A - e3 I)
    lam = evals[..., 2]
    r0 = jnp.stack([a00 - lam, a01, a02], axis=-1)
    r1 = jnp.stack([a01, a11 - lam, a12], axis=-1)
    r2 = jnp.stack([a02, a12, a22 - lam], axis=-1)
    c0 = jnp.cross(r1, r2)
    c1 = jnp.cross(r2, r0)
    c2 = jnp.cross(r0, r1)
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    best = jnp.where(
        ((n0 >= n1) & (n0 >= n2))[..., None],
        c0,
        jnp.where((n1 >= n2)[..., None], c1, c2),
    )
    nrm = jnp.sqrt(jnp.maximum(jnp.sum(best * best, axis=-1, keepdims=True), 1e-30))
    vec = best / nrm
    # degenerate (isotropic) fallback: z axis
    iso = (n0 < 1e-30) & (n1 < 1e-30) & (n2 < 1e-30)
    vec = jnp.where(iso[..., None], np.array([0.0, 0.0, 1.0], vec.dtype), vec)
    return evals, vec


def _plane_basis(n: jnp.ndarray):
    """Orthonormal in-plane basis, same convention as pbmap.Plane.plane_basis:
    a = x if |n_x|<0.9 else y;  u = normalize(n x a);  v = n x u."""
    ax = jnp.where(
        (jnp.abs(n[..., 0]) < 0.9)[..., None],
        np.array([1.0, 0.0, 0.0], n.dtype),
        np.array([0.0, 1.0, 0.0], n.dtype),
    )
    u = jnp.cross(n, ax)
    u = u / jnp.sqrt(jnp.maximum(jnp.sum(u * u, axis=-1, keepdims=True), 1e-30))
    v = jnp.cross(n, u)
    return u, v


def _hue_bins(rgb_bgr_u8: jnp.ndarray) -> jnp.ndarray:
    """74-bin hue bin index per pixel (core/pbmap.rgb_to_hue_hist semantics);
    input is the stored BGR byte order."""
    c = rgb_bgr_u8.astype(jnp.float32) / 255.0
    b, g, r = c[..., 0], c[..., 1], c[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    s = jnp.where(v > 1e-9, (v - mn) / jnp.maximum(v, 1e-9), 0.0)
    delta = jnp.maximum(v - mn, 1e-9)
    h = (
        jnp.where(
            v == r,
            ((g - b) / delta) % 6.0,
            jnp.where(v == g, (b - r) / delta + 2.0, (r - g) / delta + 4.0),
        )
        * 60.0
    )
    bins = jnp.clip((h / 360.0 * 72.0).astype(jnp.int32), 0, 71)
    return jnp.where(v < 0.3, 72, jnp.where(s < 0.2, 73, bins))


# 8 directions at 45 degrees, in angular (CCW) order — their per-label
# extreme points form a convex polygon whose vertices are dataset points.
# NUMPY on purpose: a module-level DEVICE array would be captured as a jaxpr
# constant whose value lowering must fetch back from the device (and wait
# behind the device queue); a host constant lowers instantly.
_SQ2 = 0.7071067811865476
_OCT_DIRS = np.array(
    [
        [1.0, 0.0],
        [_SQ2, _SQ2],
        [0.0, 1.0],
        [-_SQ2, _SQ2],
        [-1.0, 0.0],
        [-_SQ2, -_SQ2],
        [0.0, -1.0],
        [_SQ2, -_SQ2],
    ],
    np.float32,
)


def sensor_plane_stats(
    xyz: jnp.ndarray,  # (H, W, 3) f32, NaN-invalid
    rgb_bgr: jnp.ndarray,  # (H, W, 3) u8 BGR
    labels: jnp.ndarray,  # (H, W) i32 REFINED labels (-1 invalid)
    labels_pre: jnp.ndarray,  # (H, W) i32 segment-stage labels (-1 invalid);
    # pre ids are a subset of refined ids (refine only grows model regions
    # and keeps their root ids), so both bin into the same top-K slots
) -> SensorPlaneStats:
    h, w = labels.shape
    hw = h * w
    K = MAX_LABELS
    labf = labels.reshape(-1)
    labeled = labf >= 0
    bin_ = jnp.where(labeled, labf, hw)
    labf_pre = labels_pre.reshape(-1)
    labeled_pre = labf_pre >= 0
    bin_pre = jnp.where(labeled_pre, labf_pre, hw)
    p = jnp.where(jnp.isfinite(xyz), xyz, 0.0).reshape(-1, 3)

    # pass 1 (refined): counts + coordinate sums — the merge suffstats basis
    feat1 = jnp.concatenate([jnp.ones((hw, 1), jnp.float32), p], axis=-1)
    feat1 = jnp.where(labeled[:, None], feat1, 0.0)
    s1 = jnp.zeros((hw + 1, 4), jnp.float32).at[bin_].add(feat1)
    counts_all = s1[:hw, 0]

    topc, topi = jax.lax.top_k(counts_all, K)
    count = topc.astype(jnp.int32)
    mean = s1[topi, 1:4] / jnp.maximum(topc[:, None], 1.0)

    # inverse table: label -> selected slot (K = not selected / invalid)
    inv = jnp.full((hw + 1,), K, jnp.int32).at[topi].set(jnp.arange(K, dtype=jnp.int32))
    pix_k = jnp.take(inv, bin_)  # (N,)
    pix_k_pre = jnp.take(inv, bin_pre)

    # pass 1b (pre): the segment-stage centroid (the reported center)
    feat1p = jnp.where(labeled_pre[:, None], feat1, 0.0)
    s1p = jnp.zeros((K + 1, 4), jnp.float32).at[pix_k_pre].add(feat1p)[:K]
    cnt_pre = s1p[:, 0]
    mean_pre = s1p[:, 1:4] / jnp.maximum(cnt_pre[:, None], 1.0)

    # pass 2 (refined): centered second moments — merge suffstats
    mean_pad = jnp.concatenate([mean, jnp.zeros((1, 3), jnp.float32)], axis=0)
    d = p - jnp.take(mean_pad, pix_k, axis=0)
    d = jnp.where((labeled & (pix_k < K))[:, None], d, 0.0)

    def _second_moments(dc, pk, cnts):
        prods = jnp.stack(
            [
                dc[:, 0] * dc[:, 0],
                dc[:, 0] * dc[:, 1],
                dc[:, 0] * dc[:, 2],
                dc[:, 1] * dc[:, 1],
                dc[:, 1] * dc[:, 2],
                dc[:, 2] * dc[:, 2],
            ],
            axis=-1,
        )
        s2 = jnp.zeros((K + 1, 6), jnp.float32).at[pk].add(prods)[:K]
        s2 = s2 / jnp.maximum(cnts[:, None], 1.0)
        return jnp.stack(
            [
                jnp.stack([s2[:, 0], s2[:, 1], s2[:, 2]], axis=-1),
                jnp.stack([s2[:, 1], s2[:, 3], s2[:, 4]], axis=-1),
                jnp.stack([s2[:, 2], s2[:, 4], s2[:, 5]], axis=-1),
            ],
            axis=-2,
        )

    cov = _second_moments(d, pix_k, topc)

    # pass 2b (pre): the segment-stage fit — reported normal/curvature
    # (reference: PCL fits models in segment(), Frame360.h:979-1002 reads
    # regions[i]/model_coefficients[i] from those pre-refine fits)
    mean_pre_pad = jnp.concatenate([mean_pre, jnp.zeros((1, 3), jnp.float32)], axis=0)
    d_pre = p - jnp.take(mean_pre_pad, pix_k_pre, axis=0)
    d_pre = jnp.where((labeled_pre & (pix_k_pre < K))[:, None], d_pre, 0.0)
    cov_pre = _second_moments(d_pre, pix_k_pre, cnt_pre)

    evals, n_min = _eigh3x3(cov_pre)
    # orient toward the sensor (reference Frame360.h:988-992)
    flip = jnp.sum(n_min * mean_pre, axis=-1) > 0
    normal = jnp.where(flip[:, None], -n_min, n_min)
    curvature = evals[:, 2] / jnp.maximum(evals.sum(axis=-1), 1e-12)

    # octagon-of-extremes candidate mask over the REFINED members, in the
    # reported (pre-fit) plane basis — the same frame the host hull uses
    u, v = _plane_basis(normal)
    u_pad = jnp.concatenate([u, jnp.zeros((1, 3), jnp.float32)], axis=0)
    v_pad = jnp.concatenate([v, jnp.zeros((1, 3), jnp.float32)], axis=0)
    d_oct = p - jnp.take(mean_pre_pad, pix_k, axis=0)
    du = jnp.sum(d_oct * jnp.take(u_pad, pix_k, axis=0), axis=-1)
    dv = jnp.sum(d_oct * jnp.take(v_pad, pix_k, axis=0), axis=-1)
    p2 = jnp.stack([du, dv], axis=-1)  # (N, 2) in-plane coordinates
    dots = p2 @ _OCT_DIRS.T  # (N, 8)
    in_sel = labeled & (pix_k < K)
    dots_m = jnp.where(in_sel[:, None], dots, -jnp.inf)
    M = jnp.full((K + 1, 8), -jnp.inf).at[pix_k].max(dots_m)
    m_here = jnp.take(M, pix_k, axis=0)  # (N, 8)
    witness = in_sel[:, None] & (dots >= m_here - 1e-6)
    # one well-defined witness pixel per (label, direction): the max index
    pidx = jnp.arange(hw, dtype=jnp.int32)[:, None]
    wit_idx = jnp.where(witness, pidx, -1)
    widx = jnp.full((K + 1, 8), -1, jnp.int32).at[pix_k].max(wit_idx)[:K]
    wsafe = jnp.clip(widx.reshape(-1), 0, hw - 1)
    verts = jnp.take(p2, wsafe, axis=0).reshape(K, 8, 2)
    # empty labels: collapse octagon to the origin (everything is candidate)
    verts = jnp.where((widx >= 0)[..., None], verts, 0.0)

    # point-in-octagon (strict, with conservative margin): CCW edge walk
    verts_pad = jnp.concatenate([verts, jnp.zeros((1, 8, 2), jnp.float32)], axis=0)
    vt = jnp.take(verts_pad, pix_k, axis=0)  # (N, 8, 2)
    vt_next = jnp.roll(vt, -1, axis=1)
    e = vt_next - vt  # (N, 8, 2) octagon edges
    rel = p2[:, None, :] - vt  # (N, 8, 2)
    cross = e[..., 0] * rel[..., 1] - e[..., 1] * rel[..., 0]
    nondeg = jnp.sum(e * e, axis=-1) > 1e-18
    inside = jnp.all(~nondeg | (cross > _OCT_EPS), axis=-1) & jnp.any(nondeg, axis=-1)
    candidate = (in_sel & ~inside).reshape(h, w)

    # hue histogram + color sums
    hue = _hue_bins(rgb_bgr).reshape(-1)
    ones = jnp.where(in_sel, 1.0, 0.0)
    hist = (
        jnp.zeros((K + 1, HIST_H_BINS), jnp.float32)
        .at[pix_k, hue]
        .add(ones)[:K]
    )
    rgb = rgb_bgr.reshape(-1, 3)[:, ::-1].astype(jnp.float32)
    rgb = jnp.where(in_sel[:, None], rgb, 0.0)
    sum_rgb = jnp.zeros((K + 1, 3), jnp.float32).at[pix_k].add(rgb)[:K]

    return SensorPlaneStats(
        labels=labels,
        candidate=candidate,
        label_id=topi.astype(jnp.int32),
        count=count,
        mean=mean,
        cov=cov,
        evals=evals,
        normal=normal,
        curvature=curvature,
        hist=hist,
        sum_rgb=sum_rgb,
        mean_pre=mean_pre,
    )
