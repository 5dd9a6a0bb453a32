"""Integral-image surface normals for organized clouds.

Equivalent of PCL IntegralImageNormalEstimation in AVERAGE_3D_GRADIENT mode
as configured by the reference (include/Frame360.h:949-967: smoothing 8,
max depth change 0.02, depth-dependent smoothing): per-pixel central-
difference 3D gradients along image x and y are box-averaged (validity-aware,
via cumulative-sum integral images — the dense-tensor equivalent of PCL's
integral images), and the normal is the normalized cross product, flipped
toward the viewpoint. Pixels whose averaging window straddles a depth
discontinuity larger than max_depth_change*depth are rejected like PCL's
depth-change map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _integral_image(img: jnp.ndarray) -> jnp.ndarray:
    """Padded 2D cumulative sum (integral image)."""
    ii = jnp.cumsum(jnp.cumsum(img, axis=0), axis=1)
    return jnp.pad(ii, [(1, 0), (1, 0)] + [(0, 0)] * (img.ndim - 2))


def _box_from_ii(ii: jnp.ndarray, r: int, h: int, w: int) -> jnp.ndarray:
    """Sum over a (2r+1)^2 window from a padded integral image."""
    import numpy as _np

    y0 = _np.clip(_np.arange(h) - r, 0, h)
    y1 = _np.clip(_np.arange(h) + r + 1, 0, h)
    x0 = _np.clip(_np.arange(w) - r, 0, w)
    x1 = _np.clip(_np.arange(w) + r + 1, 0, w)
    a = ii[y1][:, x1]
    b = ii[y1][:, x0]
    c = ii[y0][:, x1]
    d = ii[y0][:, x0]
    return a - b - c + d


def _box_sum_var(
    img: jnp.ndarray, r_px: jnp.ndarray, r_max: int, ii: jnp.ndarray = None
) -> jnp.ndarray:
    """Sum over a per-pixel (2*r_px+1)^2 window (PCL's variable smoothing
    window), r_px in [1, r_max]. r_max is small and static, so this is
    r_max STATIC box sums from one shared integral image + a select chain —
    it replaces per-pixel corner gathers (their cost against this form is
    not measured on the H100). Bit-identical output (same corner
    values from the same integral image, selected instead of gathered)."""
    h, w = img.shape[:2]
    if ii is None:
        ii = _integral_image(img)
    out = _box_from_ii(ii, 1, h, w)
    for rr in range(2, r_max + 1):
        sel = (r_px == rr)[..., None] if img.ndim == 3 else (r_px == rr)
        out = jnp.where(sel, _box_from_ii(ii, rr, h, w), out)
    return out


@functools.partial(jax.jit, static_argnames=("smoothing",))
def organized_normals(
    xyz: jnp.ndarray,  # (H, W, 3) with NaN invalid
    smoothing: int = 8,
    max_depth_change: float = 0.02,
):
    """Returns normals (H, W, 3) f32, NaN where invalid."""
    valid = jnp.all(jnp.isfinite(xyz), axis=-1)
    p = jnp.where(valid[..., None], xyz, 0.0)

    # central-difference 3D gradients (invalid where either neighbour invalid)
    gx = jnp.zeros_like(p).at[:, 1:-1].set(p[:, 2:] - p[:, :-2])
    gx_ok = jnp.zeros_like(valid).at[:, 1:-1].set(valid[:, 2:] & valid[:, :-2])
    gy = jnp.zeros_like(p).at[1:-1, :].set(p[2:, :] - p[:-2, :])
    gy_ok = jnp.zeros_like(valid).at[1:-1, :].set(valid[2:, :] & valid[:-2, :])

    # depth-discontinuity map: neighbour z jumps beyond max_depth_change*z
    z = xyz[..., 2]
    thr = jnp.maximum(max_depth_change * jnp.where(valid, z, 1.0), max_depth_change)
    jump_x = jnp.zeros_like(valid).at[:, 1:-1].set(
        (jnp.abs(z[:, 2:] - z[:, 1:-1]) > thr[:, 1:-1])
        | (jnp.abs(z[:, 1:-1] - z[:, :-2]) > thr[:, 1:-1])
    )
    jump_y = jnp.zeros_like(valid).at[1:-1, :].set(
        (jnp.abs(z[2:, :] - z[1:-1, :]) > thr[1:-1, :])
        | (jnp.abs(z[1:-1, :] - z[:-2, :]) > thr[1:-1, :])
    )
    edge = (jump_x | jump_y) & valid
    clean = valid & ~edge

    r = smoothing // 2
    gx_m = jnp.where((gx_ok & clean)[..., None], gx, 0.0)
    gy_m = jnp.where((gy_ok & clean)[..., None], gy, 0.0)
    cnt_x = (gx_ok & clean).astype(jnp.float32)
    cnt_y = (gy_ok & clean).astype(jnp.float32)
    # one 8-channel feature image -> ONE integral image / box-sum pass per
    # window type instead of four (the corner fetches gather 8-channel rows)
    feats = jnp.concatenate(
        [gx_m, gy_m, cnt_x[..., None], cnt_y[..., None]], axis=-1
    )

    # Primary path: full fixed window of masked gradients, accepted when a
    # supermajority of the window is edge-free (the smoothest estimate a
    # window not dominated by discontinuities can give; measured on the
    # bundled pair this beats pure window-shrinking, which fragments regions
    # near edges — see tests/test_planes.py::test_normals_edge_fillin).
    ii = _integral_image(feats)  # shared by the primary + fill-in windows
    box = _box_from_ii(ii, r, *feats.shape[:2])
    sum_gx, sum_gy, n_gx, n_gy = box[..., 0:3], box[..., 3:6], box[..., 6], box[..., 7]
    win = float((2 * r + 1) ** 2)
    normal = jnp.cross(sum_gx, sum_gy)
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    ok = (
        clean
        & (n_gx > 0.6 * win)
        & (n_gy > 0.6 * win)
        & (norm[..., 0] > 1e-12)
    )

    # Fill-in path: where the full window is edge-dominated, PCL's shrinking
    # window (IntegralImageNormalEstimation's distance map caps the smoothing
    # radius at the chessboard distance to the nearest depth discontinuity)
    # still yields a normal instead of a rejection. The distance transform is
    # r sweeps of 3x3 min+1 — exact up to r, all the cap can use.
    dist = jnp.where(edge, 0.0, float(r + 1))

    def min3x3(img):
        pd = jnp.pad(img, 1, constant_values=float(r + 1))
        return functools.reduce(
            jnp.minimum,
            [pd[1 + dy : 1 + dy + img.shape[0], 1 + dx : 1 + dx + img.shape[1]]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        )

    for _ in range(r):
        dist = jnp.minimum(dist, min3x3(dist) + 1.0)
    r_px = jnp.clip(dist - 1.0, 1.0, float(r)).astype(jnp.int32)  # per-pixel radius
    box_s = _box_sum_var(feats, r_px, r, ii=ii)
    sum_gx_s, sum_gy_s = box_s[..., 0:3], box_s[..., 3:6]
    n_gx_s, n_gy_s = box_s[..., 6], box_s[..., 7]
    normal_s = jnp.cross(sum_gx_s, sum_gy_s)
    norm_s = jnp.linalg.norm(normal_s, axis=-1, keepdims=True)
    ok_s = clean & (n_gx_s >= 2.0) & (n_gy_s >= 2.0) & (norm_s[..., 0] > 1e-12)

    use_fill = ~ok & ok_s
    normal = jnp.where(use_fill[..., None], normal_s, normal)
    norm = jnp.where(use_fill[..., None], norm_s, norm)
    ok = ok | ok_s

    normal = normal / jnp.maximum(norm, 1e-12)
    # flip toward the viewpoint (sensor at origin): n . p < 0
    flip = jnp.sum(normal * p, axis=-1) > 0
    normal = jnp.where(flip[..., None], -normal, normal)
    nan = jnp.float32(jnp.nan)
    return jnp.where(ok[..., None], normal, nan)
