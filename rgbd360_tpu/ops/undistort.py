"""Batched CLAMS depth undistortion.

The reference undistorts the 8 sensors with one OpenMP thread each, walking a
per-pixel frustum object tree (reference include/Frame360.h:293-310 +
CLAMS discrete_depth_distortion_model.cpp:49-70 interpolatedUndistort).

The frustum lookup would need five per-pixel table reads; since the
depth-bin count is tiny (K=5 for the shipped models), it is restated
gather-free: the spatial binning is a plain `repeat` broadcast of the
(BY, BX) tables to pixel resolution, and the depth-bin selection is a
K-term masked select-sum — dense elementwise work, numerically identical
(its speed against the gather form is not measured on the H100).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# interpolatedUndistort falls back to nearest-bin when either bracketing depth
# bin has fewer than 50 training examples (discrete_depth_distortion_model.cpp:60)
MIN_COUNTS = 50.0


@functools.partial(jax.jit, static_argnames=("bin_width", "bin_height", "bin_depth"))
def undistort_depth_mm(
    depth_raw_mm: jnp.ndarray,  # (S, H, W) u16 millimetres, 0 = invalid
    multipliers: jnp.ndarray,
    counts: jnp.ndarray,
    bin_width: int = 4,
    bin_height: int = 3,
    bin_depth: float = 2.0,
) -> jnp.ndarray:
    """undistort_depth with the loadDepthEigen u16-mm -> f32-m conversion
    fused inside the jit (one dispatch instead of two per frame)."""
    return undistort_depth(
        depth_raw_mm.astype(jnp.float32) * 0.001,
        multipliers,
        counts,
        bin_width=bin_width,
        bin_height=bin_height,
        bin_depth=bin_depth,
    )


@functools.partial(jax.jit, static_argnames=("bin_width", "bin_height", "bin_depth"))
def undistort_depth(
    depth_m: jnp.ndarray,  # (S, H, W) f32 metres, 0 = invalid
    multipliers: jnp.ndarray,  # (S, BY, BX, K) f32
    counts: jnp.ndarray,  # (S, BY, BX, K) f32
    bin_width: int = 4,
    bin_height: int = 3,
    bin_depth: float = 2.0,
) -> jnp.ndarray:
    s, h, w = depth_m.shape
    by, bx, k = multipliers.shape[1:]

    z = depth_m
    idx = jnp.minimum(k - 1, jnp.floor(z / bin_depth)).astype(jnp.int32)
    start = bin_depth * idx.astype(jnp.float32)
    idx1 = jnp.where(z - start < bin_depth * 0.5, idx, idx + 1)
    idx0 = idx1 - 1

    def expand(plane):  # (S, BY, BX) -> (S, H, W) spatial-bin broadcast
        e = jnp.repeat(jnp.repeat(plane, bin_height, axis=1), bin_width, axis=2)
        return e[:, :h, :w]

    # depth-bin selection as a K-term masked select (no gathers)
    m_near = jnp.ones_like(z)
    m0 = jnp.ones_like(z)
    m1 = jnp.ones_like(z)
    for b in range(k):
        mb = expand(multipliers[:, :, :, b])
        m_near = jnp.where(idx == b, mb, m_near)
        m0 = jnp.where(idx0 == b, mb, m0)
        m1 = jnp.where(idx1 == b, mb, m1)
    # counts only matter through the bracketing-pair validity test
    pair_ok = jnp.zeros(z.shape, bool)
    for b in range(k - 1):
        ok_b = expand(
            (counts[:, :, :, b] >= MIN_COUNTS) & (counts[:, :, :, b + 1] >= MIN_COUNTS)
        )
        pair_ok = jnp.where(idx0 == b, ok_b, pair_ok)

    use_nearest = (idx0 < 0) | (idx1 >= k) | ~pair_ok
    z0 = (idx0.astype(jnp.float32) + 1.0) * bin_depth - bin_depth * 0.5
    coeff1 = (z - z0) / bin_depth
    m_interp = (1.0 - coeff1) * m0 + coeff1 * m1
    mult = jnp.where(use_nearest, m_near, m_interp)
    return jnp.where(z == 0.0, z, z * mult)
