"""Pinhole backprojection + valid-aware downsampling for the per-sensor
organized point clouds (the inputs to plane segmentation).

Reference semantics:
  * backprojection (OpenNI2_Grabber/FrameRGBD/CloudRGBD_Ext.h:85-135):
    f = 525*w/640, cx = w/2-0.5, cy = h/2-0.5; valid depth in [0.3, 10.0] m,
    invalid points become NaN;
  * 2x downsampling (OpenNI2_Grabber/FrameRGBD/DownsampleRGBD.h:209-305):
    per 2x2 block, each coordinate is the *independent median* (element
    n//2 of the sorted valid samples, valid = finite with z in (0.3, 5.0));
    color comes from the block's lower-right (center) pixel; a block with no
    valid samples copies the center point verbatim (usually NaN).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

MIN_DEPTH = 0.3
MAX_DEPTH = 10.0
DOWNSAMPLE_MIN_DEPTH = 0.3
DOWNSAMPLE_MAX_DEPTH = 5.0


def backproject_organized(depth_m: jnp.ndarray) -> jnp.ndarray:
    """(H, W) f32 metres -> (H, W, 3) f32 organized cloud, NaN where invalid."""
    h, w = depth_m.shape
    focal = 525.0 * w / 640.0
    inv_f = 1.0 / focal
    ox = w / 2 - 0.5
    oy = h / 2 - 0.5
    x_img = jnp.arange(w, dtype=jnp.float32)[None, :]
    y_img = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = depth_m
    valid = (z > 0) & (z >= MIN_DEPTH) & (z <= MAX_DEPTH)
    x = (x_img - ox) * z * inv_f
    y = (y_img - oy) * z * inv_f
    nan = jnp.float32(jnp.nan)
    return jnp.stack(
        [jnp.where(valid, x, nan), jnp.where(valid, y, nan), jnp.where(valid, z, nan)],
        axis=-1,
    )


def _median_of_block(vals: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """vals/valid: (..., 4). Per-coordinate median as sorted_valid[n//2].

    Explicit 4-element min/max sorting network + select chain — the generic
    jnp.sort + take_along_axis this replaces lowered to a comparator sort
    plus a gather (their relative cost on the H100 is not measured)."""
    big = jnp.where(valid, vals, jnp.float32(jnp.inf))
    v0, v1, v2, v3 = (big[..., i] for i in range(4))
    a, b = jnp.minimum(v0, v1), jnp.maximum(v0, v1)
    c, d = jnp.minimum(v2, v3), jnp.maximum(v2, v3)
    lo = jnp.minimum(a, c)
    m1 = jnp.minimum(jnp.maximum(a, c), jnp.minimum(b, d))
    m2 = jnp.maximum(jnp.maximum(a, c), jnp.minimum(b, d))
    hi = jnp.maximum(b, d)
    idx = jnp.sum(valid, axis=-1) // 2
    return jnp.where(
        idx == 0, lo, jnp.where(idx == 1, m1, jnp.where(idx == 2, m2, hi))
    )


def downsample_median2(xyz: jnp.ndarray, rgb: jnp.ndarray):
    """2x 'median' downsample of an organized cloud + nearest color.

    xyz: (H, W, 3) with NaN invalid; rgb: (H, W, 3) uint8.
    Returns (xyz_half (H/2, W/2, 3), rgb_half).
    """
    h, w, _ = xyz.shape
    blocks = xyz.reshape(h // 2, 2, w // 2, 2, 3).transpose(0, 2, 4, 1, 3).reshape(
        h // 2, w // 2, 3, 4
    )
    z = blocks[:, :, 2, :]
    valid = jnp.isfinite(blocks[:, :, 0, :]) & (z > DOWNSAMPLE_MIN_DEPTH) & (
        z < DOWNSAMPLE_MAX_DEPTH
    )
    med = jnp.stack(
        [_median_of_block(blocks[:, :, c, :], valid) for c in range(3)], axis=-1
    )
    center = xyz[1::2, 1::2]  # block center pixel (r+1, c+1)
    any_valid = jnp.any(valid, axis=-1)
    out = jnp.where(any_valid[..., None], med, center)
    rgb_half = rgb[1::2, 1::2]
    return out, rgb_half
