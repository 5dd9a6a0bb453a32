"""Fast bilateral filter on the z channel of an organized cloud.

Replicates PCL's FastBilateralFilter (Paris & Durand bilateral grid) as used
by the frame pipeline with sigma_s=10 px, sigma_r=0.05 m (reference
include/Frame360.h:417-430, 493-499). Like PCL, only z is filtered; x and y
keep their un-filtered values.

Grid shape ~ (H/10+4, W/10+4, zrange/0.05+4): splat (z, 1) homogeneous
values, blur each axis with a [1 2 1]/4 kernel, slice with trilinear
interpolation. The splat is a scatter-add over a tiny grid, which XLA
handles fine at this size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

SIGMA_S = 10.0
SIGMA_R = 0.05
_PAD = 2


def _blur_axis(grid: jnp.ndarray, axis: int) -> jnp.ndarray:
    lo = jnp.roll(grid, 1, axis)
    hi = jnp.roll(grid, -1, axis)
    return 0.25 * lo + 0.5 * grid + 0.25 * hi


@functools.partial(jax.jit, static_argnames=())
def fast_bilateral_z(z: jnp.ndarray) -> jnp.ndarray:
    """z: (H, W) f32 with NaN invalid. Returns filtered z (NaN preserved)."""
    h, w = z.shape
    valid = jnp.isfinite(z)
    zv = jnp.where(valid, z, 0.0)
    zmin = jnp.min(jnp.where(valid, z, jnp.inf))
    zmin = jnp.where(jnp.isfinite(zmin), zmin, 0.0)

    gh = int(round(h / SIGMA_S)) + 1 + 2 * _PAD
    gw = int(round(w / SIGMA_S)) + 1 + 2 * _PAD
    # depth range bins: generous static bound (10 m / 0.05 = 200)
    gd = 200 + 1 + 2 * _PAD

    yy = jnp.arange(h, dtype=jnp.float32)[:, None] / SIGMA_S + _PAD
    xx = jnp.arange(w, dtype=jnp.float32)[None, :] / SIGMA_S + _PAD
    # clamp the depth coordinate into the static grid span: beyond it the
    # trilinear slice would EXTRAPOLATE (fractional weights like 1-fz=-86)
    # instead of clamping like the splat's di clip does
    dd = jnp.clip((zv - zmin) / SIGMA_R + _PAD, 0.0, float(200 + _PAD))
    yi = jnp.clip(jnp.round(yy).astype(jnp.int32), 0, gh - 1)
    xi = jnp.clip(jnp.round(xx).astype(jnp.int32), 0, gw - 1)
    di = jnp.clip(jnp.round(dd).astype(jnp.int32), 0, gd - 1)
    yi = jnp.broadcast_to(yi, (h, w))
    xi = jnp.broadcast_to(xi, (h, w))

    # splat WITHOUT a scatter (a data-dependent scatter-add; whether it is
    # slower than this dense form is not measured on the H100): the spatial
    # cell (yi, xi) of every pixel is FIXED by the pixel grid, only the depth
    # bin is data-dependent. So bin densely over depth (one compare per
    # (pixel, bin)) and contract the pixel axes with static 0/1
    # cell-membership matrices. The contractions run at full f32 (package
    # matmul policy, rgbd360_tpu/__init__.py): TF32 would swamp metre-scale
    # z sums.
    oh = (di[..., None] == jnp.arange(gd, dtype=jnp.int32)) & valid[..., None]
    ohf = oh.astype(jnp.float32)
    dense = jnp.stack([ohf * zv[..., None], ohf], axis=-1)  # (h, w, gd, 2)
    sy = (yi[:, 0, None] == jnp.arange(gh, dtype=jnp.int32)).astype(jnp.float32)
    sx = (xi[0, :, None] == jnp.arange(gw, dtype=jnp.int32)).astype(jnp.float32)
    grid = jnp.einsum("rg,rwdc->gwdc", sy, dense)
    grid = jnp.einsum("wx,gwdc->gxdc", sx, grid)
    for axis in range(3):
        grid = _blur_axis(grid, axis)

    # trilinear slice = fixed spatial bilinear x data-dependent depth linear.
    # The spatial corner positions/weights depend only on the PIXEL GRID, so
    # the (y, x) half is a static bilinear resize — two tiny dense matmuls —
    # and only the depth axis is data-dependent (its cost against the
    # 8-corner gather form is not measured on the H100)
    y1d = yy[:, 0]
    x1d = xx[0, :]
    y0r = jnp.clip(jnp.floor(y1d).astype(jnp.int32), 0, gh - 2)
    x0c = jnp.clip(jnp.floor(x1d).astype(jnp.int32), 0, gw - 2)
    fy1 = y1d - y0r
    fx1 = x1d - x0c
    wy = (
        jax.nn.one_hot(y0r, gh, dtype=jnp.float32) * (1 - fy1)[:, None]
        + jax.nn.one_hot(y0r + 1, gh, dtype=jnp.float32) * fy1[:, None]
    )
    wx = (
        jax.nn.one_hot(x0c, gw, dtype=jnp.float32) * (1 - fx1)[:, None]
        + jax.nn.one_hot(x0c + 1, gw, dtype=jnp.float32) * fx1[:, None]
    )
    # full f32 matters here too: reduced-precision z would swamp the
    # 0.02 m segmentation threshold downstream (observed with a 2-digit
    # matmul precision: 15 -> 7 merged planes on the bundled frame)
    up = jnp.einsum("rg,gwdc->rwdc", wy, grid)
    up = jnp.einsum("xw,rwdc->rxdc", wx, up)  # (h, w, gd, 2)

    # depth slice, also gather-free: a per-pixel two-hot weight row over the
    # depth bins contracted against the upsampled profiles
    z0 = jnp.clip(jnp.floor(dd).astype(jnp.int32), 0, gd - 2)
    fz = dd - z0
    bins = jnp.arange(gd, dtype=jnp.int32)
    wz = (z0[..., None] == bins) * (1 - fz)[..., None] + (
        (z0 + 1)[..., None] == bins
    ) * fz[..., None]
    acc = jnp.einsum("rwd,rwdc->rwc", wz, up)
    num = acc[..., 0]
    den = acc[..., 1]
    zf = jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-12), z)
    return jnp.where(valid, zf, z)
