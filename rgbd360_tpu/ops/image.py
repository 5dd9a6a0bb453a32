"""Image-space ops: gray conversion, Gaussian pyramids, valid-aware depth
pyramids and the weighted first-order ("Jaimez") gradients.

All functions are pure, shape-static, jit/vmap-friendly, and operate on
(H, W) or (H, W, C) float32/uint8 arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def round_half_away(x: jnp.ndarray) -> jnp.ndarray:
    """C's round(): halfway cases away from zero (jnp.round is half-to-even)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def bgr_to_gray_u8(img: jnp.ndarray) -> jnp.ndarray:
    """OpenCV CV_RGB2GRAY applied to a BGR uint8 image, exactly as the
    reference does (include/RegisterPhotoICP.h:485: the stored channel order
    is BGR but CV_RGB2GRAY weights channel0 with 0.299). Fixed-point rounding
    matches OpenCV: (c0*4899 + c1*9617 + c2*1868 + 8192) >> 14."""
    img = img.astype(jnp.int32)
    gray = (img[..., 0] * 4899 + img[..., 1] * 9617 + img[..., 2] * 1868 + (1 << 13)) >> 14
    return gray.astype(jnp.uint8)


def gray_f32(img_bgr_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 BGR -> float gray in [0,1] (reference RegisterPhotoICP.h:485-486)."""
    return bgr_to_gray_u8(img_bgr_u8).astype(jnp.float32) * (1.0 / 255.0)


# 5-tap binomial kernel used by cv::pyrDown
_PYR_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _reflect101_pad(img: jnp.ndarray, pad: int, axis: int) -> jnp.ndarray:
    """OpenCV BORDER_REFLECT_101 padding (gfedcb|abcdefgh|gfedcba)."""
    return jnp.pad(img, [(pad, pad) if a == axis else (0, 0) for a in range(img.ndim)], mode="reflect")


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown equivalent: 5x5 Gaussian blur (reflect-101 border) then
    decimation keeping even rows/cols. The reference passes an explicit
    cv::Size(cols/2, rows/2) — FLOOR — (RegisterPhotoICP.h:292-308), and
    buildPyramidRange floors too, so odd dimensions must not produce the
    ceil-sized level a bare [::2] slice would (gray and depth pyramids
    would desynchronize)."""
    x = img.astype(jnp.float32)
    k = jnp.asarray(_PYR_KERNEL)
    # separable convolution, rows then cols
    xp = _reflect101_pad(x, 2, axis=0)
    x = sum(k[i] * xp[i : i + x.shape[0]] for i in range(5))
    xp = _reflect101_pad(x, 2, axis=1)
    x = sum(k[i] * xp[:, i : i + img.shape[1]] for i in range(5))
    h, w = img.shape[0], img.shape[1]
    return x[: 2 * (h // 2) : 2, : 2 * (w // 2) : 2]


def build_gray_pyramid(gray: jnp.ndarray, n_levels: int) -> list:
    pyr = [gray]
    for _ in range(1, n_levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def depth_down_valid(depth: jnp.ndarray, min_depth: float, max_depth: float) -> jnp.ndarray:
    """Valid-aware 2x2 averaging: mean over samples in (min_depth, max_depth),
    zero if none (reference RegisterPhotoICP.h:312-354 buildPyramidRange)."""
    h, w = depth.shape
    blocks = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    valid = (blocks > min_depth) & (blocks < max_depth)
    s = jnp.sum(jnp.where(valid, blocks, 0.0), axis=(1, 3))
    n = jnp.sum(valid, axis=(1, 3))
    return jnp.where(n > 0, s / jnp.maximum(n, 1), 0.0)


def build_depth_pyramid(depth_m: jnp.ndarray, n_levels: int, min_depth: float, max_depth: float) -> list:
    """depth_m: float32 metres (callers convert u16 mm with *0.001)."""
    pyr = [depth_m]
    for _ in range(1, n_levels):
        pyr.append(depth_down_valid(pyr[-1], min_depth, max_depth))
    return pyr


def gradient_xy(src: jnp.ndarray) -> tuple:
    """Weighted first-order gradient (reference RegisterPhotoICP.h:365-398):
    grad = 2 / (1/(next-cur) + 1/(cur-prev)), only where cur is strictly
    between its neighbors (monotone); zero elsewhere and on the border."""
    h, w = src.shape

    def _grad(prev, cur, nxt):
        d1 = nxt - cur
        d0 = cur - prev
        monotone = ((cur > nxt) & (cur < prev)) | ((cur < nxt) & (cur > prev))
        # harmonic mean of the two one-sided differences
        g = 2.0 * d1 * d0 / (d0 + d1)
        return jnp.where(monotone, g, 0.0)

    # interior-only (the reference loop runs r,c in [1, size-2]); zero-pad the
    # one-pixel border back on (cheap concat — avoids update-slice lowering)
    gx_core = _grad(src[1:-1, :-2], src[1:-1, 1:-1], src[1:-1, 2:])
    gy_core = _grad(src[:-2, 1:-1], src[1:-1, 1:-1], src[2:, 1:-1])
    gx = jnp.pad(gx_core, ((1, 1), (1, 1)))
    gy = jnp.pad(gy_core, ((1, 1), (1, 1)))
    return gx, gy


@functools.lru_cache(maxsize=None)
def _seam_mask(w: int, num_sensors: int) -> np.ndarray:
    width_sensor = w // num_sensors
    mask = np.ones((1, w), np.float32)
    for s in range(1, num_sensors):
        mask[0, s * width_sensor - 1 : s * width_sensor + 1] = 0.0
    return mask


def mask_sensor_seams(grad: jnp.ndarray, num_sensors: int = 8) -> jnp.ndarray:
    """Zero the 2-pixel columns at sensor joints of a spherical panorama to
    suppress auto-shutter seams (reference RegisterPhotoICP.h:4537-4549).
    Implemented as a broadcast multiply — a column-list .at[].set would lower
    to a scatter."""
    return grad * jnp.asarray(_seam_mask(grad.shape[1], num_sensors))
