"""Spherical panorama stitching as one batched gather-warp.

The reference warps each sensor's RGB-D image into its 240-column slice of
the 1920x320 panorama with a per-pixel inverse mapping through the sensor's
extrinsic inverse and the pinhole model, one OpenMP thread per sensor
(reference include/Frame360.h:386-405 stitchSphericalImage, :1098-1148
stitchImage). Here all 8 slices are a single vmapped gather kernel:
panorama (320, 1920) -> (8 sensors, 320, 240) blocks, each block sampling
its sensor's (240, 320) images at nearest (truncated) pixel.

Parity details replicated exactly:
  * sphere column block of sensor s is cols [(7-s)*240, (8-s)*240);
  * theta = (col - 1799.5) * 2*pi/1920, phi = (159.5 - row) * 2*pi/1920;
  * sampling uses C float->int truncation of (u, v);
  * the depth sample (u16 mm) is scaled by the ray obliquity factor
    sqrt(1 + ((u-cx)/fx)^2 + ((v-cy)/fy)^2) computed from *float* (u, v),
    then truncated back to u16 (reference include/Frame360.h:1142);
  * sphereDepth pixels never written stay 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("sphere_height", "sphere_width"))
def stitch_spherical(
    rgb: jnp.ndarray,  # (8, H, W, 3) uint8 (BGR)
    depth_mm: jnp.ndarray,  # (8, H, W) uint16
    Rt_inv: jnp.ndarray,  # (8, 4, 4) f32
    camera_matrix: jnp.ndarray,  # (3, 3) f32
    sphere_height: int = 320,
    sphere_width: int = 1920,
):
    """Returns (sphere_rgb (Hs,Ws,3) u8, sphere_depth (Hs,Ws) u16)."""
    num_sensors, size_h, size_w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    block_w = size_h  # 240 panorama columns per sensor
    assert sphere_width == num_sensors * block_w

    fx = camera_matrix[0, 0]
    fy = camera_matrix[1, 1]
    cx = camera_matrix[0, 2]
    cy = camera_matrix[1, 2]
    angle_pixel = 2.0 * jnp.pi / sphere_width
    offset_phi = sphere_height / 2 - 0.5
    offset_theta = -size_h * 15 / 2 + 0.5  # reference include/Frame360.h:1105

    rows = jnp.arange(sphere_height, dtype=jnp.float32)[:, None]
    phi = (offset_phi - rows) * angle_pixel  # (Hs,1)
    sin_phi = jnp.sin(phi)
    cos_phi = jnp.cos(phi)

    def warp_one(sensor_rgb, sensor_depth, rt_inv, block_idx):
        # panorama columns covered by this block
        cols = block_idx * block_w + jnp.arange(block_w, dtype=jnp.float32)[None, :]
        theta = (cols + offset_theta) * angle_pixel
        vx = jnp.broadcast_to(sin_phi, (sphere_height, block_w))
        vy = cos_phi * jnp.sin(theta)
        vz = cos_phi * jnp.cos(theta)
        R = rt_inv[:3, :3]
        t = rt_inv[:3, 3]
        px = R[0, 0] * vx + R[0, 1] * vy + R[0, 2] * vz + t[0]
        py = R[1, 0] * vx + R[1, 1] * vy + R[1, 2] * vz + t[1]
        pz = R[2, 0] * vx + R[2, 1] * vy + R[2, 2] * vz + t[2]
        u = fx * px / pz + cx
        v = fy * py / pz + cy
        inb = (u >= 0) & (u < size_w) & (v >= 0) & (v < size_h)
        ui = jnp.clip(u.astype(jnp.int32), 0, size_w - 1)
        vi = jnp.clip(v.astype(jnp.int32), 0, size_h - 1)
        flat = vi * size_w + ui
        # one gather of 16-byte packed rows [b, g, r, depth] instead of
        # separate u8-row and u16 takes (their relative cost on the H100 is
        # not measured; tools/profile_frame.py)
        packed = jnp.concatenate(
            [
                sensor_rgb.reshape(-1, 3).astype(jnp.float32),
                sensor_depth.reshape(-1, 1).astype(jnp.float32),
            ],
            axis=1,
        )
        rows4 = jnp.take(packed, flat, axis=0, mode="clip")
        bgr = jnp.where(inb[..., None], rows4[..., :3], 0.0).astype(jnp.uint8)
        d = rows4[..., 3]
        obliq = jnp.sqrt(1.0 + ((u - cx) / fx) ** 2 + ((v - cy) / fy) ** 2)
        d = jnp.where(inb, d * obliq, 0.0)
        return bgr, d.astype(jnp.uint16)

    # block b holds sensor 7-b (reference include/Frame360.h:1119)
    sensor_of_block = jnp.arange(num_sensors)[::-1]
    blocks_rgb, blocks_d = jax.vmap(warp_one)(
        rgb[sensor_of_block],
        depth_mm[sensor_of_block],
        Rt_inv[sensor_of_block],
        jnp.arange(num_sensors),
    )
    # (8, Hs, 240, .) -> (Hs, 1920, .)
    sphere_rgb = jnp.concatenate(list(blocks_rgb), axis=1)
    sphere_depth = jnp.concatenate(list(blocks_d), axis=1)
    return sphere_rgb, sphere_depth


def fast_stitch(rgb: jnp.ndarray):
    """fastStitchImage360: concatenate rotated sensor images without the
    spherical warp (reference include/Frame360.h:348-383). Returns (Ws? ...)
    a (W, 8*H, 3) mosaic: each sensor image transposed then vertically
    flipped, sensors right-to-left."""
    # transpose + flip(0) == rotate 90deg counter-clockwise
    blocks = [jnp.flip(jnp.swapaxes(rgb[7 - s], 0, 1), axis=0) for s in range(rgb.shape[0])]
    return jnp.concatenate(blocks, axis=1)
