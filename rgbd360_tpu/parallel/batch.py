"""Batched pair registration — the unit of scale-out.

The reference registers one pair at a time on a CPU (SURVEY.md §2.3: its only
parallelism is an 8-thread OpenMP fan-out). Here the device is filled by
batching independent pair registrations along a leading axis with vmap; the
same function shards across devices in parallel/mesh.py.
"""

from __future__ import annotations

import functools

import jax

from rgbd360_tpu.ops import photoicp


def _align_single(gray_src, depth_src, gray_trg, depth_trg, pose_guess, method, n_levels):
    src = photoicp.build_pyramid_set(gray_src, depth_src, n_levels, is_target=False, sphere_seam_mask=True)
    trg = photoicp.build_pyramid_set(gray_trg, depth_trg, n_levels, is_target=True, sphere_seam_mask=True)
    return photoicp.align_frames360(src, trg, pose_guess, method)


@functools.partial(jax.jit, static_argnames=("method", "n_levels"))
def align_batch(
    gray_src,  # (B, H, W) f32
    depth_src,  # (B, H, W) f32 metres
    gray_trg,
    depth_trg,
    pose_guess,  # (B, 4, 4)
    method: int = photoicp.PHOTO_DEPTH,
    n_levels: int = 5,
) -> photoicp.AlignResult:
    """Register B independent pairs in one fused program."""
    return jax.vmap(
        lambda gs, ds, gt, dt, p: _align_single(gs, ds, gt, dt, p, method, n_levels)
    )(gray_src, depth_src, gray_trg, depth_trg, pose_guess)
