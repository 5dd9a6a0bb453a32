"""Dense spherical photometric + depth-ICP alignment — the hot core.

Tensor reformulation of the reference Gauss-Newton aligner
(include/RegisterPhotoICP.h:2545-2739 errorPhotoICP_sphere,
:2745-3228 calcHessGrad_sphere, :4519-4784 alignFrames360):

  * the per-pixel scalar loops become one fused, masked tensor program per
    pyramid level: transform (N,3)x(3,3) matmul -> spherical projection ->
    nearest-pixel gather of 6 target images -> Huber residuals -> analytic
    2x6 warp Jacobian -> 6x6 Hessian/gradient as a [6,N]x[N,6] matmul;
  * the <=10-iteration Gauss-Newton loop per level is a lax.while_loop with
    the reference's accept/reject + tolerance semantics;
  * the 5-level coarse-to-fine pyramid is unrolled in one jit;
  * everything is batchable over pairs with vmap (parallel/batch.py) and
    shardable over devices with shard_map (parallel/mesh.py).

Parity notes (kept bit-faithful up to f32 reduction order):
  * theta wrap column W (atan2+pi == 2*pi) is *dropped*, not wrapped, like the
    reference (RegisterPhotoICP.h:2684);
  * in PHOTO_DEPTH mode a pixel whose *photo* saliency test fails contributes
    neither photo nor depth terms (the `continue` at :2690-2692 and :3038);
  * depth==0 target pixels are "finite" (stitched panoramas store invalid as
    0, not NaN) and are only rejected by the depth-gradient saliency test;
  * pose update uses the mrpt pseudo-exponential exp([v,w]) @ pose (:4697);
  * a rejected step exits the level loop (diff_error <= tol_residual).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from rgbd360_tpu.ops import linalg6, se3
from rgbd360_tpu.ops.image import (
    build_depth_pyramid,
    build_gray_pyramid,
    gradient_xy,
    mask_sensor_seams,
)
from rgbd360_tpu.ops.sphere import sphere_project, sphere_xyz_lut

PHOTO_CONSISTENCY = 0
DEPTH_CONSISTENCY = 1
PHOTO_DEPTH = 2

# Default optimization constants (reference RegisterPhotoICP.h:201-221, 4589-4595)
MIN_DEPTH = 0.3
MAX_DEPTH = 6.0
STD_DEV_PHOTO = 6.0 / 255.0
STD_DEV_DEPTH = 0.2
THRES_SALIENCY = 0.01
MAX_ITERS = 10
TOL_UPDATE = 1e-4
TOL_RESIDUAL = 1e-3


class LevelData(NamedTuple):
    """Per-pyramid-level image set for one source/target pair."""

    gray_src: jnp.ndarray  # (H, W) f32
    depth_src: jnp.ndarray  # (H, W) f32 metres
    gray_trg: jnp.ndarray
    depth_trg: jnp.ndarray
    gray_trg_gx: jnp.ndarray
    gray_trg_gy: jnp.ndarray
    depth_trg_gx: jnp.ndarray
    depth_trg_gy: jnp.ndarray


class AlignResult(NamedTuple):
    pose: jnp.ndarray  # (4, 4) optimal relative pose
    hessian: jnp.ndarray  # (6, 6) at the final accepted pose
    gradient: jnp.ndarray  # (6,)
    error: jnp.ndarray  # final sqrt(err2/n) at the finest level
    av_photo_residual: jnp.ndarray
    av_depth_residual: jnp.ndarray
    sso: jnp.ndarray  # sensed-space overlap (visible/total pixels)
    num_iterations: jnp.ndarray  # (n_levels,) i32, coarse->fine
    ill_posed: jnp.ndarray  # bool


def build_pyramid_set(
    gray: jnp.ndarray,
    depth_m: jnp.ndarray,
    n_levels: int,
    *,
    is_target: bool,
    sphere_seam_mask: bool,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
) -> Tuple[Sequence[jnp.ndarray], ...]:
    """Gray + depth pyramids, plus target gradient pyramids
    (reference setSourceFrame/setTargetFrame, RegisterPhotoICP.h:480-516)."""
    gray_pyr = build_gray_pyramid(gray, n_levels)
    depth_pyr = build_depth_pyramid(depth_m, n_levels, min_depth, max_depth)
    if not is_target:
        return gray_pyr, depth_pyr
    ggx, ggy, dgx, dgy = [], [], [], []
    for level in range(n_levels):
        gx, gy = gradient_xy(gray_pyr[level])
        dx, dy = gradient_xy(depth_pyr[level])
        if sphere_seam_mask:
            gx, gy = mask_sensor_seams(gx), mask_sensor_seams(gy)
            dx, dy = mask_sensor_seams(dx), mask_sensor_seams(dy)
        ggx.append(gx)
        ggy.append(gy)
        dgx.append(dx)
        dgy.append(dy)
    return gray_pyr, depth_pyr, ggx, ggy, dgx, dgy


def make_level_data(src_pyrs, trg_pyrs, level: int) -> LevelData:
    gray_src_pyr, depth_src_pyr = src_pyrs
    gray_trg_pyr, depth_trg_pyr, ggx, ggy, dgx, dgy = trg_pyrs
    return LevelData(
        gray_src=gray_src_pyr[level],
        depth_src=depth_src_pyr[level],
        gray_trg=gray_trg_pyr[level],
        depth_trg=depth_trg_pyr[level],
        gray_trg_gx=ggx[level],
        gray_trg_gy=ggy[level],
        depth_trg_gx=dgx[level],
        depth_trg_gy=dgy[level],
    )


def _gather(img: jnp.ndarray, flat_idx: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(img.reshape(-1), flat_idx, mode="clip")


# Packed-channel layout for the single fused gather per sweep: the six
# target channels ride in 4 lanes (16 bytes per index) — the
# residual-critical gray/depth values in full f32, the gradient pairs as
# packed f16 (they only scale Jacobian rows and feed threshold tests; f16's
# 0.05% relative error keeps the accept/reject cascade on the f32 path).
# Whether 16-byte rows beat a plain f32 six-channel gather is not measured
# on the H100.
CH_GRAY, CH_DEPTH, CH_GG, CH_DG = range(4)
NUM_CH = 4


def _pack2_f16(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pack two f32 arrays as an f16 pair in an **i32** slot (low = a).
    i32, never f32: a pair whose high half is zero IS an f32 denormal, and a
    backend that flushes f32 denormals in data movement (stack/concatenate/
    gather) would zero it on the way through."""
    ab = jnp.stack([a.astype(jnp.float16), b.astype(jnp.float16)], axis=-1)
    return jax.lax.bitcast_convert_type(ab, jnp.int32)


def _unpack2_f16(x: jnp.ndarray):
    """Inverse of _pack2_f16; accepts any 32-bit slot dtype (i32 or f32)."""
    ab = jax.lax.bitcast_convert_type(x, jnp.float16)
    return ab[..., 0].astype(jnp.float32), ab[..., 1].astype(jnp.float32)


def _f32_bits(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _bits_f32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def pack_target_channels(level: LevelData) -> jnp.ndarray:
    """(H*W, 4) **i32** rows: gray/depth as raw f32 bit patterns, gradient
    pairs as packed f16 — all per-pixel target data touched by a sweep.
    The rows stay i32 end-to-end so no f16 pair ever exists as an f32
    denormal (see _pack2_f16)."""
    h, w = level.gray_trg.shape
    return jnp.stack(
        [
            _f32_bits(level.gray_trg),
            _f32_bits(level.depth_trg),
            _pack2_f16(level.gray_trg_gx, level.gray_trg_gy),
            _pack2_f16(level.depth_trg_gx, level.depth_trg_gy),
        ],
        axis=-1,
    ).reshape(h * w, NUM_CH)


def _gather_rows(packed: jnp.ndarray, flat_idx: jnp.ndarray) -> jnp.ndarray:
    """The sweep's one gather: a plain take of the 16-byte packed rows,
    which XLA emits as ordinary loads on the GPU."""
    return jnp.take(packed, flat_idx, axis=0, mode="clip")


def _huber_weight(err: jnp.ndarray, reg: jnp.ndarray) -> jnp.ndarray:
    """weightHuber (reference RegisterPhotoICP.h:544-554)."""
    e = jnp.abs(err)
    big = e >= reg
    safe_e = jnp.maximum(e, 1e-20)
    w = jnp.sqrt(jnp.maximum(2.0 * reg * e - reg * reg, 0.0)) / safe_e
    return jnp.where(big, w, 1.0)


def _warp_terms(level: LevelData, xyz, valid, pose, method: int):
    """Shared warp + residual computation for the error and H/g passes.

    Returns a dict of per-pixel masked terms.
    """
    h, w = level.gray_src.shape
    R = pose[:3, :3]
    t = pose[:3, 3]
    p = xyz @ R.T + t  # (N,3)
    dist, r_int, c_int, inb = sphere_project(p, h, w)
    visible = valid & inb
    flat = jnp.clip(r_int, 0, h - 1) * w + jnp.clip(c_int, 0, w - 1)

    out = {"p": p, "dist": dist, "flat": flat, "visible": visible}

    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        gx = _gather(level.gray_trg_gx, flat)
        gy = _gather(level.gray_trg_gy, flat)
        salient_photo = (jnp.abs(gx) >= THRES_SALIENCY) | (jnp.abs(gy) >= THRES_SALIENCY)
        photo_ok = visible & salient_photo
        pixel1 = level.gray_src.reshape(-1)
        pixel2 = _gather(level.gray_trg, flat)
        diff = pixel2 - pixel1
        w_photo = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
        out.update(photo_ok=photo_ok, photo_wdiff=w_photo * diff, photo_w=w_photo, photo_g=(gx, gy))
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        depth2 = _gather(level.depth_trg, flat)
        dgx = _gather(level.depth_trg_gx, flat)
        dgy = _gather(level.depth_trg_gy, flat)
        salient_depth = (jnp.abs(dgx) >= THRES_SALIENCY) | (jnp.abs(dgy) >= THRES_SALIENCY)
        finite = jnp.isfinite(depth2)
        depth_ok = visible & finite & salient_depth
        if method == PHOTO_DEPTH:
            # the reference `continue` on failed photo saliency skips depth too
            depth_ok = depth_ok & out["photo_ok"] if "photo_ok" in out else depth_ok
        ddiff = depth2 - dist
        reg = STD_DEV_DEPTH * jnp.maximum(depth2, 1e-20)
        w_depth = _huber_weight(ddiff, reg) / reg
        out.update(depth_ok=depth_ok, depth_wdiff=w_depth * ddiff, depth_w=w_depth, depth_g=(dgx, dgy))
    return out


def error_sphere(level: LevelData, xyz, valid, pose, method: int):
    """errorPhotoICP_sphere (reference RegisterPhotoICP.h:2545-2739):
    sqrt(sum of squared weighted residuals / number of contributing terms)."""
    terms = _warp_terms(level, xyz, valid, pose, method)
    err2 = jnp.float32(0.0)
    n = jnp.int32(0)
    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        m = terms["photo_ok"]
        err2 += jnp.sum(jnp.where(m, terms["photo_wdiff"] ** 2, 0.0))
        n += jnp.sum(m.astype(jnp.int32))
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        m = terms["depth_ok"]
        err2 += jnp.sum(jnp.where(m, terms["depth_wdiff"] ** 2, 0.0))
        n += jnp.sum(m.astype(jnp.int32))
    return jnp.sqrt(err2 / jnp.maximum(n, 1).astype(jnp.float32))


def _warp_jacobian(p: jnp.ndarray, dist: jnp.ndarray, angle_res_inv: float):
    """2x6 Jacobian of the spherical warp wrt the left-multiplied twist
    (reference RegisterPhotoICP.h:2995-3026): rows are (d col/d xi, d row/d xi)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    dist_inv = 1.0 / jnp.maximum(dist, 1e-12)
    z_inv = 1.0 / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    z_inv2 = z_inv * z_inv
    d_atan = angle_res_inv / (1.0 + y * y * z_inv2)
    j_theta = jnp.stack(
        [jnp.zeros_like(x), d_atan * z_inv, -y * z_inv2 * d_atan], axis=-1
    )  # (N,3) d(col)/d(xyz)
    dist_inv2 = dist_inv * dist_inv
    x_dist_inv2 = x * dist_inv2
    d_asin = angle_res_inv / jnp.sqrt(jnp.maximum(1.0 - x * x_dist_inv2, 1e-12))
    j_phi = jnp.stack(
        [
            -d_asin * dist_inv * (1.0 - x * x_dist_inv2),
            d_asin * x_dist_inv2 * y * dist_inv,
            d_asin * x_dist_inv2 * z * dist_inv,
        ],
        axis=-1,
    )  # (N,3) d(row)/d(xyz)
    # chain with d(xyz)/d(xi) = [I | -skew(p)]  (jacobianT36, :2995-2997)
    def chain(j3):  # (N,3) -> (N,6)
        jw = jnp.stack(
            [
                p[:, 1] * j3[:, 2] - p[:, 2] * j3[:, 1],
                p[:, 2] * j3[:, 0] - p[:, 0] * j3[:, 2],
                p[:, 0] * j3[:, 1] - p[:, 1] * j3[:, 0],
            ],
            axis=-1,
        )  # row-vector j3 @ (-skew(p)) == p x j3
        return jnp.concatenate([j3, jw], axis=-1)

    return chain(j_theta), chain(j_phi), chain


def hess_grad_sphere(level: LevelData, xyz, valid, pose, method: int):
    """calcHessGrad_sphere (reference RegisterPhotoICP.h:2745-3228).

    Returns (H 6x6, g 6, sso, photo_err2_sum, n_photo, depth_err2_sum, n_depth).
    """
    h, w = level.gray_src.shape
    angle_res_inv = w / (2.0 * jnp.pi)
    terms = _warp_terms(level, xyz, valid, pose, method)
    p, dist = terms["p"], terms["dist"]
    j_col, j_row, chain = _warp_jacobian(p, dist, angle_res_inv)

    H = jnp.zeros((6, 6), jnp.float32)
    g = jnp.zeros((6,), jnp.float32)
    photo_err2 = jnp.float32(0.0)
    n_photo = jnp.int32(0)
    depth_err2 = jnp.float32(0.0)
    n_depth = jnp.int32(0)

    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        gx, gy = terms["photo_g"]
        m = terms["photo_ok"]
        jac = terms["photo_w"][:, None] * (gx[:, None] * j_col + gy[:, None] * j_row)
        jac = jnp.where(m[:, None], jac, 0.0)
        res = jnp.where(m, terms["photo_wdiff"], 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ res
        photo_err2 = jnp.sum(res * res)
        n_photo = jnp.sum(m.astype(jnp.int32))
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        dgx, dgy = terms["depth_g"]
        m = terms["depth_ok"]
        # d(dist)/d(xyz) = p/dist, chained through [I | -skew(p)]
        j_dist = chain(p / jnp.maximum(dist, 1e-12)[:, None])
        jac = terms["depth_w"][:, None] * (
            dgx[:, None] * j_col + dgy[:, None] * j_row - j_dist
        )
        jac = jnp.where(m[:, None], jac, 0.0)
        res = jnp.where(m, terms["depth_wdiff"], 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ res
        depth_err2 = jnp.sum(res * res)
        n_depth = jnp.sum(m.astype(jnp.int32))

    sso = jnp.sum(terms["visible"].astype(jnp.float32)) / jnp.float32(h * w)
    return H, g, sso, photo_err2, n_photo, depth_err2, n_depth


def fused_sweep_sphere(
    gray_src_flat: jnp.ndarray,  # (N,) f32
    target_packed: jnp.ndarray,  # (H*W, 4) i32 rows (pack_target_channels)
    shape: Tuple[int, int],
    xyz: jnp.ndarray,
    valid: jnp.ndarray,
    pose: jnp.ndarray,
    method: int,
    occlusion: int = 0,
):
    """One fused pass: error + Hessian + gradient + stats at `pose`.

    Computes exactly the same quantities as errorPhotoICP_sphere followed by
    calcHessGrad_sphere at the same pose (the reference evaluates both at every
    accepted pose; fusing halves the number of image sweeps), with a single
    packed gather of the six target channels.
    """
    h, w = shape
    angle_res_inv = w / (2.0 * jnp.pi)
    R = pose[:3, :3]
    t = pose[:3, 3]
    p = xyz @ R.T + t
    dist, r_int, c_int, inb = sphere_project(p, h, w)
    visible = valid & inb
    flat = jnp.clip(r_int, 0, h - 1) * w + jnp.clip(c_int, 0, w - 1)

    tgt = _gather_rows(target_packed, flat)  # (N, 4): the sweep's one gather
    gray2 = _bits_f32(tgt[:, CH_GRAY])
    depth2 = _bits_f32(tgt[:, CH_DEPTH])
    ggx, ggy = _unpack2_f16(tgt[:, CH_GG])
    dgx, dgy = _unpack2_f16(tgt[:, CH_DG])

    if occlusion:
        if occlusion >= 2:
            # dynamic-occlusion rejection (reference _sphereOcc2 :3789-3792,
            # thresDepthOutliers = 0.3 set by alignFrames360 :4525). The
            # filter runs BEFORE the z-buffer write in the reference, so a
            # moving/occluded outlier never occupies the buffer and cannot
            # displace a clean farther point landing on the same pixel.
            dynamic = visible & (jnp.abs(depth2 - dist) > THRES_DEPTH_OUTLIERS) & (depth2 > 0)
            visible = visible & ~dynamic
        # z-buffer: only the closest source point per target pixel survives
        # (reference _sphereOcc1 :3300-3304; scatter-max replaces the
        # sequential invDepthBuffer, ties all survive)
        dist_inv = jnp.where(visible, 1.0 / jnp.maximum(dist, 1e-12), 0.0)
        zbuf = jnp.zeros(h * w, jnp.float32).at[flat].max(dist_inv)
        visible = visible & (dist_inv >= jnp.take(zbuf, flat))

    j_col, j_row, chain = _warp_jacobian(p, dist, angle_res_inv)

    H = jnp.zeros((6, 6), jnp.float32)
    g = jnp.zeros((6,), jnp.float32)
    err2 = jnp.float32(0.0)
    n_terms = jnp.int32(0)
    photo_err2 = jnp.float32(0.0)
    n_photo = jnp.int32(0)
    depth_err2 = jnp.float32(0.0)
    n_depth = jnp.int32(0)
    photo_ok = None

    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        salient = (jnp.abs(ggx) >= THRES_SALIENCY) | (jnp.abs(ggy) >= THRES_SALIENCY)
        photo_ok = visible & salient
        diff = gray2 - gray_src_flat
        wgt = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
        res = jnp.where(photo_ok, wgt * diff, 0.0)
        jac = wgt[:, None] * (ggx[:, None] * j_col + ggy[:, None] * j_row)
        jac = jnp.where(photo_ok[:, None], jac, 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ res
        photo_err2 = jnp.sum(res * res)
        n_photo = jnp.sum(photo_ok.astype(jnp.int32))
        err2 += photo_err2
        n_terms += n_photo
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        salient = (jnp.abs(dgx) >= THRES_SALIENCY) | (jnp.abs(dgy) >= THRES_SALIENCY)
        depth_ok = visible & jnp.isfinite(depth2) & salient
        if method == PHOTO_DEPTH:
            depth_ok = depth_ok & photo_ok  # reference `continue` semantics
        ddiff = depth2 - dist
        reg = STD_DEV_DEPTH * jnp.maximum(depth2, 1e-20)
        wgt = _huber_weight(ddiff, reg) / reg
        res = jnp.where(depth_ok, wgt * ddiff, 0.0)
        j_dist = chain(p / jnp.maximum(dist, 1e-12)[:, None])
        jac = wgt[:, None] * (dgx[:, None] * j_col + dgy[:, None] * j_row - j_dist)
        jac = jnp.where(depth_ok[:, None], jac, 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ res
        depth_err2 = jnp.sum(res * res)
        n_depth = jnp.sum(depth_ok.astype(jnp.int32))
        err2 += depth_err2
        n_terms += n_depth

    error = jnp.sqrt(err2 / jnp.maximum(n_terms, 1).astype(jnp.float32))
    sso = jnp.sum(visible.astype(jnp.float32)) / jnp.float32(h * w)
    return error, H, g, sso, photo_err2, n_photo, depth_err2, n_depth


THRES_DEPTH_OUTLIERS = 0.3  # alignFrames360 sets this for Occ2 (:4525)


def occlusion_mask_sphere(
    xyz: jnp.ndarray,
    valid: jnp.ndarray,
    pose: jnp.ndarray,
    shape: Tuple[int, int],
    target_depth_flat: jnp.ndarray = None,
    occlusion: int = 1,
):
    """Visibility refinement for the occlusion-aware variants
    (reference errorPhotoICP_sphereOcc1 :3232-3370, _sphereOcc2 :3720-3860).

    Occ1: a z-buffer over target pixels — when several source points land on
    the same target pixel only the closest survives (the reference's
    sequential invDepthBuffer becomes a scatter-max; ties all survive, a
    benign deviation from its order-dependent overwrite).
    Occ2: first rejects dynamic/occluded points whose depth residual exceeds
    thresDepthOutliers (0.3 m) — BEFORE the z-buffer, as in the reference
    (:3789-3799), so an outlier never displaces a clean point — returning
    that mask separately (the reference's mask_dynamic_occlusion, :169).
    """
    h, w = shape
    R = pose[:3, :3]
    t = pose[:3, 3]
    p = xyz @ R.T + t
    dist, r_int, c_int, inb = sphere_project(p, h, w)
    visible = valid & inb
    flat = jnp.clip(r_int, 0, h - 1) * w + jnp.clip(c_int, 0, w - 1)
    dynamic = jnp.zeros_like(visible)
    if occlusion >= 2 and target_depth_flat is not None:
        depth2 = jnp.take(target_depth_flat, flat, mode="clip")
        dynamic = visible & (jnp.abs(depth2 - dist) > THRES_DEPTH_OUTLIERS) & (depth2 > 0)
        visible = visible & ~dynamic
    dist_inv = jnp.where(visible, 1.0 / jnp.maximum(dist, 1e-12), 0.0)
    zbuf = jnp.zeros(h * w, jnp.float32).at[flat].max(dist_inv)
    closest = visible & (dist_inv >= jnp.take(zbuf, flat))
    return closest, dynamic


def align_level_sphere(
    level: LevelData,
    pose0: jnp.ndarray,
    method: int,
    max_iters: int = MAX_ITERS,
    tol_update: float = TOL_UPDATE,
    tol_residual: float = TOL_RESIDUAL,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
    occlusion: int = 0,
):
    """One pyramid level of alignFrames360's Gauss-Newton loop
    (reference RegisterPhotoICP.h:4589-4772).

    The loop carries (pose, error, H, g, stats) all evaluated at the current
    accepted pose by a single fused sweep; each iteration takes one GN step
    and one fused sweep at the candidate pose. The evaluation sequence and
    accept/reject decisions are identical to the reference, which evaluates
    error and H/g in separate image passes.
    """
    xyz, valid = sphere_xyz_lut(level.depth_src, min_depth, max_depth)
    gray_src_flat = level.gray_src.reshape(-1)
    shape = level.gray_src.shape
    packed = pack_target_channels(level)

    def sweep(pose):
        return fused_sweep_sphere(
            gray_src_flat, packed, shape, xyz, valid, pose, method, occlusion
        )

    state0 = sweep(pose0)

    def cond(carry):
        _pose, _state, diff_error, upd_norm, it, ill = carry
        return (
            (it < max_iters)
            & (upd_norm > tol_update)
            & (diff_error > tol_residual)
            & jnp.logical_not(ill)
        )

    def body(carry):
        pose, state, diff_error, upd_norm, it, ill = carry
        error, H, g = state[0], state[1], state[2]
        ok = linalg6.spd_well_posed(H, jnp.float32(1.0))
        x, solve_ok = linalg6.solve6_sym(H + (~ok) * jnp.eye(6, dtype=H.dtype), g)
        ok = ok & solve_ok
        update = -x
        new_pose = se3.exp_se3(update, pseudo=True) @ pose
        new_state = sweep(new_pose)
        diff = error - new_state[0]
        accept = ok & (diff > tol_residual)
        pose = jnp.where(accept, new_pose, pose)
        state = jax.tree.map(lambda n, o: jnp.where(accept, n, o), new_state, state)
        it = it + accept.astype(jnp.int32)
        upd_norm = jnp.where(ok, jnp.linalg.norm(update), 0.0)
        return pose, state, jnp.where(ok, diff, 0.0), upd_norm, it, ill | ~ok

    carry0 = (
        pose0,
        state0,
        state0[0],  # diff_error initialized to the error (reference :4605)
        jnp.float32(jnp.sqrt(6.0)),  # |(1,1,1,1,1,1)|
        jnp.int32(0),
        jnp.bool_(False),
    )
    pose, state, _, _, it, ill = jax.lax.while_loop(cond, body, carry0)
    error, H, g, sso, pe2, np_, de2, nd = state
    av_photo = jnp.sqrt(pe2 / jnp.maximum(np_, 1).astype(jnp.float32))
    av_depth = jnp.sqrt(de2 / jnp.maximum(nd, 1).astype(jnp.float32))
    return pose, error, H, g, sso, av_photo, av_depth, it, ill


def align_frames360(
    src_pyrs,
    trg_pyrs,
    pose_guess: jnp.ndarray,
    method: int = PHOTO_DEPTH,
    *,
    max_iters: int = MAX_ITERS,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
    occlusion: int = 0,
) -> AlignResult:
    """Coarse-to-fine spherical alignment (reference RegisterPhotoICP.h:4519;
    occlusion 0/1/2 selects the plain, z-buffered, or dynamic-occlusion
    variants like the reference's `occlusion` parameter).

    src_pyrs/trg_pyrs come from build_pyramid_set(..., sphere_seam_mask=True).
    The python level loop unrolls inside one jit.
    """
    n_levels = len(src_pyrs[0])
    pose = pose_guess
    iters = []
    ill_any = jnp.bool_(False)
    last = None
    for level_idx in range(n_levels - 1, -1, -1):
        level = make_level_data(src_pyrs, trg_pyrs, level_idx)
        # the scope names each level's ops in profiler traces
        # (tools/trace_align.py attributes device time per level by it)
        with jax.named_scope(f"align_level{level_idx}"):
            pose_new, error, H, g, sso, av_p, av_d, it, ill = align_level_sphere(
                level, pose, method, max_iters=max_iters,
                min_depth=min_depth, max_depth=max_depth, occlusion=occlusion,
            )
        # An ill-posed system aborts the whole alignment, keeping the steps
        # accepted so far (reference :4682-4690); levels after an ill-posed
        # one leave the pose untouched.
        pose = jnp.where(ill_any, pose, pose_new)
        ill_any = ill_any | ill
        iters.append(it)
        last = (error, H, g, sso, av_p, av_d)
    error, H, g, sso, av_p, av_d = last
    return AlignResult(
        pose=pose,
        hessian=H,
        gradient=g,
        error=error,
        av_photo_residual=av_p,
        av_depth_residual=av_d,
        sso=sso,
        num_iterations=jnp.stack(iters),
        ill_posed=ill_any,
    )


# jitted entries for the OO facade (core/register_photoicp.py): the raw
# functions compose into other jits (align_spheres_jit, parallel/batch); run
# eagerly, every op of the GN loop would be its own dispatch
align_frames360_jit = functools.partial(
    jax.jit, static_argnames=("method", "max_iters", "occlusion")
)(align_frames360)


@functools.partial(jax.jit, static_argnames=("method", "max_iters", "occlusion"))
def align_frames360_packed(
    src_pyrs, trg_pyrs, pose_guess, method: int = PHOTO_DEPTH, *,
    max_iters: int = MAX_ITERS, occlusion: int = 0,
):
    """align_frames360 plus a single flat f32 vector of every host-consumed
    output: [pose 16, hessian 36, gradient 6, error, av_photo, av_depth,
    sso, ill_posed, num_iterations (n_levels)].

    Packing every host-consumed quantity inside the jit makes the whole
    result one device-to-host transfer instead of one per accessor. The
    structured AlignResult is still returned for device-side consumers."""
    res = align_frames360(
        src_pyrs, trg_pyrs, pose_guess, method, max_iters=max_iters,
        occlusion=occlusion,
    )
    flat = jnp.concatenate(
        [
            res.pose.reshape(-1).astype(jnp.float32),
            res.hessian.reshape(-1).astype(jnp.float32),
            res.gradient.reshape(-1).astype(jnp.float32),
            jnp.stack(
                [
                    res.error, res.av_photo_residual, res.av_depth_residual,
                    res.sso, res.ill_posed.astype(jnp.float32),
                ]
            ),
            res.num_iterations.astype(jnp.float32),
        ]
    )
    return res, flat


def build_pyramid_set_raw(
    rgb_bgr_u8: jnp.ndarray,
    depth: jnp.ndarray,
    n_levels: int,
    *,
    is_target: bool,
    sphere_seam_mask: bool,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
):
    """build_pyramid_set taking the RAW panorama (u8 BGR + u16-mm or f32-m
    depth) with the gray and metre conversions fused inside the jit, so a
    set_*_frame call is one dispatch instead of several eager ops."""
    from rgbd360_tpu.ops.image import gray_f32

    gray = gray_f32(rgb_bgr_u8)
    if depth.dtype == jnp.uint16:  # millimetres -> metres (buildPyramidRange)
        depth = depth.astype(jnp.float32) * 0.001
    return build_pyramid_set(
        gray,
        depth.astype(jnp.float32),
        n_levels,
        is_target=is_target,
        sphere_seam_mask=sphere_seam_mask,
        min_depth=min_depth,
        max_depth=max_depth,
    )


build_pyramid_set_raw_jit = functools.partial(
    jax.jit, static_argnames=("n_levels", "is_target", "sphere_seam_mask")
)(build_pyramid_set_raw)


@functools.partial(
    jax.jit,
    static_argnames=("method", "n_levels", "max_iters", "occlusion"),
)
def align_spheres_jit(
    gray_src,
    depth_src_m,
    gray_trg,
    depth_trg_m,
    pose_guess,
    method: int = PHOTO_DEPTH,
    n_levels: int = 5,
    max_iters: int = MAX_ITERS,
    occlusion: int = 0,
) -> AlignResult:
    """End-to-end jit: pyramids + gradients + coarse-to-fine alignment."""
    src_pyrs = build_pyramid_set(gray_src, depth_src_m, n_levels, is_target=False, sphere_seam_mask=True)
    trg_pyrs = build_pyramid_set(gray_trg, depth_trg_m, n_levels, is_target=True, sphere_seam_mask=True)
    return align_frames360(
        src_pyrs, trg_pyrs, pose_guess, method, max_iters=max_iters,
        occlusion=occlusion,
    )


def calc_entropy(hessian: jnp.ndarray) -> jnp.ndarray:
    """Differential entropy of the pose estimate (Kerl IROS13 formula,
    reference RegisterPhotoICP.h:4789-4797). log|cov| == -log|H|, so use
    the closed-form 6x6 Cholesky (ops/linalg6.py) instead of a generic
    inverse + slogdet."""
    dof = 6.0
    logdet_h, _ok = linalg6.logdet6_sym(hessian)
    return 0.5 * (dof * (1.0 + jnp.log(2.0 * jnp.pi)) - logdet_h)
