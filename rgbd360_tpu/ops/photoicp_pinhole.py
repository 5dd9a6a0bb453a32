"""Pinhole dense photo+depth alignment: single-camera (alignFrames) and the
8-camera robot-frame variant behind RegisterDensePhotoICP.

Reference semantics (include/RegisterPhotoICP.h):
  * errorPhotoICP :560-775 / calcHessGrad :776-1100 — pinhole warp
    u = fx x'/z' + ox, v = fy y'/z' + oy, nearest pixel; photo residual
    gray2-gray1; depth residual depth2 - z' with Huber scale stdDevDepth*z'.
    SALIENCY: the error function has NO gates, but calcHessGrad gates the
    H/g terms (photo :997-1001, depth :1020-1024), and the depth-saliency
    `continue` in PHOTO_DEPTH also skips the photo accumulation — so an H/g
    pixel must pass BOTH tests (the error/stat pixel sets differ from the
    Hessian's by design);
  * alignFrames :4254-4512 — coarse-to-fine Gauss-Newton with one
    Levenberg-Marquardt retry on rejection (lambda 0.01, step 10), full SE(3)
    exponential update, tolerances 1e-4;
  * calcPhotoICPError_robot :4905-5082 / calcHessianGradient_robot
    :5083-5270 — the camera is mounted on a robot/rig with extrinsic camRt;
    the optimized twist lives on the robot pose: the camera-frame warp uses
    relPoseCam = camRt^-1 pose camRt and the Jacobian chain is
    R_cam^-1 [I | -skew(p_robot')].

Known reference defect replicated-by-intent, not by bit: the robot-frame
depth Jacobian jacobianRt_z is declared but never assigned at :5236-5238
(the block expression's result is discarded), i.e. the C++ uses uninitialized
memory; and the robot path's depth residual uses the *source* depth while
its Jacobian term corresponds to the *warped* z. This implementation uses
the internally consistent pair (residual depth2 - z', Jacobian
grad.Jwarp - J36_row_z), which is what the surrounding code plainly intends.

RegisterDensePhotoICP (include/RegisterRGBD360.h:344-516): all 8 sensors
accumulate one 6x6 system on the shared robot pose per LM iteration — here a
single fused sweep batched over the sensor axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.ops import linalg6, se3
from rgbd360_tpu.ops.image import round_half_away
from rgbd360_tpu.ops.photoicp import (
    CH_DEPTH,
    CH_DG,
    CH_GG,
    CH_GRAY,
    LevelData,
    _gather_rows,
    _huber_weight,
    _bits_f32,
    _unpack2_f16,
    build_pyramid_set,
    make_level_data,
    pack_target_channels,
    MIN_DEPTH,
    MAX_DEPTH,
    STD_DEV_PHOTO,
    STD_DEV_DEPTH,
    THRES_SALIENCY,
    PHOTO_CONSISTENCY,
    DEPTH_CONSISTENCY,
    PHOTO_DEPTH,
)


def pinhole_lut(depth: jnp.ndarray, k_full: jnp.ndarray, level: int):
    """Backprojection LUT for one pyramid level (reference :4272-4299)."""
    h, w = depth.shape
    s = 1.0 / (2**level)
    fx, fy = k_full[0, 0] * s, k_full[1, 1] * s
    ox, oy = k_full[0, 2] * s, k_full[1, 2] * s
    cc = jnp.arange(w, dtype=jnp.float32)[None, :]
    rr = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = depth
    valid = (z > MIN_DEPTH) & (z < MAX_DEPTH)
    x = (cc - ox) * z / fx
    y = (rr - oy) * z / fy
    xyz = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)
    return jnp.where(valid.reshape(-1)[:, None], xyz, 0.0), valid.reshape(-1)


def _k_level(k_full: jnp.ndarray, level: int):
    s = 1.0 / (2**level)
    return k_full[0, 0] * s, k_full[1, 1] * s, k_full[0, 2] * s, k_full[1, 2] * s


def fused_sweep_pinhole(
    gray_src_flat: jnp.ndarray,
    target_packed: jnp.ndarray,
    shape: Tuple[int, int],
    xyz: jnp.ndarray,
    valid: jnp.ndarray,
    pose: jnp.ndarray,  # robot pose (or camera pose when cam_rt is identity)
    k_full: jnp.ndarray,
    level: int,
    method: int,
    cam_rt: jnp.ndarray = None,  # (4,4) robot-from-camera (sensor pose in rig frame) or None
    occlusion: int = 0,
):
    """One fused pass: error + H + g at `pose`. Returns
    (err2_sum, n_terms, H, g, photo_err2, n_photo, depth_err2, n_depth).

    occlusion selects the reference's pinhole variants: 1 = z-buffered
    closest-wins (_Occ1, RegisterPhotoICP.h:1107-1546), 2 = additionally
    reject dynamic/occluded points whose depth residual exceeds
    thresDepthOutliers (_Occ2, :1547-2025). No reference APP ever calls the
    pinhole occlusion variants (the only live occlusion call in the whole
    tree is the SPHERE Occ1, MethodsRegisterRGBD360.cpp:457), so this path
    keeps the plain pinhole error semantics (ungated stats) over the
    z-buffered visible set rather than reproducing the dead _Occ1 error
    function's saliency-gated stats."""
    h, w = shape
    fx, fy, ox, oy = _k_level(k_full, level)

    if cam_rt is None:
        R, t = pose[:3, :3], pose[:3, 3]
        q = xyz @ R.T + t  # camera-frame warped points
        pr2 = q  # jacobian anchor point
        r_basis = jnp.eye(3, dtype=pose.dtype)
    else:
        # robot-frame: p_robot' = pose @ (cam_rt @ p_cam); q = cam_rt^-1 p_robot'
        r_cr = cam_rt[:3, :3]
        t_cr = cam_rt[:3, 3]
        p_robot = xyz @ r_cr.T + t_cr
        pr2 = p_robot @ pose[:3, :3].T + pose[:3, 3]
        q = (pr2 - t_cr) @ r_cr  # rows: R_cr^-1 (pr2 - t_cr), R_cr orthonormal
        r_basis = r_cr.T  # row-chain: j3 @ R_cr^-1 == j3 @ r_cr.T

    z = q[:, 2]
    z_inv = 1.0 / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    u = q[:, 0] * fx * z_inv + ox
    v = q[:, 1] * fy * z_inv + oy
    c_int = round_half_away(u).astype(jnp.int32)
    r_int = round_half_away(v).astype(jnp.int32)
    # Deviation, deliberate: the z > 1e-6 behind-camera guard has NO
    # reference counterpart — the reference projects negative-z points and
    # counts them when the mirrored projection lands in-bounds (:703-715; the
    # scalar/C++ oracles are faithful to that). Mirror-image "matches" are
    # physically meaningless and arise only from badly diverged poses, so the
    # visible set excludes them here; the oracle parity tests use poses that
    # keep every valid point in front of the camera, where the sets agree.
    inb = (r_int >= 0) & (r_int < h) & (c_int >= 0) & (c_int < w) & (z > 1e-6)
    visible = valid & inb
    flat = jnp.clip(r_int, 0, h - 1) * w + jnp.clip(c_int, 0, w - 1)

    tgt = _gather_rows(target_packed, flat)
    gray2 = _bits_f32(tgt[:, CH_GRAY])
    depth2 = _bits_f32(tgt[:, CH_DEPTH])
    ggx, ggy = _unpack2_f16(tgt[:, CH_GG])
    dgx, dgy = _unpack2_f16(tgt[:, CH_DG])

    if occlusion:
        if occlusion >= 2:
            # dynamic-occlusion rejection (_Occ2's mask_dynamic_occlusion):
            # the PINHOLE alignFrames sets thresDepthOutliers =
            # maxDepthOutliers = 1.0 (reference :215, :4258-4259) — the
            # spherical path's 0.3 (:4525) does not apply here. The filter
            # precedes the z-buffer write (:1688-1697) so outliers never
            # displace clean points. Deviation, replicated-by-intent: the
            # reference's _Occ2 residual there is depth2 - inv_z (:1691 —
            # subtracting the INVERSE warped depth, plainly a defect); this
            # uses the intended depth2 - z.
            dynamic = visible & (jnp.abs(depth2 - z) > PINHOLE_THRES_DEPTH_OUTLIERS) & (depth2 > 0)
            visible = visible & ~dynamic
        # z-buffer: only the closest source point per target pixel survives
        # (the reference's sequential invDepthBuffer, :1191-1209, becomes a
        # scatter-max; ties all survive)
        z_inv_pos = jnp.where(visible, 1.0 / jnp.maximum(z, 1e-12), 0.0)
        zbuf = jnp.zeros(h * w, jnp.float32).at[flat].max(z_inv_pos)
        visible = visible & (z_inv_pos >= jnp.take(zbuf, flat))

    # pinhole projection jacobian rows (d u/d q, d v/d q), reference :5167-5177
    j_u = jnp.stack([fx * z_inv, jnp.zeros_like(z), -fx * q[:, 0] * z_inv * z_inv], -1)
    j_v = jnp.stack([jnp.zeros_like(z), fy * z_inv, -fy * q[:, 1] * z_inv * z_inv], -1)

    def chain(j3):
        """(N,3) camera-frame row-gradient -> (N,6) twist jacobian:
        j3 @ R_cr^-1 @ [I | -skew(pr2)]  (reference :5160-5165)."""
        j3r = j3 @ r_basis
        jw = jnp.stack(
            [
                pr2[:, 1] * j3r[:, 2] - pr2[:, 2] * j3r[:, 1],
                pr2[:, 2] * j3r[:, 0] - pr2[:, 0] * j3r[:, 2],
                pr2[:, 0] * j3r[:, 1] - pr2[:, 1] * j3r[:, 0],
            ],
            axis=-1,
        )
        return jnp.concatenate([j3r, jw], axis=-1)

    H = jnp.zeros((6, 6), jnp.float32)
    g = jnp.zeros((6,), jnp.float32)
    err2 = jnp.float32(0.0)
    n_terms = jnp.int32(0)
    photo_err2 = jnp.float32(0.0)
    n_photo = jnp.int32(0)
    depth_err2 = jnp.float32(0.0)
    n_depth = jnp.int32(0)

    # Saliency gating applies to the single-camera H/g ONLY (calcHessGrad
    # :997-1001 photo, :1020-1024 depth, with the coupling that the depth
    # continue also skips the photo accumulation in PHOTO_DEPTH); the error
    # terms are UNGATED (errorPhotoICP :560-775 has no saliency tests), and
    # the robot-frame variants (:4905-5270) gate nothing.
    gate = cam_rt is None
    if gate:
        photo_sal = (jnp.abs(ggx) >= THRES_SALIENCY) | (jnp.abs(ggy) >= THRES_SALIENCY)
        depth_sal = (jnp.abs(dgx) >= THRES_SALIENCY) | (jnp.abs(dgy) >= THRES_SALIENCY)
        if method == PHOTO_DEPTH:
            hg_ok = visible & photo_sal & depth_sal
        elif method == PHOTO_CONSISTENCY:
            hg_ok = visible & photo_sal
        else:
            hg_ok = visible & depth_sal
    else:
        hg_ok = visible

    if method in (PHOTO_CONSISTENCY, PHOTO_DEPTH):
        diff = gray2 - gray_src_flat
        wgt = _huber_weight(diff, STD_DEV_PHOTO) * (1.0 / STD_DEV_PHOTO)
        res = jnp.where(visible, wgt * diff, 0.0)
        jac = wgt[:, None] * (ggx[:, None] * chain(j_u) + ggy[:, None] * chain(j_v))
        jac = jnp.where(hg_ok[:, None], jac, 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ jnp.where(hg_ok, res, 0.0)
        photo_err2 = jnp.sum(res * res)
        n_photo = jnp.sum(visible.astype(jnp.int32))
        err2 += photo_err2
        n_terms += n_photo
    if method in (DEPTH_CONSISTENCY, PHOTO_DEPTH):
        depth_ok = visible & jnp.isfinite(depth2) & (depth2 > 0)
        ddiff = depth2 - z
        reg = STD_DEV_DEPTH * jnp.maximum(z, 1e-20)
        wgt = _huber_weight(ddiff, reg) / reg
        res = jnp.where(depth_ok, wgt * ddiff, 0.0)
        # d z / d twist = chain of e_z
        j_z = chain(jnp.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32), (q.shape[0], 3)))
        jac = wgt[:, None] * (
            dgx[:, None] * chain(j_u) + dgy[:, None] * chain(j_v) - j_z
        )
        hg_depth = depth_ok & hg_ok
        jac = jnp.where(hg_depth[:, None], jac, 0.0)
        H = H + jac.T @ jac
        g = g + jac.T @ jnp.where(hg_depth, res, 0.0)
        depth_err2 = jnp.sum(res * res)
        n_depth = jnp.sum(depth_ok.astype(jnp.int32))
        err2 += depth_err2
        n_terms += n_depth

    return err2, n_terms, H, g, photo_err2, n_photo, depth_err2, n_depth


PINHOLE_THRES_DEPTH_OUTLIERS = 1.0  # reference RegisterPhotoICP.h:215, :4258-4259


class PinholeAlignResult(NamedTuple):
    pose: jnp.ndarray
    hessian: jnp.ndarray
    gradient: jnp.ndarray
    error: jnp.ndarray
    av_photo_residual: jnp.ndarray
    av_depth_residual: jnp.ndarray
    num_iterations: jnp.ndarray
    ill_posed: jnp.ndarray


def _align_level_pinhole(level, k_full, lvl_idx, pose0, method, *, max_iters, tol_update, tol_residual, lm_lambda0, lm_step, num_cams, cam_rts, occlusion=0):
    """Shared GN+LM level loop for the single-camera and multi-camera cases.
    level: LevelData pytree whose leaves have a leading camera axis."""
    shape = level.gray_src.shape[-2:]

    # stacked per-camera inputs; cameras run under one vmap so the HLO stays
    # small (a python loop inlines num_cams copies of the sweep per GN
    # iteration and crashes the XLA compiler for the 8-camera case)
    def prep(ld):
        xyz, valid = pinhole_lut(ld.depth_src, k_full, lvl_idx)
        return ld.gray_src.reshape(-1), pack_target_channels(ld), xyz, valid

    grays_s, packs_s, xyzs_s, valids_s = jax.vmap(prep)(level)
    rts = (
        jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (num_cams, 4, 4))
        if cam_rts is None
        else cam_rts
    )

    def sweep(pose):
        def one(gs, pk, xyz, valid, cam_rt):
            return fused_sweep_pinhole(
                gs, pk, shape, xyz, valid, pose, k_full, lvl_idx, method,
                None if cam_rts is None else cam_rt, occlusion,
            )

        outs = jax.vmap(one, in_axes=(0, 0, 0, 0, 0))(
            grays_s, packs_s, xyzs_s, valids_s, rts
        )
        return jax.tree.map(lambda x: x.sum(0), outs)

    state0 = sweep(pose0)

    def error_of(state):
        # single camera: ~avResidual scale (reference errorPhotoICP :759-762);
        # multi-camera: the raw sum of squares (calcPhotoICPError_robot)
        if num_cams == 1:
            return jnp.sqrt(state[0] / jnp.maximum(state[1], 1).astype(jnp.float32))
        return state[0]

    def cond(carry):
        pose, state, diff, upd, it, lam, ill = carry
        return (it < max_iters) & (upd > tol_update) & (diff > tol_residual) & ~ill

    # reference semantics: the main solve is plain Gauss-Newton for the
    # single-camera path (RegisterPhotoICP.h:4693 — no damping) and
    # lambda-damped for the multi-camera LM loop (RegisterRGBD360.h:423-501);
    # a rejected step gets ONE Levenberg-Marquardt retry at raised damping
    # before the level gives up (the retry previously sat after the loop's
    # exit condition and was unreachable)
    always_damped = num_cams > 1

    def body(carry):
        pose, state, diff, upd, it, lam, ill = carry
        H, g = state[2], state[3]
        ok = linalg6.spd_well_posed(H, lam)
        eye = jnp.eye(6, dtype=H.dtype)

        def try_step(damp):
            x, sok = linalg6.solve6_sym(H + damp * (eye * H) + (~ok) * eye, g)
            update = -x
            new_pose = se3.exp_se3(update, pseudo=False) @ pose
            new_state = sweep(new_pose)
            dstep = error_of(state) - error_of(new_state)
            return new_pose, new_state, dstep, update, sok

        damp_main = lam if always_damped else jnp.float32(0.0)
        first = try_step(damp_main)

        def retry(_):
            return try_step(jnp.maximum(lam, lm_lambda0) * lm_step)

        def keep(_):
            return first

        new_pose, new_state, dstep, update, sok = jax.lax.cond(
            ok & (first[2] <= 0), retry, keep, None
        )
        ok = ok & sok
        accept = ok & (dstep > 0)
        pose = jnp.where(accept, new_pose, pose)
        state = jax.tree.map(lambda nw, od: jnp.where(accept, nw, od), new_state, state)
        lam = jnp.where(accept, lam / lm_step, lam * lm_step)
        it = it + accept.astype(jnp.int32)
        return pose, state, jnp.where(ok, dstep, 0.0), jnp.where(ok, jnp.linalg.norm(update), 0.0), it, lam, ill | ~ok

    carry0 = (
        pose0, state0, error_of(state0) + 1.0, jnp.float32(jnp.sqrt(6.0)),
        jnp.int32(0), jnp.float32(lm_lambda0), jnp.bool_(False),
    )
    pose, state, _, _, it, _, ill = jax.lax.while_loop(cond, body, carry0)
    return pose, state, it, ill


def align_frames_pinhole(
    src_pyrs_stacked,
    trg_pyrs_stacked,
    k_full: jnp.ndarray,
    pose_guess: jnp.ndarray,
    method: int = PHOTO_DEPTH,
    cam_rts: jnp.ndarray = None,  # (C,4,4) or None for single camera
    n_levels: int = 4,
    max_iters: int = 10,
    occlusion: int = 0,
) -> PinholeAlignResult:
    """alignFrames (:4254, cam_rts None) or the RegisterDensePhotoICP level
    loop (RegisterRGBD360.h:383-506, cam_rts = 8 extrinsics). Pyramid leaves
    carry a leading camera axis of size 1 or 8."""
    num_cams = 1 if cam_rts is None else int(cam_rts.shape[0])
    pose = pose_guess
    iters = []
    ill_any = jnp.bool_(False)
    last = None
    for lvl in range(n_levels - 1, -1, -1):
        level = make_level_data(src_pyrs_stacked, trg_pyrs_stacked, lvl)
        pose_new, state, it, ill = _align_level_pinhole(
            level, k_full, lvl, pose, method,
            max_iters=max_iters, tol_update=1e-4 if cam_rts is None else 1e-6,
            tol_residual=1e-4 if cam_rts is None else 1e-1,
            lm_lambda0=0.01 if cam_rts is None else 0.001, lm_step=10.0,
            num_cams=num_cams, cam_rts=cam_rts, occlusion=occlusion,
        )
        pose = jnp.where(ill_any, pose, pose_new)
        ill_any = ill_any | ill
        iters.append(it)
        last = state
    err2, n, H, g, pe2, nph, de2, nd = last
    return PinholeAlignResult(
        pose=pose,
        hessian=H,
        gradient=g,
        error=jnp.sqrt(err2 / jnp.maximum(n, 1).astype(jnp.float32)),
        av_photo_residual=jnp.sqrt(pe2 / jnp.maximum(nph, 1).astype(jnp.float32)),
        av_depth_residual=jnp.sqrt(de2 / jnp.maximum(nd, 1).astype(jnp.float32)),
        num_iterations=jnp.stack(iters),
        ill_posed=ill_any,
    )


@functools.partial(jax.jit, static_argnames=("method", "n_levels"))
def register_dense_photoicp_jit(
    gray_src,  # (8, H, W) f32 — the 8 sensors of frame2 (source)
    depth_src,  # (8, H, W) f32 metres
    gray_trg,
    depth_trg,
    cam_rts,  # (8, 4, 4) f32 sensor extrinsics
    k_full,  # (3, 3)
    pose_guess,
    method: int = PHOTO_DEPTH,
    n_levels: int = 4,
) -> PinholeAlignResult:
    """RegisterDensePhotoICP: one robot pose optimized from all 8 cameras
    (reference RegisterRGBD360.h:344-516)."""
    def build(g, d, is_target):
        return build_pyramid_set(g, d, n_levels, is_target=is_target, sphere_seam_mask=False)

    src = jax.vmap(lambda g, d: build(g, d, False))(gray_src, depth_src)
    trg = jax.vmap(lambda g, d: build(g, d, True))(gray_trg, depth_trg)
    return align_frames_pinhole(
        src, trg, k_full, pose_guess, method, cam_rts=cam_rts, n_levels=n_levels
    )


@functools.partial(jax.jit, static_argnames=("method", "n_levels", "occlusion"))
def align_frames_jit(
    gray_src, depth_src, gray_trg, depth_trg, k_full, pose_guess,
    method: int = PHOTO_DEPTH, n_levels: int = 4, occlusion: int = 0,
) -> PinholeAlignResult:
    """Single-camera pinhole alignFrames."""
    src = jax.tree.map(
        lambda x: x[None],
        build_pyramid_set(gray_src, depth_src, n_levels, is_target=False, sphere_seam_mask=False),
    )
    trg = jax.tree.map(
        lambda x: x[None],
        build_pyramid_set(gray_trg, depth_trg, n_levels, is_target=True, sphere_seam_mask=False),
    )
    return align_frames_pinhole(src, trg, k_full, pose_guess, method, None, n_levels, occlusion=occlusion)
