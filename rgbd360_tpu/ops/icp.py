"""Point-to-plane ICP on spherical panoramas — the native stand-in for the
PCL GICP calls of the reference (Registration/RegisterPairRGBD360.cpp:112-142
and RegisterPhotoICP::alignPyramidICP, include/RegisterPhotoICP.h:4799-4860:
max correspondence 0.3 m, 10 iterations, transformation epsilon 1e-6).

Instead of a KD-tree (a data-dependent tree walk per point), correspondences use the panorama's
projective structure: a source point transformed by the current pose is
matched to the target point stored at its projected pixel — the same
projective data association the dense aligner uses, so the whole ICP is the
depth-only corner of the fused machinery with point-to-plane residuals from
the target's organized normals.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd360_tpu.ops import linalg6, se3
from rgbd360_tpu.ops.sphere import sphere_project, sphere_xyz_lut

MAX_CORRESPONDENCE = 0.3
MAX_ITERS = 10
TRANSFORM_EPS = 1e-6


class ICPResult(NamedTuple):
    pose: jnp.ndarray
    fitness: jnp.ndarray  # mean squared point-to-plane distance of inliers
    num_inliers: jnp.ndarray
    num_iterations: jnp.ndarray


def _target_normals_sphere(xyz_t: jnp.ndarray, valid_t: jnp.ndarray, h: int, w: int):
    """Cheap organized normals of the target panorama cloud via central
    differences + cross product. Valid-aware: a normal is produced only
    where all four neighbours are valid depth (invalid points are zeroed by
    sphere_xyz_lut, so a difference against one points along the viewing
    ray and the cross product is garbage), and rows do NOT wrap vertically
    (the panorama's top/bottom rows are not adjacent; theta columns do
    wrap). Returns (normals (N,3), normal_ok (N,) bool)."""
    p = xyz_t.reshape(h, w, 3)
    v = valid_t.reshape(h, w)
    dx = jnp.roll(p, -1, axis=1) - jnp.roll(p, 1, axis=1)  # theta wraps
    vx = jnp.roll(v, -1, axis=1) & jnp.roll(v, 1, axis=1)
    up = jnp.concatenate([p[:1], p[:-1]], axis=0)  # clamped, no wrap
    dn = jnp.concatenate([p[1:], p[-1:]], axis=0)
    dy = dn - up
    v_up = jnp.concatenate([v[:1], v[:-1]], axis=0)
    v_dn = jnp.concatenate([v[1:], v[-1:]], axis=0)
    vy = v_up & v_dn
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = (v & vx & vy & (norm[..., 0] > 1e-12)).reshape(-1)
    n = n / jnp.maximum(norm, 1e-12)
    flip = jnp.sum(n * p, axis=-1, keepdims=True) > 0
    return jnp.where(flip, -n, n).reshape(-1, 3), ok


@functools.partial(jax.jit, static_argnames=("max_iters",))
def icp_point_to_plane_sphere(
    depth_src_m: jnp.ndarray,  # (H, W) f32
    depth_trg_m: jnp.ndarray,
    pose_guess: jnp.ndarray,
    max_iters: int = MAX_ITERS,
) -> ICPResult:
    h, w = depth_src_m.shape
    xyz_s, valid_s = sphere_xyz_lut(depth_src_m, 0.3, 10.0)
    xyz_t, valid_t = sphere_xyz_lut(depth_trg_m, 0.3, 10.0)
    normals_t, normal_ok_t = _target_normals_sphere(xyz_t, valid_t, h, w)

    def step(pose):
        R, t = pose[:3, :3], pose[:3, 3]
        p = xyz_s @ R.T + t
        dist, r_i, c_i, inb = sphere_project(p, h, w)
        flat = jnp.clip(r_i, 0, h - 1) * w + jnp.clip(c_i, 0, w - 1)
        q = jnp.take(xyz_t, flat, axis=0)
        n = jnp.take(normals_t, flat, axis=0)
        tv = jnp.take(valid_t, flat) & jnp.take(normal_ok_t, flat)
        diff = p - q
        d2 = jnp.sum(diff * diff, axis=-1)
        ok = valid_s & inb & tv & (d2 < MAX_CORRESPONDENCE**2)
        r = jnp.sum(diff * n, axis=-1)  # point-to-plane residual
        # J = [n^T | (p x n)^T]
        jac = jnp.concatenate([n, jnp.cross(p, n)], axis=-1)
        jac = jnp.where(ok[:, None], jac, 0.0)
        r_m = jnp.where(ok, r, 0.0)
        H = jac.T @ jac
        g = jac.T @ r_m
        n_ok = jnp.sum(ok)
        fitness = jnp.sum(r_m * r_m) / jnp.maximum(n_ok, 1)
        return H, g, fitness, n_ok

    def cond(carry):
        pose, it, upd, fit, n_ok = carry
        return (it < max_iters) & (upd > TRANSFORM_EPS)

    def body(carry):
        pose, it, upd, fit, n_ok = carry
        H, g, fitness, n_ok = step(pose)
        x, ok = linalg6.solve6_sym(H + 1e-6 * jnp.eye(6), g)
        update = jnp.where(ok, -x, 0.0)
        pose = se3.exp_se3(update, pseudo=False) @ pose
        return pose, it + 1, jnp.linalg.norm(update), fitness, n_ok

    carry = (pose_guess, jnp.int32(0), jnp.float32(1.0), jnp.float32(0.0), jnp.int32(0))
    pose, it, _, _, _ = jax.lax.while_loop(cond, body, carry)
    # evaluate fitness/inliers AT the returned pose (the loop's carry holds
    # the stats of the pose before the final update)
    _, _, fit, n_ok = step(pose)
    return ICPResult(pose=pose, fitness=fit, num_inliers=n_ok, num_iterations=it)
