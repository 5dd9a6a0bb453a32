"""The package's one matmul-precision policy (rgbd360_tpu/__init__.py).

On a GPU a float32 dot at default precision may run in TF32, whose ~3
decimal digits flip accept/reject decisions of the reference stopping rule.
The CPU tests check that every dot_general the hot programs trace carries
HIGHEST (so no site falls back to the backend default); the `gpu` test
checks on the card that an f32 product really is full precision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rgbd360_tpu  # noqa: F401  (installs the policy)
from rgbd360_tpu.ops import photoicp

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dot_precisions(closed):
    """Every dot_general's precision param in a jaxpr, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(closed.jaxpr)
    return found


def _sweep_program():
    h, w = 16, 64
    yy, xx = np.mgrid[0:h, 0:w]
    gray = jnp.asarray((0.5 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 3.0)).astype(np.float32))
    depth = jnp.asarray((2.0 + 0.4 * np.sin(xx / 9.0)).astype(np.float32))

    def run(gs, ds, gt, dt):
        src = photoicp.build_pyramid_set(gs, ds, 2, is_target=False, sphere_seam_mask=True)
        trg = photoicp.build_pyramid_set(gt, dt, 2, is_target=True, sphere_seam_mask=True)
        return photoicp.align_frames360(src, trg, jnp.eye(4), photoicp.PHOTO_DEPTH)

    return jax.make_jaxpr(run)(gray, depth, gray, depth)


def _frame_program():
    from rgbd360_tpu.core.plane_extraction import fused_frame_program

    f = functools.partial(
        fused_frame_program, ship_labels=False, bin_width=4, bin_height=3, bin_depth=2.0
    )
    sds = jax.ShapeDtypeStruct
    return jax.make_jaxpr(f)(
        sds((8, 240, 320, 3), jnp.uint8), sds((8, 240, 320), jnp.uint16),
        sds((8, 80, 80, 5), jnp.float32), sds((8, 80, 80, 5), jnp.float32),
        sds((8, 4, 4), jnp.float32), sds((3, 3), jnp.float32),
    )


def _batch_match_program():
    from rgbd360_tpu.core.batch_match import _compat_matrix, pack_pbmap
    from rgbd360_tpu.core.matcher import ODOMETRY_6DOF
    from rgbd360_tpu.core.pbmap import PbMap, Plane

    pb = PbMap()
    pb.planes = [
        Plane(id=k, normal=np.eye(3, dtype=np.float32)[k], center=np.eye(3)[k],
              d=-1.0, area_hull=2.0, elongation=1.5)
        for k in range(3)
    ]
    pack = {k: jnp.asarray(v) for k, v in pack_pbmap(pb).items() if k != "count"}
    cfg = (3.0, 2.5, 0.35, 0.5, 0.64)
    return jax.make_jaxpr(lambda r, t: _compat_matrix(r, t, cfg, ODOMETRY_6DOF))(pack, pack)


def _icp_program():
    from rgbd360_tpu.ops.icp import icp_point_to_plane_sphere

    depth = jnp.full((16, 64), 2.0, jnp.float32)
    return jax.make_jaxpr(
        lambda a, b: icp_point_to_plane_sphere(a, b, jnp.eye(4), max_iters=2)
    )(depth, depth)


def _se3_program():
    from rgbd360_tpu.ops import se3

    xi = jnp.asarray([0.1, 0.0, 0.2, 0.01, 0.02, 0.03], jnp.float32)
    return jax.make_jaxpr(
        lambda x: se3.compose(se3.exp_se3(x, pseudo=False), se3.inverse(se3.exp_se3(x)))
    )(xi)


PROGRAMS = {
    "sweep": _sweep_program,
    "frame_program": _frame_program,
    "batch_match": _batch_match_program,
    "icp": _icp_program,
    "se3": _se3_program,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_dot_is_full_precision(name):
    precisions = _dot_precisions(PROGRAMS[name]())
    assert precisions, f"{name}: no dot_general traced — the check is vacuous"
    bad = [p for p in precisions if p != HIGHEST]
    assert not bad, f"{name}: {len(bad)} of {len(precisions)} dots not at HIGHEST: {bad[:3]}"


def test_policy_is_set_by_the_package():
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.mark.gpu
def test_f32_matmul_is_full_precision_on_gpu(gpu):
    """TF32 keeps ~10 mantissa bits (relative error ~1e-3 on a long dot);
    full f32 stays near 1e-6."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 4096)).astype(np.float32)
    b = rng.standard_normal((4096, 256)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(jax.device_put(a, gpu), jax.device_put(b, gpu)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, f"relative error {rel:.2e}: the card ran a reduced-precision dot"
