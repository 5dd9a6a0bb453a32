"""The north-star golden parity gate (BASELINE.md "first measurement task").

Gates the fused f32 JAX pipeline against the committed full-resolution f64
golden run (tests/golden/pair_1_10.npz, produced by tools/make_golden.py from
the vectorized reference transcription in golden_ref.py) on the bundled
sample pair at 1920x320, 5 pyramid levels:

  * per-level residuals / Hessian / gradient / SSO at the golden poses
    (pure functions of pose — immune to the stopping rule),
  * final pose < 1e-3 under a deterministic forced iteration schedule
    (the free-running stopping rule is chaotic at last-ulp level — the same
    pair stops anywhere in |t| 0.23-0.32 across backends, PERF.md),
  * the free-running pose lands in the golden basin,
  * golden_ref itself is validated against the deliberately-scalar ref_impl.

Reference: include/RegisterPhotoICP.h:4519-4784 on samples/*.bin.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import golden_ref
import ref_impl
from rgbd360_tpu.ops import linalg6, photoicp, se3
from rgbd360_tpu.ops.sphere import sphere_xyz_lut

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz")


# ---------------------------------------------------------------------------
# golden_ref (vectorized f64) vs ref_impl (scalar) — semantic fidelity
# ---------------------------------------------------------------------------


def _crop_level(rng, h=20, w=120):
    yy, xx = np.mgrid[0:h, 0:w]
    gray = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.05 * rng.normal(size=(h, w))
    depth = 2.5 + 0.8 * np.sin(xx / 11.0) + 0.4 * np.cos(yy / 6.0)
    depth[rng.random((h, w)) < 0.05] = 0.0
    gx, gy = ref_impl.gradient_xy(gray)
    dgx, dgy = ref_impl.gradient_xy(depth)
    return dict(
        gray_src=gray, depth_src=depth, gray_trg=gray, depth_trg=depth,
        gray_trg_gx=gx, gray_trg_gy=gy, depth_trg_gx=dgx, depth_trg_gy=dgy,
    )


@pytest.mark.parametrize("method", [0, 1, 2])
def test_golden_sweep_matches_scalar_ref(rng, method):
    level = _crop_level(rng)
    xyz_s, val_s = ref_impl.build_sphere_lut(level["depth_src"])
    xyz_v, val_v = golden_ref.build_sphere_lut(level["depth_src"])
    np.testing.assert_array_equal(val_v, val_s)
    np.testing.assert_allclose(xyz_v, xyz_s, atol=1e-12)

    pose = golden_ref.pseudo_exp(np.array([0.03, -0.02, 0.05, 0.01, -0.02, 0.015]))
    e_s = ref_impl.error_sphere(level, xyz_s, val_s, pose, method)
    H_s, g_s, sso_s = ref_impl.hess_grad_sphere(level, xyz_s, val_s, pose, method)
    e_v, H_v, g_v, sso_v, *_ = golden_ref.sweep(level, xyz_v, val_v, pose, method)
    assert abs(e_v - e_s) < 1e-10
    np.testing.assert_allclose(H_v, H_s, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g_v, g_s, rtol=1e-9, atol=1e-9)
    assert abs(sso_v - sso_s) < 1e-12


def test_golden_pyramids_match_scalar_ref(rng):
    depth = 2.5 + 0.8 * rng.random((20, 120))
    depth[rng.random((20, 120)) < 0.1] = 0.0
    np.testing.assert_allclose(
        golden_ref.depth_down_valid(depth), ref_impl.depth_pyramid_down(depth), atol=1e-12
    )
    gray = rng.random((20, 120))
    gx_v, gy_v = golden_ref.gradient_xy(gray)
    gx_s, gy_s = ref_impl.gradient_xy(gray)
    np.testing.assert_allclose(gx_v, gx_s, atol=1e-12)
    np.testing.assert_allclose(gy_v, gy_s, atol=1e-12)


# ---------------------------------------------------------------------------
# the full-resolution gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden npz not generated (tools/make_golden.py)")
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def pyramids(golden):
    gray_src = jnp.asarray(golden["gray_src_u8"].astype(np.float32) / 255.0)
    gray_trg = jnp.asarray(golden["gray_trg_u8"].astype(np.float32) / 255.0)
    depth_src = jnp.asarray(golden["depth_src_mm"].astype(np.float32) * 0.001)
    depth_trg = jnp.asarray(golden["depth_trg_mm"].astype(np.float32) * 0.001)
    n = int(golden["n_levels"])
    src = photoicp.build_pyramid_set(gray_src, depth_src, n, is_target=False, sphere_seam_mask=True)
    trg = photoicp.build_pyramid_set(gray_trg, depth_trg, n, is_target=True, sphere_seam_mask=True)
    return src, trg, (gray_src, depth_src, gray_trg, depth_trg)


def _sweep_at(src, trg, level_idx, pose):
    level = photoicp.make_level_data(src, trg, level_idx)
    xyz, valid = sphere_xyz_lut(level.depth_src, 0.3, 6.0)
    packed = photoicp.pack_target_channels(level)
    return photoicp.fused_sweep_sphere(
        level.gray_src.reshape(-1), packed, level.gray_src.shape, xyz, valid,
        jnp.asarray(pose, jnp.float32), photoicp.PHOTO_DEPTH,
    )


def test_per_level_residuals_vs_golden(golden, pyramids):
    """Initial residual/H/g/SSO at the golden incoming pose of every level.

    Pure functions of pose: any semantic drift of the fused pipeline
    (gather, masks, Huber, Jacobians, reductions) trips this regardless of
    the stopping rule. Tolerances hold headroom over the measured f32 drift
    (err 6e-5, H 5e-5, g 1e-3 max-normalized; counts differ by <=8 of 145k
    from the f16-packed gradient saliency test)."""
    n = int(golden["n_levels"])
    src, trg, _ = pyramids
    for k, lv in enumerate(range(n - 1, -1, -1)):
        err, H, g, sso, _pe2, n_photo, _de2, n_depth = _sweep_at(
            src, trg, lv, golden["free_level_pose_in"][k]
        )
        err_g = golden["free_level_err_in"][k]
        assert abs(float(err) - err_g) / err_g < 5e-4, f"level {lv} error drift"
        H_g = golden["free_level_H_in"][k]
        g_g = golden["free_level_g_in"][k]
        np.testing.assert_allclose(
            np.asarray(H) / np.abs(H_g).max(), H_g / np.abs(H_g).max(), atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(g) / np.abs(g_g).max(), g_g / np.abs(g_g).max(), atol=5e-3
        )
        assert abs(float(sso) - golden["free_level_sso_in"][k]) < 1e-3
        assert abs(int(n_photo) - int(golden["free_level_n_photo_in"][k])) <= 50
        assert abs(int(n_depth) - int(golden["free_level_n_depth_in"][k])) <= 50


def test_forced_schedule_pose_below_1e3(golden, pyramids):
    """The <1e-3 pose gate vs the f64 reference transcription, on the
    deterministic schedule (forced_iters GN steps per level, uncondition-
    ally accepted) that removes the chaotic accept/reject sensitivity."""
    n = int(golden["n_levels"])
    k = int(golden["forced_iters"])
    src, trg, _ = pyramids
    # compose poses on the HOST in float64: the gate measures the SWEEP
    # path, so the harness's own pose chain must add no backend rounding.
    pose = np.eye(4)
    for lv in range(n - 1, -1, -1):
        for _ in range(k):
            _err, H, g, *_ = _sweep_at(src, trg, lv, jnp.asarray(pose, jnp.float32))
            x, ok = linalg6.solve6_sym(H, g)
            assert bool(ok)
            pose = golden_ref.pseudo_exp(-np.asarray(x, np.float64)) @ pose
    diff = np.abs(pose - golden["forced_pose"]).max()
    assert diff < 1e-3, f"forced-schedule pose drift {diff:.2e}"


def _free_run(golden, pyramids):
    _src, _trg, (gray_src, depth_src, gray_trg, depth_trg) = pyramids
    return photoicp.align_spheres_jit(
        gray_src, depth_src, gray_trg, depth_trg, jnp.eye(4),
        method=photoicp.PHOTO_DEPTH, n_levels=int(golden["n_levels"]),
    )


def test_free_run_lands_in_golden_basin(golden, pyramids):
    """The free-running aligner (reference stopping policy) must land in the
    golden basin: the stopping point itself is numerics-sensitive (PERF.md),
    so this gates the basin, not the exact pose."""
    res = _free_run(golden, pyramids)
    assert not bool(res.ill_posed)
    pose = np.asarray(res.pose)
    t_gold = np.linalg.norm(golden["free_pose"][:3, 3])
    t_jax = np.linalg.norm(pose[:3, 3])
    assert abs(t_jax - t_gold) < 0.06, f"|t| {t_jax:.3f} vs golden {t_gold:.3f}"
    assert se3.rot_angle_deg(jnp.asarray(pose[:3, :3]), jnp.asarray(golden["free_pose"][:3, :3].astype(np.float32))) < 2.0
    assert abs(float(res.error) - float(golden["free_error"])) < 0.15


@pytest.mark.gpu
def test_free_run_passes_bench_rails_on_gpu(gpu, golden, pyramids):
    """On the card the free run may stop in another legitimate basin than
    the CPU golden (the documented stopping-rule spread, PERF.md "Accuracy
    note"): gate it with the bench's own sanity rails (basin vector,
    two-sided error band, CPU-cross-checked iteration signature)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    res = _free_run(golden, pyramids)
    assert res.pose.devices() == {gpu}
    ok, reasons = bench.sanity_check(
        np.asarray(res.pose), float(res.error), bool(np.asarray(res.ill_posed)),
        np.asarray(res.num_iterations), golden=golden,
    )
    assert ok, reasons


def test_cpu_wall_clock_datum_recorded(golden):
    """BASELINE.md's CPU datum: the f64 reference-transcription wall clock."""
    assert float(golden["cpu_seconds"]) > 0
