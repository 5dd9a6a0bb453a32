"""Parity + convergence tests for the dense spherical aligner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_impl
from rgbd360_tpu.ops import photoicp, se3
from rgbd360_tpu.ops.sphere import sphere_project, sphere_xyz_lut


def _small_level(rng, h=20, w=120):
    """A synthetic smooth panorama level (coarse pyramid scale)."""
    yy, xx = np.mgrid[0:h, 0:w]
    gray = 0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.05 * rng.normal(size=(h, w))
    gray = gray.astype(np.float32)
    depth = (2.5 + 0.8 * np.sin(xx / 11.0) + 0.4 * np.cos(yy / 6.0)).astype(np.float32)
    depth[rng.random((h, w)) < 0.05] = 0.0
    gx, gy = ref_impl.gradient_xy(gray.astype(np.float64))
    dgx, dgy = ref_impl.gradient_xy(depth.astype(np.float64))
    level_np = dict(
        gray_src=gray.astype(np.float64),
        depth_src=depth.astype(np.float64),
        gray_trg=gray.astype(np.float64),
        depth_trg=depth.astype(np.float64),
        gray_trg_gx=gx,
        gray_trg_gy=gy,
        depth_trg_gx=dgx,
        depth_trg_gy=dgy,
    )
    level_jx = photoicp.LevelData(
        gray_src=jnp.asarray(gray),
        depth_src=jnp.asarray(depth),
        gray_trg=jnp.asarray(gray),
        depth_trg=jnp.asarray(depth),
        gray_trg_gx=jnp.asarray(gx.astype(np.float32)),
        gray_trg_gy=jnp.asarray(gy.astype(np.float32)),
        depth_trg_gx=jnp.asarray(dgx.astype(np.float32)),
        depth_trg_gy=jnp.asarray(dgy.astype(np.float32)),
    )
    return level_np, level_jx


POSES = [
    np.eye(4, dtype=np.float32),
    np.asarray(
        se3.exp_se3(jnp.array([0.03, -0.02, 0.05, 0.01, -0.02, 0.015]), pseudo=True)
    ),
]


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("pose_idx", [0, 1])
def test_error_sphere_matches_reference(rng, method, pose_idx):
    level_np, level_jx = _small_level(rng)
    pose = POSES[pose_idx]
    xyz_np, valid_np = ref_impl.build_sphere_lut(level_np["depth_src"])
    expected = ref_impl.error_sphere(level_np, xyz_np, valid_np, pose.astype(np.float64), method)

    xyz, valid = sphere_xyz_lut(level_jx.depth_src, 0.3, 6.0)
    got = float(photoicp.error_sphere(level_jx, xyz, valid, jnp.asarray(pose), method))
    # abs floor: at identity the error is ~0 and only f32 rounding remains
    assert got == pytest.approx(expected, rel=2e-4, abs=1e-5)


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("pose_idx", [0, 1])
def test_hess_grad_matches_reference(rng, method, pose_idx):
    level_np, level_jx = _small_level(rng)
    pose = POSES[pose_idx]
    xyz_np, valid_np = ref_impl.build_sphere_lut(level_np["depth_src"])
    H_ref, g_ref, sso_ref = ref_impl.hess_grad_sphere(
        level_np, xyz_np, valid_np, pose.astype(np.float64), method
    )
    xyz, valid = sphere_xyz_lut(level_jx.depth_src, 0.3, 6.0)
    H, g, sso, *_ = photoicp.hess_grad_sphere(level_jx, xyz, valid, jnp.asarray(pose), method)
    scale = max(np.abs(H_ref).max(), 1.0)
    np.testing.assert_allclose(np.asarray(H) / scale, H_ref / scale, atol=2e-4)
    gscale = max(np.abs(g_ref).max(), 1.0)
    np.testing.assert_allclose(np.asarray(g) / gscale, g_ref / gscale, atol=2e-4)
    assert float(sso) == pytest.approx(sso_ref, abs=1e-6)


def test_lut_matches_reference(rng):
    level_np, level_jx = _small_level(rng)
    xyz_np, valid_np = ref_impl.build_sphere_lut(level_np["depth_src"])
    xyz, valid = sphere_xyz_lut(level_jx.depth_src, 0.3, 6.0)
    np.testing.assert_array_equal(np.asarray(valid), valid_np)
    np.testing.assert_allclose(np.asarray(xyz)[valid_np], xyz_np[valid_np], atol=1e-5)


def test_wrap_column_dropped():
    """Points projecting to theta==2*pi (col == W) are dropped, not wrapped."""
    h, w = 8, 16
    # just above the -z axis: theta = atan2(+eps, -1)+pi ~ 2*pi
    p = jnp.array([[0.0, 1e-8, -2.0]])
    dist, ri, ci, inb = sphere_project(p, h, w)
    assert int(ci[0]) == w  # rounds to the wrap column...
    assert not bool(inb[0])  # ...and is rejected like the reference


def test_synthetic_pose_recovery(rng):
    """Self-consistency: warping a frame by a known pose must be recovered
    below the 1e-3 north-star gate (BASELINE.md)."""
    h, w = 64, 256
    yy, xx = np.mgrid[0:h, 0:w]
    # multi-frequency texture: nearest-neighbour warps need rich gradients to
    # resolve sub-pixel motion
    gray = (
        0.5
        + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
        + 0.12 * np.sin(xx / 3.1)
        + 0.08 * np.cos(xx / 1.7 + yy / 2.3)
        + 0.06 * np.sin(yy / 1.9)
    ).astype(np.float32)
    depth = (
        2.0 + 0.6 * np.sin(xx / 13.0) + 0.3 * np.cos(yy / 8.0) + 0.1 * np.sin(xx / 5.0)
    ).astype(np.float32)
    gray_j, depth_j = jnp.asarray(gray), jnp.asarray(depth)

    xi = jnp.array([0.03, -0.024, 0.045, 0.012, -0.018, 0.009], jnp.float32)
    pose_true = se3.exp_se3(xi, pseudo=True)
    xyz, valid = sphere_xyz_lut(depth_j, 0.3, 6.0)
    p = xyz @ pose_true[:3, :3].T + pose_true[:3, 3]
    dist, ri, ci, inb = sphere_project(p, h, w)
    flat = jnp.clip(ri, 0, h - 1) * w + jnp.clip(ci, 0, w - 1)
    ok = (valid & inb).reshape(h, w)
    src_gray = jnp.where(ok, jnp.take(gray_j.reshape(-1), flat).reshape(h, w), 0.0)
    src_depth = jnp.where(ok, depth_j, 0.0)

    res = photoicp.align_spheres_jit(
        src_gray, src_depth, gray_j, depth_j, jnp.eye(4), method=photoicp.PHOTO_DEPTH, n_levels=3
    )
    assert not bool(res.ill_posed)
    err = np.abs(np.asarray(res.pose) - np.asarray(pose_true)).max()
    assert err < 1e-3


def test_self_alignment_is_identity(rng):
    h, w = 32, 128
    gray = jnp.asarray(rng.random((h, w)).astype(np.float32))
    depth = jnp.asarray((2.0 + rng.random((h, w))).astype(np.float32))
    res = photoicp.align_spheres_jit(
        gray, depth, gray, depth, jnp.eye(4), method=photoicp.PHOTO_DEPTH, n_levels=2
    )
    np.testing.assert_allclose(np.asarray(res.pose), np.eye(4), atol=1e-7)


def test_batched_alignment_vmap(rng):
    """The whole aligner vmaps over pairs (the DP scale-out unit)."""
    h, w = 16, 64
    gray = rng.random((2, h, w)).astype(np.float32)
    depth = (2.0 + rng.random((2, h, w))).astype(np.float32)
    f = jax.vmap(
        lambda gs, ds, gt, dt: photoicp.align_spheres_jit(
            gs, ds, gt, dt, jnp.eye(4), method=photoicp.PHOTO_DEPTH, n_levels=2
        )
    )
    res = f(jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(gray), jnp.asarray(depth))
    assert res.pose.shape == (2, 4, 4)
    np.testing.assert_allclose(np.asarray(res.pose[0]), np.eye(4), atol=1e-6)


def test_occlusion_variants(rng):
    """Occ1/Occ2 run and stay consistent with the plain variant on
    occlusion-free synthetic data."""
    h, w = 32, 128
    yy, xx = np.mgrid[0:h, 0:w]
    gray = (0.5 + 0.2 * np.sin(xx / 5.0) * np.cos(yy / 3.0) + 0.1 * np.sin(xx / 1.7)).astype(
        np.float32
    )
    depth = (2.0 + 0.4 * np.sin(xx / 9.0)).astype(np.float32)
    gray_j, depth_j = jnp.asarray(gray), jnp.asarray(depth)
    for occ in (1, 2):
        res = photoicp.align_spheres_jit(
            gray_j, depth_j, gray_j, depth_j, jnp.eye(4),
            method=photoicp.PHOTO_DEPTH, n_levels=2, occlusion=occ,
        )
        np.testing.assert_allclose(np.asarray(res.pose), np.eye(4), atol=1e-6)


def test_occlusion_zbuffer_drops_farther_point():
    """Two source points landing on one target pixel: only the closest
    contributes under occlusion=1."""
    from rgbd360_tpu.ops.photoicp import occlusion_mask_sphere

    h, w = 8, 32
    # craft two valid source points that project to the same target pixel:
    # same direction, different radius
    angle_res = 2 * np.pi / w
    phi = (0.5 * h - 0.5 - 3) * angle_res
    theta = 10 * angle_res
    d1, d2 = 1.0, 3.0
    xyz = np.zeros((h * w, 3), np.float32)
    valid = np.zeros(h * w, bool)
    for k, d in ((3 * w + 10, d1), (4 * w + 20, d2)):
        pass
    u = np.array([np.sin(phi), -np.cos(phi) * np.sin(theta), -np.cos(phi) * np.cos(theta)])
    xyz[0] = d1 * u
    xyz[1] = d2 * u
    valid[0] = valid[1] = True
    closest, dynamic = occlusion_mask_sphere(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.eye(4), (h, w)
    )
    closest = np.asarray(closest)
    assert closest[0] and not closest[1]


def _occ_level(rng, h=20, w=120, depth_spread=1.2):
    """src==trg panorama with fully-valid target depth (invalid-depth
    semantics are covered by the plain-path parity tests; these gates focus
    on the z-buffer / outlier-filter semantics). Depth noise keeps colliding
    points' distances well separated (>>f32 eps), so the f32 pipeline and
    the f64 oracle agree on every z-buffer winner — a SMOOTH depth makes
    adjacent colliding pixels near-tie, where f32 rounding legitimately
    flips winners against the deviation-by-design 'ties all survive'
    scatter-max. The near band at the compression zone (theta ~ pi under
    forward motion) creates wide-gap occlusions."""
    yy, xx = np.mgrid[0:h, 0:w]
    gray = (
        0.5 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.05 * rng.normal(size=(h, w))
    ).astype(np.float32)
    depth = (
        2.5 + depth_spread * np.sin(xx / 11.0) + 0.4 * np.cos(yy / 6.0)
        + 0.15 * rng.normal(size=(h, w))
    ).astype(np.float32)
    depth[:, 52:62] = 1.2
    return _level_pair(gray, depth)


def _level_pair(gray, depth):
    gx, gy = ref_impl.gradient_xy(gray.astype(np.float64))
    dgx, dgy = ref_impl.gradient_xy(depth.astype(np.float64))
    level_np = dict(
        gray_src=gray.astype(np.float64), depth_src=depth.astype(np.float64),
        gray_trg=gray.astype(np.float64), depth_trg=depth.astype(np.float64),
        gray_trg_gx=gx, gray_trg_gy=gy, depth_trg_gx=dgx, depth_trg_gy=dgy,
    )
    level_jx = photoicp.LevelData(
        gray_src=jnp.asarray(gray), depth_src=jnp.asarray(depth),
        gray_trg=jnp.asarray(gray), depth_trg=jnp.asarray(depth),
        gray_trg_gx=jnp.asarray(gx.astype(np.float32)),
        gray_trg_gy=jnp.asarray(gy.astype(np.float32)),
        depth_trg_gx=jnp.asarray(dgx.astype(np.float32)),
        depth_trg_gy=jnp.asarray(dgy.astype(np.float32)),
    )
    return level_np, level_jx


def _occ_sweep(level_jx, pose, method, occ):
    xyz, valid = sphere_xyz_lut(level_jx.depth_src, 0.3, 6.0)
    packed = photoicp.pack_target_channels(level_jx)
    return photoicp.fused_sweep_sphere(
        level_jx.gray_src.reshape(-1), packed, level_jx.gray_src.shape,
        xyz, valid, jnp.asarray(pose), method, occ,
    )


def _project_np(level_np, pose):
    """Vectorized restatement of the oracle projection, for scene analysis."""
    h, w = level_np["gray_src"].shape
    xyz, valid = ref_impl.build_sphere_lut(level_np["depth_src"])
    p = xyz @ pose[:3, :3].T + pose[:3, 3]
    dist = np.linalg.norm(p, axis=1)
    dist = np.where(dist > 0, dist, 1.0)
    phi = np.arcsin(np.clip(p[:, 0] / dist, -1, 1))
    theta = np.arctan2(p[:, 1], p[:, 2]) + np.pi
    ares_inv = w / (2.0 * np.pi)
    half = 0.5 * h - 0.5
    rr = half - phi * ares_inv
    cc = theta * ares_inv
    ri = (np.floor(np.abs(rr) + 0.5) * np.sign(rr + 1e-300)).astype(int)
    ci = (np.floor(np.abs(cc) + 0.5) * np.sign(cc + 1e-300)).astype(int)
    inb = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w) & valid
    return np.where(inb, ri * w + ci, -1), dist, inb


@pytest.mark.parametrize("method", [0, 1, 2])
def test_occ1_matches_sequential_oracle(rng, method):
    """fused_sweep_sphere(occlusion=1) vs the SEQUENTIAL Occ1 transcription
    (ref_impl.error_sphere_occ): the reference keys Occ1 residuals by target
    pixel and overwrites on closer arrivals, so its final sums hold exactly
    the per-pixel winners — equal to the scatter-max semantics even when
    collisions occur; the COUNTS overcount displaced points by design."""
    level_np, level_jx = _occ_level(rng)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.45  # forward motion -> genuine many-to-one warping
    flat, _, inb = _project_np(level_np, pose.astype(np.float64))
    hits = np.bincount(flat[inb], minlength=level_np["gray_src"].size)
    assert hits.max() >= 2, "scene must exercise the z-buffer"

    pe_ref, nph_ref, de_ref, nd_ref = ref_impl.error_sphere_occ(
        level_np, *ref_impl.build_sphere_lut(level_np["depth_src"]),
        pose.astype(np.float64), method, occlusion=1,
    )
    _, _, _, _, pe, nph, de, nd = _occ_sweep(level_jx, pose, method, 1)
    assert float(pe) == pytest.approx(pe_ref, rel=2e-4, abs=1e-6)
    assert float(de) == pytest.approx(de_ref, rel=2e-4, abs=1e-6)
    # sequential counts >= winners-only counts; strictly greater when a
    # displaced point passed the gates before losing the buffer
    assert int(nph) <= nph_ref and int(nd) <= nd_ref


def test_occ1_collision_free_counts_match(rng):
    """At identity the warp is injective: sequential == scatter-max exactly,
    counts included."""
    level_np, level_jx = _occ_level(rng)
    pose = np.eye(4)
    pe_ref, nph_ref, de_ref, nd_ref = ref_impl.error_sphere_occ(
        level_np, *ref_impl.build_sphere_lut(level_np["depth_src"]), pose, 2,
        occlusion=1,
    )
    _, _, _, _, pe, nph, de, nd = _occ_sweep(level_jx, pose, 2, 1)
    assert (int(nph), int(nd)) == (nph_ref, nd_ref)
    assert float(pe) == pytest.approx(pe_ref, rel=2e-4, abs=1e-6)
    assert float(de) == pytest.approx(de_ref, rel=2e-4, abs=1e-6)


def test_occ2_outlier_filtered_before_zbuffer(rng):
    """Ordering gate (reference :3789-3799): the depth-outlier filter runs
    BEFORE the z-buffer write, so a closer-but-outlier point must NOT
    displace a clean farther point landing on the same target pixel. The
    scene engineers such a pixel, then requires sum parity with the
    sequential oracle (the pre-fix buffer-then-filter order fails this)."""
    level_np, level_jx = _occ_level(rng)
    h, w = level_np["gray_src"].shape
    pose64 = np.eye(4)
    pose64[2, 3] = 0.45
    flat, dist, inb = _project_np(level_np, pose64)
    # find a target pixel hit by two points whose distance gap exceeds the
    # 0.3 outlier threshold with margin
    engineered = None
    order = np.argsort(flat)
    fs = flat[order]
    for a in range(len(fs) - 1):
        if fs[a] < 0 or fs[a] != fs[a + 1]:
            continue
        i1, i2 = order[a], order[a + 1]
        dn, df = sorted((dist[i1], dist[i2]))
        if df - dn > 0.45:
            engineered = (int(fs[a]), float(df))
            break
    assert engineered is not None, "scene must contain a wide-gap collision"
    ii, df = engineered
    # clean for the farther point, outlier for the nearer one
    depth_trg = level_np["depth_trg"].copy()
    depth_trg[ii // w, ii % w] = df
    gray = level_np["gray_src"].astype(np.float32)
    level_np, level_jx = _level_pair(gray, level_np["depth_src"].astype(np.float32))
    level_np["depth_trg"] = depth_trg
    dgx, dgy = ref_impl.gradient_xy(depth_trg)
    level_np["depth_trg_gx"], level_np["depth_trg_gy"] = dgx, dgy
    level_jx = level_jx._replace(
        depth_trg=jnp.asarray(depth_trg.astype(np.float32)),
        depth_trg_gx=jnp.asarray(dgx.astype(np.float32)),
        depth_trg_gy=jnp.asarray(dgy.astype(np.float32)),
    )
    pose = pose64.astype(np.float32)
    lut = ref_impl.build_sphere_lut(level_np["depth_src"])
    # winners-only: the deterministic projection of the reference's racy
    # by-source-slot Occ2 semantics, which the scatter-max implements
    pe_ref, _, de_ref, _ = ref_impl.error_sphere_occ(
        level_np, *lut, pose64, 2, occlusion=2, winners_only=True,
    )
    # faithful by-source sums are an upper bound (displaced points keep
    # their residual slots in the reference, :3816/:3832)
    pe_full, _, de_full, _ = ref_impl.error_sphere_occ(
        level_np, *lut, pose64, 2, occlusion=2,
    )
    _, _, _, _, pe, _, de, _ = _occ_sweep(level_jx, pose, 2, 2)
    assert float(pe) == pytest.approx(pe_ref, rel=2e-4, abs=1e-6)
    assert float(de) == pytest.approx(de_ref, rel=2e-4, abs=1e-6)
    assert float(pe) <= pe_full * (1 + 2e-4) and float(de) <= de_full * (1 + 2e-4)
    assert pe_full > pe_ref  # the scene actually displaced accepted points


def test_occ2_mask_outlier_does_not_displace_clean_point():
    """Direct unit gate on occlusion_mask_sphere's Occ2 ordering."""
    from rgbd360_tpu.ops.photoicp import occlusion_mask_sphere

    h, w = 8, 32
    angle_res = 2 * np.pi / w
    phi = (0.5 * h - 0.5 - 3) * angle_res
    theta = 10 * angle_res
    u = np.array([np.sin(phi), -np.cos(phi) * np.sin(theta), -np.cos(phi) * np.cos(theta)])
    d_near, d_far = 1.0, 3.0
    xyz = np.zeros((h * w, 3), np.float32)
    valid = np.zeros(h * w, bool)
    xyz[0] = d_near * u
    xyz[1] = d_far * u
    valid[0] = valid[1] = True
    # target depth at the landing pixel agrees with the FAR point -> the
    # near point is a dynamic outlier (|3-1| > 0.3) and must not occupy the
    # z-buffer; the far clean point survives
    tdepth = np.full(h * w, d_far, np.float32)
    closest, dynamic = occlusion_mask_sphere(
        jnp.asarray(xyz), jnp.asarray(valid), jnp.eye(4), (h, w),
        target_depth_flat=jnp.asarray(tdepth), occlusion=2,
    )
    closest, dynamic = np.asarray(closest), np.asarray(dynamic)
    assert dynamic[0] and not closest[0]
    assert closest[1]


def test_calc_entropy_matches_reference_formula(rng):
    """calcEntropy (reference :4789-4797): 0.5*(DOF*(1+log 2pi) + log|H^-1|)
    — the closed-form Cholesky logdet must equal the naive inverse+det."""
    A = rng.normal(size=(6, 6))
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    expected = 0.5 * (6.0 * (1.0 + np.log(2 * np.pi))
                      + np.log(np.linalg.det(np.linalg.inv(H.astype(np.float64)))))
    got = float(photoicp.calc_entropy(jnp.asarray(H)))
    assert got == pytest.approx(expected, rel=1e-5)


# twists [v, w] (mrpt pseudo-exponential, w about the vertical x axis first)
SWEEP_MOTIONS = {
    # tracking-scale: a few mm and a fraction of a degree
    "small": [0.01, -0.005, 0.01, 0.002, -0.003, 0.002],
    # a yaw of 0.2 rad moves every column ~3.8 px at w=120, so the columns
    # next to the theta seam land on the far side of it
    "theta_seam": [0.0, 0.01, -0.01, 0.2, 0.0, 0.0],
    # loop-closure scale: ~25 cm and several degrees
    "lc_scale": [0.05, 0.2, -0.15, 0.05, 0.08, -0.04],
}


@pytest.mark.parametrize("motion", sorted(SWEEP_MOTIONS))
@pytest.mark.parametrize("method", [0, 1, 2])
def test_fused_sweep_matches_reference(rng, method, motion):
    """The fused sweep over the packed target rows (one gather of 16-byte
    rows, f16 gradient pairs) against the scalar reference
    (ref_impl.error_sphere + hess_grad_sphere) at tracking, seam-straddling
    and loop-closure-scale motion. Tolerances are the golden-parity ones:
    the f16 gradients shift the saliency test for a few pixels."""
    level_np, level_jx = _small_level(rng)
    pose = np.asarray(
        se3.exp_se3(jnp.asarray(SWEEP_MOTIONS[motion], jnp.float32), pseudo=True)
    )
    pose64 = pose.astype(np.float64)
    xyz_np, valid_np = ref_impl.build_sphere_lut(level_np["depth_src"])
    e_ref = ref_impl.error_sphere(level_np, xyz_np, valid_np, pose64, method)
    H_ref, g_ref, sso_ref = ref_impl.hess_grad_sphere(level_np, xyz_np, valid_np, pose64, method)

    xyz, valid = sphere_xyz_lut(level_jx.depth_src, 0.3, 6.0)
    err, H, g, sso, *_ = photoicp.fused_sweep_sphere(
        level_jx.gray_src.reshape(-1), photoicp.pack_target_channels(level_jx),
        level_jx.gray_src.shape, xyz, valid, jnp.asarray(pose), method,
    )
    assert float(err) == pytest.approx(e_ref, rel=5e-4, abs=1e-5)
    hs = max(np.abs(H_ref).max(), 1.0)
    np.testing.assert_allclose(np.asarray(H) / hs, H_ref / hs, atol=5e-4)
    gs = max(np.abs(g_ref).max(), 1.0)
    np.testing.assert_allclose(np.asarray(g) / gs, g_ref / gs, atol=5e-3)
    assert float(sso) == pytest.approx(sso_ref, abs=1e-6)
    if motion == "theta_seam":
        # the warp really crosses the seam: source columns next to one side
        # of it land on target columns next to the other side
        p = xyz_np @ pose64[:3, :3].T + pose64[:3, 3]
        theta = np.arctan2(p[:, 1], p[:, 2]) + np.pi
        col = np.floor(theta * 120 / (2 * np.pi) + 0.5)
        src_col = np.tile(np.arange(120), 20)
        across = ((src_col <= 3) & (col >= 116)) | ((src_col >= 116) & (col <= 3))
        assert np.any(valid_np & across)
