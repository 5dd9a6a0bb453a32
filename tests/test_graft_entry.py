"""The entry points must compile and run (single-device fn + 8-device mesh)."""


def test_dryrun_multichip_8():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles_tiny():
    """entry() returns full-panorama args; here just check the fn traces on
    a tiny analogue."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    assert args[0].shape == (320, 1920)
    gray, depth = __graft_entry__._synthetic_pair(32, 192)

    def small_fn(gs, ds, gt, dt, pose):
        from rgbd360_tpu.ops import photoicp

        src = photoicp.build_pyramid_set(gs, ds, 3, is_target=False, sphere_seam_mask=True)
        trg = photoicp.build_pyramid_set(gt, dt, 3, is_target=True, sphere_seam_mask=True)
        res = photoicp.align_frames360(src, trg, pose, photoicp.PHOTO_DEPTH)
        return res.pose

    out = jax.jit(small_fn)(gray, depth, gray, depth, jnp.eye(4))
    np.testing.assert_allclose(np.asarray(out), np.eye(4), atol=1e-6)


def test_prefilter_candidates_sharded_matches_single_device(calib):
    """The relocalize/LC candidate sweep sharded over the 8-device mesh must
    reproduce the single-device prefilter exactly, including the padding
    shard when the candidate count is not a mesh multiple (SURVEY §2.3
    map-level op sharding)."""
    import numpy as np
    from room_scene import room_frame

    from rgbd360_tpu.core.batch_match import prefilter_candidates
    from rgbd360_tpu.core.matcher import PLANAR_3DOF, MatcherConfig
    from rgbd360_tpu.parallel.mesh import make_mesh, prefilter_candidates_sharded

    rel = np.eye(4)
    rel[1, 3] = 0.3
    query = room_frame(calib, None, 0)
    # 5 candidates (not a multiple of 8 devices -> exercises padding)
    cands = []
    for i in range(5):
        r = np.eye(4)
        r[1, 3] = 0.1 * i
        r[2, 3] = -0.05 * i
        cands.append(room_frame(calib, r, i + 1).planes)

    cfg = MatcherConfig()
    counts_ref, areas_ref = prefilter_candidates(
        query.planes, cands, cfg, PLANAR_3DOF
    )
    mesh = make_mesh()
    counts_sh, areas_sh = prefilter_candidates_sharded(
        mesh, query.planes, cands, cfg, PLANAR_3DOF
    )
    np.testing.assert_array_equal(counts_sh, counts_ref)
    np.testing.assert_allclose(areas_sh, areas_ref, rtol=1e-6)


def test_dryrun_multichip_4():
    """A non-default device count: catches hardcoded-8 mesh assumptions in
    the sharding layout (the driver may dry-run at other widths)."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
