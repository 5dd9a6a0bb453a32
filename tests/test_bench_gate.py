"""bench.py sanity-gate tests — the fine-level blind spot.

The denormal-flush incident (PERF.md "Faithfulness rails") proved a perf
"win" can come from silently computing less. bench.sanity_check therefore
gates the FULL iteration signature against a CPU-cross-checked set and a
two-sided error band, and the tests below prove the rails actually fire —
including a deliberate regression: a finest-level (L0) iteration cap on a
real alignment must flip sane to False even though a coarse-prefix gate
would have passed it.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

from rgbd360_tpu.ops import photoicp  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pair_1_10.npz")


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden npz not generated (tools/make_golden.py)")
    return np.load(GOLDEN)


def _check(golden, iters, err=None, pose=None):
    return bench.sanity_check(
        golden["free_pose"] if pose is None else pose,
        float(golden["free_error"]) if err is None else err,
        False,
        iters,
        golden=golden,
    )


def test_golden_free_run_passes(golden):
    ok, reasons = _check(golden, golden["free_iters"])
    assert ok, reasons


def test_flush_era_signature_fails(golden):
    # the flush-era corrupted landscape ([4,10,9,4,2]) passed every pose
    # gate; the signature rail must reject it
    ok, reasons = _check(golden, [4, 10, 9, 4, 2])
    assert not ok and any("signature" in r for r in reasons)


def test_finest_flat_spot_is_fallback_only(golden):
    # (0,7,10,10,3) is a legitimate flat-spot basin of the exact chain, so
    # it stays in the allowed set until the H100 signature is pinned; a
    # finest level cut shorter than any recorded basin must fail
    ok, reasons = _check(golden, [0, 7, 10, 10, 3])
    assert ok, reasons
    ok, reasons = _check(golden, [0, 7, 10, 10, 2])
    assert not ok and any("signature" in r for r in reasons)


def test_thinned_error_fails_two_sided_band(golden):
    # a term-set-thinning artifact lowers the error metric itself — the
    # round-3 one-sided (upper) bound was blind to this direction
    ok, reasons = _check(golden, golden["free_iters"], err=float(golden["free_error"]) - 1.0)
    assert not ok and any("band" in r for r in reasons)
    ok, reasons = _check(golden, golden["free_iters"], err=float(golden["free_error"]) + 1.0)
    assert not ok and any("band" in r for r in reasons)


def test_inverted_pose_fails_vector_gate(golden):
    inv = np.linalg.inv(golden["free_pose"])
    ok, reasons = _check(golden, golden["free_iters"], pose=inv)
    assert not ok and any("golden basin" in r for r in reasons)


def test_injected_finest_early_stop_flips_sane(golden, monkeypatch):
    """Run the REAL aligner with the finest level (L0) skipped — capped at
    0 iterations, everything else untouched — and feed the result through
    the bench gate exactly as bench.main does: it must come out not-sane.

    (0,7,10,10,0) passes a coarse-prefix gate AND can satisfy the pose
    gates — only the full-signature rail catches it. The cap is 0 because
    the recorded legitimate basins already stop L0 after 3 or 1 steps.
    """
    full_h = int(golden["gray_src_u8"].shape[0])
    orig = photoicp.align_level_sphere

    def capped(level, pose0, method, *args, **kw):
        if level.gray_src.shape[0] == full_h:
            kw["max_iters"] = 0
        return orig(level, pose0, method, *args, **kw)

    monkeypatch.setattr(photoicp, "align_level_sphere", capped)

    gray_src = jnp.asarray(golden["gray_src_u8"].astype(np.float32) / 255.0)
    gray_trg = jnp.asarray(golden["gray_trg_u8"].astype(np.float32) / 255.0)
    depth_src = jnp.asarray(golden["depth_src_mm"].astype(np.float32) * 0.001)
    depth_trg = jnp.asarray(golden["depth_trg_mm"].astype(np.float32) * 0.001)
    n = int(golden["n_levels"])

    # a FRESH jit object: the module-level align_spheres_jit may hold a
    # cached trace of the unpatched align_level_sphere
    @functools.partial(jax.jit, static_argnames=("method", "n_levels"))
    def run(gs, ds, gt, dt, method, n_levels):
        src = photoicp.build_pyramid_set(gs, ds, n_levels, is_target=False, sphere_seam_mask=True)
        trg = photoicp.build_pyramid_set(gt, dt, n_levels, is_target=True, sphere_seam_mask=True)
        return photoicp.align_frames360(src, trg, jnp.eye(4), method)

    res = run(gray_src, depth_src, gray_trg, depth_trg, photoicp.PHOTO_DEPTH, n)
    iters = np.asarray(res.num_iterations)
    assert int(iters[-1]) == 0, "injection did not take"
    assert tuple(int(x) for x in iters[:3]) == (0, 7, 10), (
        "coarse prefix unexpectedly moved — the injection must isolate L0"
    )
    ok, reasons = bench.sanity_check(
        np.asarray(res.pose),
        float(np.asarray(res.error)),
        bool(np.asarray(res.ill_posed)),
        iters,
        golden=golden,
    )
    assert not ok, "injected L0 early stop passed the bench gate"
    assert any("signature" in r for r in reasons), reasons
