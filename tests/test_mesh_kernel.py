"""Sharded dense refinement (SURVEY §2.3 map-level multi-device ops).

Gates the routing in core/loop_closure.py: the LC dense refinement bucket
splits over the pair mesh when more than one device is present, and the
sharded bucket returns the same accept-gate quantities as the
single-device program. Runs on the 8 virtual CPU devices
(tests/conftest.py).
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rgbd360_tpu.parallel import mesh as pmesh
from rgbd360_tpu.parallel.batch import align_batch


def test_lc_refine_batch_routes_through_mesh(monkeypatch):
    """core/loop_closure._refine_batch with >=2 survivors on a multi-device
    backend must (a) call align_batch_sharded and (b) return the same
    accept-gate quantities as the single-device path."""
    if len(jax.devices()) < 2:
        pytest.skip("needs >1 device")
    from rgbd360_tpu.core import loop_closure as lc_mod

    h, w = 32, 192
    rng = np.random.default_rng(9)
    g = rng.uniform(0.2, 0.8, size=(h, w)).astype(np.float32)
    d_mm = rng.uniform(1500, 3500, size=(h, w)).astype(np.float32)

    def frame(roll):
        return types.SimpleNamespace(
            sphere_gray=np.roll(g, roll, axis=1),
            sphere_depth_mm=np.roll(d_mm, roll, axis=1),
        )

    new_kf = frame(0)
    frames = {0: frame(1), 1: frame(2)}

    lc = lc_mod.LoopClosure360.__new__(lc_mod.LoopClosure360)
    lc.map = types.SimpleNamespace(frames=frames)
    lc.aligner = types.SimpleNamespace(n_pyr_levels=2)

    survivors = [(0, np.eye(4)), (1, np.eye(4))]

    sharded_calls = []
    orig_sharded = pmesh.align_batch_sharded

    def spy(mesh, *a, **k):
        sharded_calls.append(mesh)
        return orig_sharded(mesh, *a, **k)

    monkeypatch.setattr(
        "rgbd360_tpu.parallel.mesh.align_batch_sharded", spy
    )
    out_sharded = lc._refine_batch(new_kf, survivors)
    assert len(sharded_calls) == 1, "LC refine did not route through the mesh"
    assert sharded_calls[0].devices.size >= 2

    # single-device expectation: the same bucket through plain align_batch
    gs = np.stack([new_kf.sphere_gray] * 2)
    ds = np.stack([np.asarray(new_kf.sphere_depth_mm, np.float32) * 0.001] * 2)
    gt = np.stack([frames[k].sphere_gray for k in (0, 1)])
    dt = np.stack(
        [np.asarray(frames[k].sphere_depth_mm, np.float32) * 0.001 for k in (0, 1)]
    )
    seeds = np.stack([np.eye(4, dtype=np.float32)] * 2)
    res = align_batch(
        jnp.asarray(gs), jnp.asarray(ds), jnp.asarray(gt), jnp.asarray(dt),
        jnp.asarray(seeds), n_levels=2,
    )
    assert len(out_sharded) == 2
    for k, (cand, pose, av_depth, H, sso) in enumerate(out_sharded):
        assert cand == k
        np.testing.assert_allclose(pose, np.asarray(res.pose[k]), atol=1e-6)
        assert abs(av_depth - float(res.av_depth_residual[k])) < 1e-6
        assert abs(sso - float(res.sso[k])) < 1e-6
