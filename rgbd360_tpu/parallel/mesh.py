"""Multi-device scale-out over a jax.sharding.Mesh.

The workload's parallel structure (SURVEY.md §2.3): independent frame-pair
registrations scale data-parallel over the devices of one host; the 8-sensor
dimension is a batch axis inside each registration; map-level ops
(relocalize-against-all-keyframes, loop-closure candidate sweeps) batch the
same way. There is no model state to shard — weights-equivalents (calibration
tables) are tiny and replicated.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rgbd360_tpu.ops import photoicp
from rgbd360_tpu.parallel.batch import align_batch

PAIR_AXIS = "pairs"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=(PAIR_AXIS,))


def shard_pairs(mesh: Mesh, *arrays):
    """Place batched arrays with the leading pair axis split over the mesh."""
    sharding = NamedSharding(mesh, P(PAIR_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)


@functools.lru_cache(maxsize=32)
def _align_sharded_fn(mesh: Mesh, method: int, n_levels: int):
    """One jitted callable per (mesh, method, n_levels) so repeated calls
    with stable shapes reuse the compiled executable instead of retracing.

    shard_map: every device runs the whole fused program on its local slice
    of the pair axis. Pairs are independent (SURVEY §2.3): no collectives in
    the body, outputs stay pair-sharded."""
    local = functools.partial(align_batch, method=method, n_levels=n_levels)
    sharded = jax.shard_map(
        lambda gs, ds, gt, dt, p: local(gs, ds, gt, dt, p),
        mesh=mesh,
        in_specs=(P(PAIR_AXIS),) * 5,
        out_specs=P(PAIR_AXIS),
        # the GN while_loop carries scalar constants (iteration counter,
        # tolerance state) that start replicated and become device-varying on
        # the first step; there are no collectives in the body, so the
        # varying-axis bookkeeping the check enforces has nothing to protect
        check_vma=False,
    )
    return jax.jit(sharded)


def align_batch_sharded(
    mesh: Mesh,
    gray_src,
    depth_src,
    gray_trg,
    depth_trg,
    pose_guess,
    method: int = photoicp.PHOTO_DEPTH,
    n_levels: int = 5,
) -> photoicp.AlignResult:
    """Data-parallel batched registration: batch axis split over PAIR_AXIS
    under shard_map. The batch must divide by the mesh size; no collectives
    are needed in the steady state because pairs are independent
    (gradients/Hessians are per-pair 6x6 — they never cross devices).
    """
    fn = _align_sharded_fn(mesh, method, n_levels)
    return fn(gray_src, depth_src, gray_trg, depth_trg, pose_guess)


def prefilter_candidates_sharded(mesh: Mesh, frame_pbmap, cand_pbmaps, config, mode):
    """Relocalize/loop-closure candidate sweep with the keyframe axis split
    over the mesh (SURVEY §2.3: map-level ops batch over KFs; the query
    frame's plane set is replicated, each device scores its shard of
    candidate keyframes, the boolean compatibility reductions come back with
    one tiny all-gather inserted by XLA). Candidate count is padded up to a
    mesh multiple; results match core.batch_match.prefilter_candidates."""
    import math

    import numpy as np

    from rgbd360_tpu.core.batch_match import _compat_matrix, pack_pbmap, stack_packs

    n = len(cand_pbmaps)
    if n == 0:
        return np.zeros(0, int), np.zeros(0)
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    packs = [pack_pbmap(p) for p in cand_pbmaps]
    packs += [pack_pbmap(cand_pbmaps[0])] * pad  # pad shard; sliced off below
    packed = stack_packs(packs)

    ref = {k: jnp.asarray(v) for k, v in pack_pbmap(frame_pbmap).items() if k != "count"}
    cfg = (
        config.area_threshold,
        config.elongation_threshold,
        config.hue_threshold,
        config.dist_d,
        math.cos(math.radians(config.angle_deg)),
    )
    cand_spec = NamedSharding(mesh, P(PAIR_AXIS))
    trg = {k: jax.device_put(jnp.asarray(v), cand_spec) for k, v in packed.items()}
    counts, areas = _prefilter_sharded_fn(mesh, mode)(ref, trg, jnp.asarray(cfg))
    return np.asarray(counts)[:n], np.asarray(areas)[:n]


@functools.lru_cache(maxsize=32)
def _prefilter_sharded_fn(mesh: Mesh, mode: int):
    """One jitted sweep per (mesh, mode): the matcher thresholds arrive as a
    traced array so config changes don't retrace either."""
    from rgbd360_tpu.core.batch_match import _compat_matrix

    cand_spec = NamedSharding(mesh, P(PAIR_AXIS))
    repl = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(repl, cand_spec, repl),
        out_shardings=(repl, repl),
    )
    def run(ref_in, trg_in, cfg_arr):
        cfg_t = tuple(cfg_arr[i] for i in range(5))
        compat = jax.vmap(lambda t: _compat_matrix(ref_in, t, cfg_t, mode))(trg_in)
        frame_has = jnp.any(compat, axis=2)
        cand_has = jnp.any(compat, axis=1)
        counts = jnp.minimum(frame_has.sum(axis=1), cand_has.sum(axis=1))
        areas = (cand_has * trg_in["area"]).sum(axis=1)
        return counts, areas

    return run
