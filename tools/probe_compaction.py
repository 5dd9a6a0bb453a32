"""Micro-A/B the stats-buffer candidate compaction and the refine stages.

The device bisect (tools/profile_planes_device.py) once priced the
candidate compaction and refine_plane_labels as the two fattest stages
after segment. This probe decomposes both and prices alternative
compaction formulations on the real bundled-frame data:

  cumsum        the (8, hw) prefix sum alone
  scatter       cumsum + the (hw -> C+1) scatter .at[tgt].set (shipped)
  gathers       shipped + the cand_xyz/clab take_along_axis gathers
  sortpair      lax.sort of (key = cand ? pix : BIG) then slice C
  searchsorted  cidx[s] = searchsorted(cumsum, s+1) (binary-search gathers)
  onehotdot     feats[s] = sum_i [pos_i == s & cand_i] * feat_i as a matmul
  refine_model  refine's model build alone (scatter-adds + eigh + gathers)
  refine_k<N>   N fixed refine sweeps (no while_loop, prices one sweep)

Methodology: chained fori_loop per probe, bundled frame 1.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _frame_inputs():
    """Bundled frame 1 as device-resident (depth_undistorted_m, rgb)."""
    import jax.numpy as jnp

    from rgbd360_tpu.core.frame360 import Frame360
    from rgbd360_tpu.io.calib import Calib360

    ref = os.environ.get("RGBD360_REFERENCE", "/root/reference")
    calib = Calib360.load(ref)
    frame = Frame360(calib)
    frame.load_frame(os.path.join(ref, "samples/sphere_images_1.bin"))
    frame.undistort()
    return jnp.asarray(frame.depth_undistorted_m), jnp.asarray(frame.rgb)


def _make_timed(k: int):
    """Chained-fori_loop probe harness, SHARED by both
    batteries so a methodology fix reaches every probe. fn(*inputs, eps) ->
    f32 scalar; eps is a data-dependent scalar the body MUST mix into its
    inputs — without it XLA hoists the loop-invariant computation out of the
    fori_loop and the probe prices one evaluation amortized over k
    (every such probe then reads the same time regardless of content)."""
    import jax
    import jax.numpy as jnp

    def timed(name, fn, *inputs):
        @jax.jit
        def chain(kk, *ins):
            def body(_, carry):
                eps, acc = carry
                out = fn(*ins, eps)
                return out * 1e-30, acc + out * 1e-9

            _, acc = jax.lax.fori_loop(0, kk, body, (jnp.float32(0), jnp.float32(0)))
            return acc

        np.asarray(chain(k, *inputs))  # warm
        np.asarray(jnp.zeros(()) + 1.0)
        t0 = time.perf_counter()
        np.asarray(chain(k, *inputs))
        ms = (time.perf_counter() - t0) / k * 1e3
        print(f"{name:16s}: {ms:7.2f} ms")
        return ms

    return timed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=30)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.ops.bilateral import fast_bilateral_z
    from rgbd360_tpu.ops.normals import organized_normals
    from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2
    from rgbd360_tpu.ops.planes_seg import refine_plane_labels, segment_planes

    depth, rgb = _frame_inputs()

    # materialize the REAL segmentation inputs once (device-resident)
    @jax.jit
    def prep(depth, rgb):
        def one(d, rgb_s):
            xyz = backproject_organized(d)
            xyz2, rgb2 = downsample_median2(xyz, rgb_s)
            zf = fast_bilateral_z(xyz2[..., 2])
            xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
            normals = organized_normals(xyz2)
            labels_pre = segment_planes(xyz2, normals)
            labels = refine_plane_labels(labels_pre, xyz2, normals)
            from rgbd360_tpu.ops.plane_stats import sensor_plane_stats

            st = sensor_plane_stats(xyz2, rgb2, labels, labels_pre)
            return xyz2, normals, labels_pre, labels, st.candidate

        return jax.vmap(one)(depth, rgb)

    xyz2, normals, labels_pre, labels, cand = jax.tree_util.tree_map(
        jnp.asarray, prep(depth, rgb)
    )
    h, w = labels.shape[1:]
    hw = h * w
    C = 4096
    print(f"grid (8,{h},{w}) hw={hw}  candidates/sensor:",
          np.asarray(jnp.sum(cand, axis=(1, 2))))

    timed = _make_timed(args.k)

    candf = cand.reshape(8, hw)
    feat = jnp.concatenate(
        [
            jnp.where(jnp.isfinite(xyz2), xyz2, 0.0).reshape(8, hw, 3),
            (labels.reshape(8, hw, 1) + 1).astype(jnp.float32),
        ],
        axis=-1,
    )

    def f_cumsum(candf, eps):
        candf = candf ^ (eps > 1.0)
        pos = jnp.cumsum(candf.astype(jnp.int32), axis=1) - 1
        return jnp.sum(pos).astype(jnp.float32)

    # the 'scatter' arm prices THE shipped compaction via its shared
    # definition (plane_extraction.compact_candidate_indices) — never a copy
    from rgbd360_tpu.core.plane_extraction import compact_candidate_indices

    def f_scatter(candf, eps):
        candf = candf ^ (eps > 1.0)
        cidx = compact_candidate_indices(candf, C)
        return jnp.sum(cidx).astype(jnp.float32)

    def f_gathers(candf, xyz2, labels, eps):
        candf = candf ^ (eps > 1.0)
        cidx = compact_candidate_indices(candf, C)
        slot_ok = cidx < hw
        cidx_safe = jnp.minimum(cidx, hw - 1)
        cxyz = jnp.take_along_axis(
            xyz2.reshape(8, hw, 3), cidx_safe[..., None], axis=1
        )
        cxyz = jnp.where(slot_ok[..., None], cxyz, jnp.nan).astype(jnp.float16)
        clab = jnp.take_along_axis(labels.reshape(8, hw), cidx_safe, axis=1)
        return (jnp.sum(cxyz.astype(jnp.float32)) + jnp.sum(clab)).astype(
            jnp.float32
        )

    def f_sortpair(candf, eps):
        candf = candf ^ (eps > 1.0)
        pix = jax.lax.broadcasted_iota(jnp.int32, (8, hw), 1)
        key = jnp.where(candf, pix, hw)
        cidx = jax.lax.sort(key, dimension=1)[:, :C]
        return jnp.sum(cidx).astype(jnp.float32)

    def f_searchsorted(candf, eps):
        candf = candf ^ (eps > 1.0)
        c = jnp.cumsum(candf.astype(jnp.int32), axis=1)
        targets = jnp.arange(1, C + 1, dtype=jnp.int32)
        cidx = jax.vmap(lambda a: jnp.searchsorted(a, targets))(c)
        return jnp.sum(cidx).astype(jnp.float32)

    def f_onehotdot(candf, feat, eps):
        candf = candf ^ (eps > 1.0)
        pos = jnp.cumsum(candf.astype(jnp.int32), axis=1) - 1
        key = jnp.where(candf, pos, -1)
        slots = jnp.arange(C, dtype=jnp.int32)
        onehot = (key[:, :, None] == slots[None, None, :]).astype(jnp.bfloat16)
        out = jnp.einsum(
            "bns,bnf->bsf",
            onehot,
            feat.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        return jnp.sum(out).astype(jnp.float32)

    timed("cumsum", f_cumsum, candf)
    timed("scatter", f_scatter, candf)
    timed("gathers", f_gathers, candf, xyz2, labels)
    timed("sortpair", f_sortpair, candf)
    timed("searchsorted", f_searchsorted, candf)
    timed("onehotdot", f_onehotdot, candf, feat)

    # ---- refine decomposition -------------------------------------------
    def f_refine_model(labels_pre, xyz2, eps):
        xyz2 = xyz2 + eps
        from rgbd360_tpu.ops.plane_stats import _eigh3x3

        def one(labels, xyz):
            valid_xyz = jnp.all(jnp.isfinite(xyz), axis=-1)
            p = jnp.where(valid_xyz[..., None], xyz, 0.0)
            labf = labels.reshape(-1)
            bin_ = jnp.where(labf >= 0, labf, hw)
            pf = p.reshape(-1, 3)
            featm = jnp.concatenate([pf, jnp.ones((hw, 1), jnp.float32)], axis=-1)
            sums = jnp.zeros((hw + 1, 4), jnp.float32).at[bin_].add(featm)
            cnt = sums[:, 3]
            centroid = sums[:, :3] / jnp.maximum(cnt[:, None], 1.0)
            d = pf - jnp.take(centroid, bin_, axis=0)
            d = jnp.where((labf >= 0)[:, None], d, 0.0)
            prods = jnp.stack(
                [
                    d[:, 0] * d[:, 0], d[:, 0] * d[:, 1], d[:, 0] * d[:, 2],
                    d[:, 1] * d[:, 1], d[:, 1] * d[:, 2], d[:, 2] * d[:, 2],
                ],
                axis=-1,
            )
            s2 = jnp.zeros((hw + 1, 6), jnp.float32).at[bin_].add(prods)
            s2 = s2 / jnp.maximum(cnt[:, None], 1.0)
            cov = jnp.stack(
                [
                    jnp.stack([s2[:, 0], s2[:, 1], s2[:, 2]], axis=-1),
                    jnp.stack([s2[:, 1], s2[:, 3], s2[:, 4]], axis=-1),
                    jnp.stack([s2[:, 2], s2[:, 4], s2[:, 5]], axis=-1),
                ],
                axis=-2,
            )
            _, n_min = _eigh3x3(cov)
            return jnp.nansum(n_min) + jnp.sum(cnt)

        return jnp.sum(jax.vmap(one)(labels_pre, xyz2)).astype(jnp.float32)

    timed("refine_model", f_refine_model, labels_pre, xyz2)

    for sweeps in (1, 8):
        def f_refine_k(labels_pre, xyz2, normals, eps, _s=sweeps):
            xyz2 = xyz2 + eps
            out = jax.vmap(
                lambda l, x, n: refine_plane_labels(l, x, n, max_sweeps=_s)
            )(labels_pre, xyz2, normals)
            return jnp.sum(out).astype(jnp.float32)

        timed(f"refine_k{sweeps}", f_refine_k, labels_pre, xyz2, normals)

    def f_refine_full(labels_pre, xyz2, normals, eps):
        xyz2 = xyz2 + eps
        out = jax.vmap(refine_plane_labels)(labels_pre, xyz2, normals)
        return jnp.sum(out).astype(jnp.float32)

    timed("refine_full", f_refine_full, labels_pre, xyz2, normals)

    def f_segment(xyz2, normals, eps):
        xyz2 = xyz2 + eps
        out = jax.vmap(segment_planes)(xyz2, normals)
        return jnp.sum(out).astype(jnp.float32)

    timed("segment", f_segment, xyz2, normals)


def more():
    """Second battery: refine-model sub-stages, the K'-slot rebin variant,
    and the stacked (2-scan) segment variant. Run via --more."""
    import jax
    import jax.numpy as jnp

    from rgbd360_tpu.ops.bilateral import fast_bilateral_z
    from rgbd360_tpu.ops.normals import organized_normals
    from rgbd360_tpu.ops.pinhole import backproject_organized, downsample_median2
    from rgbd360_tpu.ops.planes_seg import refine_plane_labels, segment_planes
    from rgbd360_tpu.ops.plane_stats import _eigh3x3

    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--more", action="store_true")
    args = ap.parse_args()

    depth, rgb = _frame_inputs()

    @jax.jit
    def prep(depth, rgb):
        def one(d, rgb_s):
            xyz = backproject_organized(d)
            xyz2, rgb2 = downsample_median2(xyz, rgb_s)
            zf = fast_bilateral_z(xyz2[..., 2])
            xyz2 = jnp.concatenate([xyz2[..., :2], zf[..., None]], axis=-1)
            normals = organized_normals(xyz2)
            labels_pre = segment_planes(xyz2, normals)
            return xyz2, normals, labels_pre

        return jax.vmap(one)(depth, rgb)

    xyz2, normals, labels_pre = jax.tree_util.tree_map(jnp.asarray, prep(depth, rgb))
    h, w = labels_pre.shape[1:]
    hw = h * w

    timed = _make_timed(args.k)

    # ---- refine-model sub-stages (full-hw bins, the shipped form) --------
    def upto_model(stage):
        def f(labels_pre, xyz2, eps):
            xyz2 = xyz2 + eps

            def one(labels, xyz):
                valid_xyz = jnp.all(jnp.isfinite(xyz), axis=-1)
                p = jnp.where(valid_xyz[..., None], xyz, 0.0)
                labf = labels.reshape(-1)
                bin_ = jnp.where(labf >= 0, labf, hw)
                pf = p.reshape(-1, 3)
                featm = jnp.concatenate(
                    [pf, jnp.ones((hw, 1), jnp.float32)], axis=-1
                )
                sums = jnp.zeros((hw + 1, 4), jnp.float32).at[bin_].add(featm)
                cnt = sums[:, 3]
                out = jnp.sum(cnt)
                if stage >= 1:
                    centroid = sums[:, :3] / jnp.maximum(cnt[:, None], 1.0)
                    d = pf - jnp.take(centroid, bin_, axis=0)
                    d = jnp.where((labf >= 0)[:, None], d, 0.0)
                    out = out + jnp.sum(d)
                if stage >= 2:
                    prods = jnp.stack(
                        [
                            d[:, 0] * d[:, 0], d[:, 0] * d[:, 1],
                            d[:, 0] * d[:, 2], d[:, 1] * d[:, 1],
                            d[:, 1] * d[:, 2], d[:, 2] * d[:, 2],
                        ],
                        axis=-1,
                    )
                    s2 = jnp.zeros((hw + 1, 6), jnp.float32).at[bin_].add(prods)
                    out = out + jnp.sum(s2)
                if stage >= 3:
                    s2n = s2 / jnp.maximum(cnt[:, None], 1.0)
                    cov = jnp.stack(
                        [
                            jnp.stack([s2n[:, 0], s2n[:, 1], s2n[:, 2]], axis=-1),
                            jnp.stack([s2n[:, 1], s2n[:, 3], s2n[:, 4]], axis=-1),
                            jnp.stack([s2n[:, 2], s2n[:, 4], s2n[:, 5]], axis=-1),
                        ],
                        axis=-2,
                    )
                    _, n_min = _eigh3x3(cov)
                    out = out + jnp.nansum(n_min)
                return out

            return jnp.sum(jax.vmap(one)(labels_pre, xyz2)).astype(jnp.float32)

        return f

    for s, nm in [(0, "m0 s1-scatter"), (1, "m1 +cgather"), (2, "m2 +s2-scatter"), (3, "m3 +eigh")]:
        timed(nm, upto_model(s), labels_pre, xyz2)

    # ---- K'-slot rebin variant (K'=256 >= hw/min_inliers: ALL possible
    # model regions fit, so the result set is identical) -------------------
    KP = 256

    def f_model_rebin(labels_pre, xyz2, eps):
        xyz2 = xyz2 + eps

        def one(labels, xyz):
            valid_xyz = jnp.all(jnp.isfinite(xyz), axis=-1)
            p = jnp.where(valid_xyz[..., None], xyz, 0.0)
            labf = labels.reshape(-1)
            bin_ = jnp.where(labf >= 0, labf, hw)
            pf = p.reshape(-1, 3)
            featm = jnp.concatenate([pf, jnp.ones((hw, 1), jnp.float32)], axis=-1)
            sums = jnp.zeros((hw + 1, 4), jnp.float32).at[bin_].add(featm)
            cnt_all = sums[:hw, 3]
            topc, topi = jax.lax.top_k(cnt_all, KP)
            inv = jnp.full((hw + 1,), KP, jnp.int32).at[topi].set(
                jnp.arange(KP, dtype=jnp.int32)
            )
            pix_k = jnp.take(inv, bin_)
            centroid = sums[topi, :3] / jnp.maximum(topc[:, None], 1.0)
            cpad = jnp.concatenate([centroid, jnp.zeros((1, 3), jnp.float32)], axis=0)
            d = pf - jnp.take(cpad, pix_k, axis=0)
            d = jnp.where(((labf >= 0) & (pix_k < KP))[:, None], d, 0.0)
            prods = jnp.stack(
                [
                    d[:, 0] * d[:, 0], d[:, 0] * d[:, 1], d[:, 0] * d[:, 2],
                    d[:, 1] * d[:, 1], d[:, 1] * d[:, 2], d[:, 2] * d[:, 2],
                ],
                axis=-1,
            )
            s2 = jnp.zeros((KP + 1, 6), jnp.float32).at[pix_k].add(prods)[:KP]
            s2 = s2 / jnp.maximum(topc[:, None], 1.0)
            cov = jnp.stack(
                [
                    jnp.stack([s2[:, 0], s2[:, 1], s2[:, 2]], axis=-1),
                    jnp.stack([s2[:, 1], s2[:, 3], s2[:, 4]], axis=-1),
                    jnp.stack([s2[:, 2], s2[:, 4], s2[:, 5]], axis=-1),
                ],
                axis=-2,
            )
            _, n_min = _eigh3x3(cov)
            return jnp.sum(topc) + jnp.nansum(n_min)

        return jnp.sum(jax.vmap(one)(labels_pre, xyz2)).astype(jnp.float32)

    timed("model_rebin256", f_model_rebin, labels_pre, xyz2)

    # ---- stacked-scan segment variant ------------------------------------
    from rgbd360_tpu.ops import planes_seg as _ps

    def f_segment_stacked(xyz2, normals, eps):
        xyz2 = xyz2 + eps

        def one(xyz, nrm):
            return _segment_planes_stacked(xyz, nrm)

        return jnp.sum(jax.vmap(one)(xyz2, normals)).astype(jnp.float32)

    def _segment_planes_stacked(xyz, nrm):
        """segment_planes with the 4 directional segmented scans folded into
        2 by stacking the forward and flipped copies along a batch axis —
        the op count halves and the array size doubles (free when
        op-issue-bound)."""
        h_, w_ = xyz.shape[:2]
        valid = jnp.all(jnp.isfinite(xyz), axis=-1) & jnp.all(
            jnp.isfinite(nrm), axis=-1
        )
        n = jnp.where(valid[..., None], nrm, 0.0)
        p = jnp.where(valid[..., None], xyz, 0.0)
        d = jnp.sum(n * p, axis=-1)
        cos_thr = jnp.cos(_ps.ANGULAR_THRESHOLD)

        def connected(sl_a, sl_b):
            dot = jnp.sum(sl_a[0] * sl_b[0], axis=-1)
            return (
                sl_a[2]
                & sl_b[2]
                & (dot > cos_thr)
                & (jnp.abs(sl_a[1] - sl_b[1]) < _ps.DISTANCE_THRESHOLD)
            )

        a = (n, d, valid)
        right = jnp.zeros((h_, w_), bool).at[:, :-1].set(
            connected(tuple(x[:, :-1] for x in a), tuple(x[:, 1:] for x in a))
        )
        down = jnp.zeros((h_, w_), bool).at[:-1, :].set(
            connected(tuple(x[:-1, :] for x in a), tuple(x[1:, :] for x in a))
        )
        idx = jnp.arange(h_ * w_, dtype=jnp.int32).reshape(h_, w_)
        BIG = h_ * w_
        labels0 = jnp.where(valid, idx, BIG)

        false_col = jnp.zeros((h_, 1), bool)
        false_row = jnp.zeros((1, w_), bool)
        conn_lr = jnp.concatenate([false_col, right[:, :-1]], axis=1)
        conn_rl = jnp.concatenate([right[:, :-1], false_col], axis=1)
        conn_ud = jnp.concatenate([false_row, down[:-1, :]], axis=0)
        conn_du = jnp.concatenate([down[:-1, :], false_row], axis=0)
        # stacked connectivity: row 0 forward, row 1 flipped
        conn_row = jnp.stack([conn_lr, conn_rl[:, ::-1]], axis=0)
        conn_col = jnp.stack([conn_ud, conn_du[::-1, :]], axis=0)

        def comb(x, y):
            vx, fx = x
            vy, fy = y
            return jnp.where(fy, jnp.minimum(vx, vy), vy), fx & fy

        def sweep(lab):
            st = jnp.stack([lab, lab[:, ::-1]], axis=0)
            v, _ = jax.lax.associative_scan(comb, (st, conn_row), axis=2)
            new = jnp.minimum(v[0], v[1][:, ::-1])
            st2 = jnp.stack([new, new[::-1, :]], axis=0)
            v2, _ = jax.lax.associative_scan(comb, (st2, conn_col), axis=1)
            new = jnp.minimum(v2[0], v2[1][::-1, :])
            return jnp.where(valid, new, BIG)

        def cond(state):
            labels, changed, it = state
            return changed & (it < h_ * w_)

        def body(state):
            labels, _, it = state
            new = sweep(labels)
            return new, jnp.any(new != labels), it + 1

        labels, _, _ = jax.lax.while_loop(
            cond, body, (labels0, jnp.bool_(True), jnp.int32(0))
        )
        return jnp.where(valid, labels, -1)

    timed("segment_stacked", f_segment_stacked, xyz2, normals)

    # parity: stacked vs shipped fixed point
    ref_lab = np.asarray(jax.vmap(segment_planes)(xyz2, normals))
    new_lab = np.asarray(
        jax.vmap(lambda x, n_: _segment_planes_stacked(x, n_))(xyz2, normals)
    )
    print("segment stacked parity:", bool((ref_lab == new_lab).all()))


if __name__ == "__main__":
    (more if "--more" in sys.argv else main)()
