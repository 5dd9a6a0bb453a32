"""RegisterPhotoICP — OO facade over the dense aligner, mirroring the
reference public API (include/RegisterPhotoICP.h:480-4800: setSourceFrame,
setTargetFrame, alignFrames360, getOptimalPose, getHessian, getGradient,
calcEntropy, SSO, avPhotoResidual, avDepthResidual).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.ops import photoicp

PHOTO_CONSISTENCY = photoicp.PHOTO_CONSISTENCY
DEPTH_CONSISTENCY = photoicp.DEPTH_CONSISTENCY
PHOTO_DEPTH = photoicp.PHOTO_DEPTH


class RegisterPhotoICP:
    # pyramids cached per (frame arrays identity, role): the SLAM tracking
    # loop re-sets the same target keyframe panorama up to 5 times per frame
    # and the same source frame per attempt — each set was a fresh
    # host->device upload + pyramid dispatch. Entries hold strong references to the key arrays, so `is`
    # identity stays valid; keyframe panoramas are never mutated in place.
    _PYR_CACHE_SIZE = 8

    def __init__(self, n_pyr_levels: int = 4):
        self.n_pyr_levels = n_pyr_levels
        self.min_depth = photoicp.MIN_DEPTH
        self.max_depth = photoicp.MAX_DEPTH
        self._src = None  # pyramid tuples
        self._trg = None
        self._result: Optional[photoicp.AlignResult] = None
        self._flat = None  # device (K,) f32: every host-consumed output
        self._host: Optional[dict] = None  # unpacked copy of _flat
        self._pyr_cache = []  # [(rgb, depth, is_target, n_levels, pyramids)]

    # -- reference API --------------------------------------------------------
    def set_num_pyr(self, n: int) -> None:
        self.n_pyr_levels = n
        self._src = self._trg = None

    def _pyramids(self, rgb_bgr_u8, depth, is_target: bool):
        for i, entry in enumerate(self._pyr_cache):
            if (
                entry[0] is rgb_bgr_u8
                and entry[1] is depth
                and entry[2] == is_target
                and entry[3] == self.n_pyr_levels
            ):
                # LRU, not FIFO: the tracked keyframe's target pyramids are
                # hit every frame while one-shot source entries go cold — a
                # FIFO pop(0) would evict exactly the hottest entry every
                # _PYR_CACHE_SIZE inserts
                self._pyr_cache.append(self._pyr_cache.pop(i))
                return entry[4]
        # ONE jit call on the raw arrays: gray conversion and mm->m run
        # inside the jit, and host (numpy) operands upload with the call
        pyr = photoicp.build_pyramid_set_raw_jit(
            rgb_bgr_u8, depth, self.n_pyr_levels,
            is_target=is_target, sphere_seam_mask=True,
        )
        self._pyr_cache.append((rgb_bgr_u8, depth, is_target, self.n_pyr_levels, pyr))
        if len(self._pyr_cache) > self._PYR_CACHE_SIZE:
            self._pyr_cache.pop(0)
        return pyr

    def set_source_frame(self, rgb_bgr_u8, depth) -> None:
        """Contract: the arrays must not be mutated in place after this call.
        Pyramids are cached by array IDENTITY (`is`), so re-filling the same
        host buffer (e.g. a streaming capture ring) and re-setting it would
        silently reuse the stale pyramids — pass a fresh array per frame
        (jnp arrays and freshly-decoded numpy frames, as all in-repo callers
        do, satisfy this for free)."""
        self._src = self._pyramids(rgb_bgr_u8, depth, is_target=False)

    def set_target_frame(self, rgb_bgr_u8, depth) -> None:
        """Same no-in-place-mutation contract as set_source_frame."""
        self._trg = self._pyramids(rgb_bgr_u8, depth, is_target=True)

    def align_frames360(
        self,
        pose_guess: Optional[np.ndarray] = None,
        method: int = PHOTO_CONSISTENCY,
        occlusion: int = 0,
    ) -> np.ndarray:
        """occlusion: 0 plain, 1 z-buffered (Occ1), 2 +dynamic-occlusion (Occ2),
        mirroring the reference parameter (RegisterPhotoICP.h:4519)."""
        from rgbd360_tpu.utils.timing import stage

        with stage(
            # sync through _fetch so the packed vector is transferred ONCE
            # and cached — a bare np.asarray here would discard the copy and
            # the accessor below would transfer it a second time
            "Dense alignment 360",
            sync=lambda: self._fetch() if self._flat is not None else None,
        ):
            # one body: the synchronous path IS dispatch + fetch
            self.dispatch_frames360(pose_guess, method, occlusion=occlusion)
        return self.get_optimal_pose()

    def dispatch_frames360(
        self,
        pose_guess: Optional[np.ndarray] = None,
        method: int = PHOTO_CONSISTENCY,
        occlusion: int = 0,
    ) -> None:
        """align_frames360 without the trailing result fetch: dispatch the
        device program and enqueue the (tiny) packed-result transfer, then
        return immediately. Accessors fetch lazily as usual — callers use
        this to overlap the alignment with host work (the SLAM loop
        dispatches the tracking alignment while the plane-stats transfer
        and host fit of the same frame still run)."""
        assert self._src is not None and self._trg is not None, "set frames first"
        guess = np.asarray(
            pose_guess if pose_guess is not None else np.eye(4), dtype=np.float32
        )
        self._result, self._flat = photoicp.align_frames360_packed(
            self._src, self._trg, guess, method, occlusion=occlusion,
        )
        self._host = None
        try:
            # enqueue the D2H copy right behind the align program so the
            # later _fetch doesn't queue behind newer dispatches
            self._flat.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

    def prewarm(
        self,
        method: int = PHOTO_DEPTH,
        occlusion: int = 0,
        background: bool = True,
    ):
        """Force trace + compile (or cached-executable load) of the
        pyramid-build and alignment programs for the standard 320x1920
        panorama, on a daemon thread by default. Streaming apps call this at
        startup so the compile overlaps the first frames' plane-stack warmup
        instead of stalling the first keyframe. Best-effort: failures
        surface on the real call."""

        def _go():
            try:
                # the EXACT production signature: _pyramids calls
                # build_pyramid_set_raw_jit on the u8 panorama + u16-mm
                # depth — warming any other dtype/entry compiles a program
                # the real path never runs and leaves the first keyframe's
                # trace/compile on the critical path
                rgb = jnp.zeros((320, 1920, 3), jnp.uint8)
                depth = jnp.full((320, 1920), 2000, jnp.uint16)
                src = photoicp.build_pyramid_set_raw_jit(
                    rgb, depth, self.n_pyr_levels, is_target=False, sphere_seam_mask=True
                )
                trg = photoicp.build_pyramid_set_raw_jit(
                    rgb, depth, self.n_pyr_levels, is_target=True, sphere_seam_mask=True
                )
                _res, flat = photoicp.align_frames360_packed(
                    src, trg, np.eye(4, dtype=np.float32), method,
                    occlusion=occlusion,
                )
                flat.block_until_ready()
            except Exception:
                pass

        if background:
            import threading

            t = threading.Thread(target=_go, daemon=True, name="photoicp-prewarm")
            t.start()
            return t
        _go()
        return None

    # -- accessors -------------------------------------------------------------
    # Every scalar/matrix accessor reads one host-side unpack of the packed
    # result vector — a SINGLE device->host transfer per alignment, however
    # many quantities the caller reads.
    @property
    def result(self) -> photoicp.AlignResult:
        assert self._result is not None, "align first"
        return self._result

    def _fetch(self) -> dict:
        assert self._flat is not None, "align first"
        if self._host is None:
            flat = np.asarray(self._flat)
            n = len(flat) - 63
            self._host = {
                "pose": flat[0:16].reshape(4, 4).copy(),
                "hessian": flat[16:52].reshape(6, 6).copy(),
                "gradient": flat[52:58].copy(),
                "error": float(flat[58]),
                "av_photo": float(flat[59]),
                "av_depth": float(flat[60]),
                "sso": float(flat[61]),
                "ill": bool(flat[62] != 0.0),
                "iters": flat[63 : 63 + n].astype(np.int32),
            }
        return self._host

    def get_optimal_pose(self) -> np.ndarray:
        return self._fetch()["pose"]

    def get_hessian(self) -> np.ndarray:
        return self._fetch()["hessian"]

    def get_gradient(self) -> np.ndarray:
        return self._fetch()["gradient"]

    def calc_entropy(self) -> float:
        """Kerl-IROS13 pose entropy (reference RegisterPhotoICP.h:4789-4797)
        from the host-cached Hessian — numpy, no eager device dispatch."""
        sign, logdet = np.linalg.slogdet(self._fetch()["hessian"].astype(np.float64))
        logdet = logdet if sign > 0 else -np.inf
        return float(0.5 * (6.0 * (1.0 + np.log(2.0 * np.pi)) - logdet))

    @property
    def sso(self) -> float:
        return self._fetch()["sso"]

    @property
    def av_photo_residual(self) -> float:
        return self._fetch()["av_photo"]

    @property
    def av_depth_residual(self) -> float:
        return self._fetch()["av_depth"]

    @property
    def ill_posed(self) -> bool:
        return self._fetch()["ill"]

    @property
    def num_iterations(self) -> np.ndarray:
        return self._fetch()["iters"]
