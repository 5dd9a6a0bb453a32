"""Calibration container for the 8-sensor omnidirectional rig.

Mirrors the reference Calib360 (include/Calib360.h): per-sensor CLAMS
intrinsic depth-distortion models and extrinsic 4x4 poses, plus the shared
QVGA pinhole camera matrix. All arrays are NumPy on the host; device copies
are made by the ops that consume them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from rgbd360_tpu.io.clams import DepthDistortionModel, load_clams_model

NUM_SENSORS = 8


def qvga_camera_matrix() -> np.ndarray:
    """Pinhole intrinsics at QVGA (reference include/Calib360.h:74-77)."""
    return np.array(
        [[262.5, 0.0, 159.5], [0.0, 262.5, 119.5], [0.0, 0.0, 1.0]], np.float32
    )


class Calib360:
    def __init__(self) -> None:
        self.camera_matrix = qvga_camera_matrix()
        self.Rt = np.tile(np.eye(4, dtype=np.float32), (NUM_SENSORS, 1, 1))
        self.Rt_inv = np.tile(np.eye(4, dtype=np.float32), (NUM_SENSORS, 1, 1))
        self.intrinsic_model: List[Optional[DepthDistortionModel]] = [None] * NUM_SENSORS
        self._device_cache = {}

    # -- loading ------------------------------------------------------------
    def load_extrinsic_calibration(self, path: str) -> None:
        """Load Rt_01.txt..Rt_08.txt (reference include/Calib360.h:122-131)."""
        for sensor_id in range(NUM_SENSORS):
            fname = os.path.join(path, f"Rt_0{sensor_id + 1}.txt")
            self.Rt[sensor_id] = np.loadtxt(fname, dtype=np.float64).astype(np.float32)
            self.Rt_inv[sensor_id] = np.linalg.inv(
                self.Rt[sensor_id].astype(np.float64)
            ).astype(np.float32)
        self._device_cache.clear()

    def load_intrinsic_calibration(self, path: str, downsample: int = 2) -> None:
        """Load distortion_model1..8 and downsample to QVGA
        (reference include/Calib360.h:104-119)."""
        for sensor_id in range(NUM_SENSORS):
            model = load_clams_model(os.path.join(path, f"distortion_model{sensor_id + 1}"))
            self.intrinsic_model[sensor_id] = model.downsample_params(downsample)
        self._device_cache.clear()

    # -- cached device copies ------------------------------------------------
    # The calibration is constant across a run, but jnp.asarray(np_array) at
    # a call site re-uploads on EVERY call, 3-4 times per frame on the
    # undistort/stitch path.
    # Mutating Rt/Rt_inv/intrinsic_model in place after first device use is
    # not supported; the load_* methods invalidate the cache.
    def _device(self, key: str, make):
        if key not in self._device_cache:
            self._device_cache[key] = make()
        return self._device_cache[key]

    def device_intrinsic_arrays(self):
        """(multipliers, counts) as device arrays + the shared geometry."""

        def make():
            import jax.numpy as jnp

            mults, counts, geom = self.stacked_intrinsic_arrays()
            return jnp.asarray(mults), jnp.asarray(counts), geom

        return self._device("intrinsics", make)

    def device_extrinsic_arrays(self):
        """(Rt, Rt_inv, camera_matrix) as device arrays."""

        def make():
            import jax.numpy as jnp

            return (
                jnp.asarray(self.Rt),
                jnp.asarray(self.Rt_inv),
                jnp.asarray(self.camera_matrix),
            )

        return self._device("extrinsics", make)

    @classmethod
    def load(
        cls,
        root: str,
        with_intrinsics: bool = True,
        with_extrinsics: bool = True,
    ) -> "Calib360":
        """Load from a reference-layout data root (Calibration/{Intrinsics,Extrinsics})."""
        calib = cls()
        if with_extrinsics:
            calib.load_extrinsic_calibration(os.path.join(root, "Calibration", "Extrinsics"))
        if with_intrinsics:
            calib.load_intrinsic_calibration(os.path.join(root, "Calibration", "Intrinsics"))
        return calib

    # -- batched views for device kernels -----------------------------------
    def stacked_intrinsic_arrays(self):
        """Return (multipliers, counts) stacked over sensors:
        (8, num_bins_y, num_bins_x, n_depth) each, plus the shared geometry."""
        models = [m for m in self.intrinsic_model if m is not None]
        assert len(models) == NUM_SENSORS, "intrinsic models not loaded"
        for m in models[1:]:
            # the batched undistort kernel applies models[0]'s binning to all
            # sensors — mixed geometries would be silently wrong
            assert (m.bin_width, m.bin_height, m.bin_depth) == (
                models[0].bin_width, models[0].bin_height, models[0].bin_depth,
            ), "distortion models disagree on bin geometry"
        mults = np.stack([m.multipliers for m in models])
        counts = np.stack([m.counts for m in models])
        return mults, counts, models[0]
