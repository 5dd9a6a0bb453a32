"""Frame360 — the omnidirectional RGB-D frame.

Mirrors the reference public API (include/Frame360.h): loadFrame, undistort,
stitchSphericalImage, buildSphereCloud_fromImage, getPlanes, serialize. The
per-sensor OpenMP fan-out of the reference becomes a batch dimension of size
8 inside single fused device kernels.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.io.boost_archive import RawFrame360, read_frame360_bin, write_frame360_bin
from rgbd360_tpu.io.calib import Calib360
from rgbd360_tpu.ops.image import gray_f32
from rgbd360_tpu.ops.sphere import sphere_cloud_from_image
from rgbd360_tpu.ops.stitch import stitch_spherical
from rgbd360_tpu.ops.undistort import undistort_depth_mm
from rgbd360_tpu.utils.timing import stage

import jax as _jax


@_jax.jit
def _depth_mm_to_m(depth_raw_mm: jnp.ndarray) -> jnp.ndarray:
    return depth_raw_mm.astype(jnp.float32) * 0.001


class Frame360:
    """One spherical capture: 8 raw RGB-D images -> panorama -> cloud/planes."""

    def __init__(self, calib: Calib360, frame_id: int = 0):
        self.calib = calib
        self.id = frame_id
        self.node = 0
        self.pose = np.eye(4, dtype=np.float32)
        self.timestamp = 0

        self.rgb: Optional[jnp.ndarray] = None  # (8,H,W,3) u8 BGR
        self.depth_raw_mm: Optional[jnp.ndarray] = None  # (8,H,W) u16
        self._depth_undistorted_m: Optional[jnp.ndarray] = None  # (8,H,W) f32
        self.sphere_rgb: Optional[jnp.ndarray] = None  # (320,1920,3) u8 BGR
        self.sphere_depth_mm: Optional[jnp.ndarray] = None  # (320,1920) u16
        self.sphere_gray: Optional[jnp.ndarray] = None  # (320,1920) f32 [0,1]
        self.sphere_cloud = None  # (xyz, rgb) from buildSphereCloud_fromImage
        self.planes = None  # PbMap (set by getPlanes)
        self.local_planes = None

    # -- acquisition / io ---------------------------------------------------
    def load_frame(self, path: str) -> None:
        """Load the 8-sensor raw capture (reference include/Frame360.h:231-266)."""
        with stage("Frame360.loadFrame"):
            raw = read_frame360_bin(path)
            self.set_raw(raw)

    def set_raw(self, raw: RawFrame360) -> None:
        self.rgb = jnp.asarray(raw.rgb)
        self.depth_raw_mm = jnp.asarray(raw.depth)
        self._depth_undistorted_m = None  # lazy (see depth_undistorted_m)
        self.timestamp = raw.timestamp

    @property
    def depth_undistorted_m(self) -> Optional[jnp.ndarray]:
        """Metric per-sensor depth: the CLAMS-undistorted field once
        undistort() has run, else the plain loadDepthEigen u16-mm -> f32-m
        conversion (CloudRGBD_Ext.h:64-76) — computed lazily because the app
        flows always call undistort(), whose output replaces it, so an
        eager conversion in set_raw would be a wasted device dispatch."""
        if self._depth_undistorted_m is None and self.depth_raw_mm is not None:
            self._depth_undistorted_m = _depth_mm_to_m(self.depth_raw_mm)
        return self._depth_undistorted_m

    @depth_undistorted_m.setter
    def depth_undistorted_m(self, value) -> None:
        self._depth_undistorted_m = value

    def serialize(self, path: str) -> None:
        """Write the reference-compatible .bin (include/Frame360.h:333-345)."""
        write_frame360_bin(
            path,
            RawFrame360(
                rgb=np.asarray(self.rgb),
                depth=np.asarray(self.depth_raw_mm),
                timestamp=self.timestamp,
            ),
        )

    # -- device pipeline ----------------------------------------------------
    def undistort(self) -> None:
        """CLAMS depth undistortion of all 8 sensors in one batched kernel
        (reference include/Frame360.h:293-310). Note: like the reference,
        this updates only the metric depth used for point clouds — the raw
        u16 depth consumed by the stitcher stays distorted (the eigen2cv
        write-back at Frame360.h:302 is commented out)."""
        with stage("Frame360.undistort"):
            # cached device calib + in-jit u16->metres conversion: one
            # dispatch, no per-frame calibration upload
            mults, counts, geom = self.calib.device_intrinsic_arrays()
            self.depth_undistorted_m = undistort_depth_mm(
                self.depth_raw_mm,
                mults,
                counts,
                bin_width=geom.bin_width,
                bin_height=geom.bin_height,
                bin_depth=geom.bin_depth,
            )

    def stitch_spherical_image(self) -> None:
        """Build the 1920x320 spherical RGB-D panorama
        (reference include/Frame360.h:386-405)."""
        with stage("Frame360.stitchSphericalImage"):
            _rt, rt_inv, cam = self.calib.device_extrinsic_arrays()
            self.sphere_rgb, self.sphere_depth_mm = stitch_spherical(
                self.rgb,
                self.depth_raw_mm,
                rt_inv,
                cam,
            )
            self.sphere_gray = gray_f32(self.sphere_rgb)

    def build_device_fused(self, ship_labels: bool = False):
        """Run the whole per-frame device pipeline (CLAMS undistort +
        spherical stitch + gray + plane-stats) as ONE jitted program and
        return the (device) plane-stats buffer; sphere_rgb/sphere_depth_mm/
        sphere_gray/depth_undistorted_m are set from the program outputs.
        The SLAM planes_pipeline uses this on deferred-build frames — one
        dispatch instead of 3-4 per frame."""
        from rgbd360_tpu.core.plane_extraction import fused_frame_program

        with stage("Frame360.build_device_fused"):
            mults, counts, geom = self.calib.device_intrinsic_arrays()
            _rt, rt_inv, cam = self.calib.device_extrinsic_arrays()
            (
                self.sphere_rgb,
                self.sphere_depth_mm,
                self.sphere_gray,
                self._depth_undistorted_m,
                stats,
            ) = fused_frame_program(
                self.rgb,
                self.depth_raw_mm,
                mults,
                counts,
                rt_inv,
                cam,
                ship_labels=ship_labels,
                bin_width=geom.bin_width,
                bin_height=geom.bin_height,
                bin_depth=geom.bin_depth,
            )
        return stats

    def build_sphere_cloud_from_image(self):
        """Spherical point cloud from the stitched panorama
        (reference include/Frame360.h:555-612)."""
        assert self.sphere_rgb is not None, "stitch_spherical_image() first"
        depth_m = self.sphere_depth_mm.astype(jnp.float32) * 0.001
        self.sphere_cloud = sphere_cloud_from_image(self.sphere_rgb, depth_m)
        return self.sphere_cloud

    def build_sphere_cloud(self):
        """Rig-frame point cloud from the 8 undistorted, downsampled,
        bilateral-filtered sensor clouds (reference include/Frame360.h:467-519
        buildSphereCloud): returns (xyz (8*19200, 3), rgb) with per-sensor
        blocks transformed by their extrinsics and concatenated."""
        from rgbd360_tpu.core.plane_extraction import build_sensor_clouds

        xyz, rgb2, _, _ = build_sensor_clouds(self.depth_undistorted_m, self.rgb)
        xyz = np.asarray(xyz)  # (8, h, w, 3) sensor frames
        rgb2 = np.asarray(rgb2)
        out = np.empty((8, xyz.shape[1] * xyz.shape[2], 3), np.float32)
        for s in range(8):
            rt = self.calib.Rt[s].astype(np.float64)
            pts = xyz[s].reshape(-1, 3)
            out[s] = (pts @ rt[:3, :3].T + rt[:3, 3]).astype(np.float32)
        self.sphere_cloud = (out.reshape(-1, 3), rgb2[..., ::-1].reshape(-1, 3))
        return self.sphere_cloud

    def build_sphere_cloud_fast(self):
        """buildSphereCloud_fast (reference include/Frame360.h:522-552):
        per-sensor undistorted backprojection transformed by the extrinsics
        and concatenated — no downsampling, no bilateral filter. One batched
        device op + an einsum over the 8 extrinsics."""
        import jax

        from rgbd360_tpu.ops.pinhole import backproject_organized

        xyz = jax.vmap(backproject_organized)(self.depth_undistorted_m)  # (8,H,W,3)
        rt = jnp.asarray(np.stack([self.calib.Rt[s] for s in range(8)]), jnp.float32)
        pts = jnp.einsum("sij,shwj->shwi", rt[:, :3, :3], xyz) + rt[:, None, None, :3, 3]
        rgb = np.asarray(self.rgb)[..., ::-1]  # BGR -> RGB
        self.sphere_cloud = (
            np.asarray(pts).reshape(-1, 3),
            rgb.reshape(-1, 3),
        )
        return self.sphere_cloud

    def get_planes(self, need_inliers: bool = True):
        """Segment + merge the planar patches of the spherical frame
        (reference include/Frame360.h:615-638). Implemented in core/pbmap.py;
        bound lazily to avoid importing the plane stack for dense-only use.
        need_inliers=False skips shipping per-pixel labels off-device
        (Plane.inliers stays None) — the faster SLAM-loop configuration."""
        from rgbd360_tpu.core.plane_extraction import extract_frame_planes

        with stage("Frame360.getPlanes (segmentation)"):
            self.planes, self.local_planes = extract_frame_planes(
                self, need_inliers=need_inliers
            )
        return self.planes

    def get_planar_area(self) -> float:
        if self.planes is None:
            return 0.0
        return float(sum(p.area_hull for p in self.planes.planes))

    # -- keyframe persistence (reference Frame360.h:213-228, 313-330) --------
    def save_planes(self, path: str) -> None:
        """savePlanes: persist the PbMap (reference Frame360.h:321-327)."""
        from rgbd360_tpu.core.pbmap import save_pbmap

        assert self.planes is not None, "get_planes() first"
        save_pbmap(self.planes, path)

    def save(self, path: str, frame: int) -> None:
        """Save the keyframe as sphereCloud_%d.pcd + spherePlanes_%d.pbmap.npz
        (reference Frame360::save, Frame360.h:313-330), plus the stitched
        panorama (panorama_%d.npz — an extension the reference lacks; without
        it a reloaded keyframe cannot serve dense re-registration)."""
        import os

        from rgbd360_tpu.utils.viz import save_pcd

        # the keyframe cloud is ALWAYS the panorama backprojection — never a
        # cached rig-frame cloud from build_sphere_cloud()/..._fast(), whose
        # shapes and frames differ (a stale cache here once poisoned reloads)
        depth_m = self.sphere_depth_mm.astype(jnp.float32) * 0.001
        xyz, rgb = sphere_cloud_from_image(self.sphere_rgb, depth_m)
        h, w = self.sphere_depth_mm.shape
        save_pcd(
            os.path.join(path, f"sphereCloud_{frame}.pcd"),
            # keep NaNs: they mark invalid pixels and round-trip through the
            # ASCII PCD; flattening them to (0,0,0) would reload hundreds of
            # thousands of fake origin points into the keyframe cloud
            np.asarray(xyz).reshape(-1, 3),
            np.asarray(rgb).reshape(-1, 3),
            organized_shape=(h, w),  # the reference writes the organized cloud
        )
        self.save_planes(os.path.join(path, f"spherePlanes_{frame}.pbmap.npz"))
        np.savez_compressed(
            os.path.join(path, f"panorama_{frame}.npz"),
            sphere_rgb=np.asarray(self.sphere_rgb),
            sphere_depth_mm=np.asarray(self.sphere_depth_mm),
            pose=self.pose,
            node=self.node,
            timestamp=self.timestamp,
        )

    @classmethod
    def load_keyframe(cls, calib: Calib360, path: str, frame: int) -> "Frame360":
        """Reload a saved keyframe (reference load_PbMap_Cloud,
        Frame360.h:213-228, extended with the panorama so the keyframe can
        re-enter tracking/loop-closure/relocalization after a restart)."""
        import os

        from rgbd360_tpu.core.pbmap import load_pbmap
        from rgbd360_tpu.utils.viz import load_pcd

        kf = cls(calib, frame)
        xyz, rgb = load_pcd(os.path.join(path, f"sphereCloud_{frame}.pcd"))
        kf.sphere_cloud = (xyz, rgb)
        kf.planes = load_pbmap(os.path.join(path, f"spherePlanes_{frame}.pbmap.npz"))
        pano_path = os.path.join(path, f"panorama_{frame}.npz")
        if os.path.exists(pano_path):
            with np.load(pano_path) as z:
                kf.sphere_rgb = jnp.asarray(z["sphere_rgb"])
                kf.sphere_depth_mm = jnp.asarray(z["sphere_depth_mm"])
                kf.pose = z["pose"]
                kf.node = int(z["node"])
                kf.timestamp = int(z["timestamp"])
            kf.sphere_gray = gray_f32(kf.sphere_rgb)
        return kf

    # -- convenience --------------------------------------------------------
    def build(self, path: str) -> "Frame360":
        """load + undistort + stitch: the standard per-frame pipeline."""
        self.load_frame(path)
        self.undistort()
        self.stitch_spherical_image()
        return self
