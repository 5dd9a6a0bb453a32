"""Frame360Stereo — spherical frames from a stereo panorama device
(reference include/Frame360_stereo.h): the RGB panorama arrives as a PNG and
the float depth panorama as a raw binary (u16 height, u16 width header then
height*width f32 values stored transposed, :268-315). The spherical cloud
uses the same backprojection convention as Frame360.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from rgbd360_tpu.core.frame360 import Frame360
from rgbd360_tpu.io.calib import Calib360
from rgbd360_tpu.ops.image import gray_f32


# stereo PCL segmentation configuration (Frame360_stereo.h:859-867)
_ANGULAR, _DIST, _MAX_DEPTH_CHANGE = 0.05, 0.05, 0.05


def _stereo_device_stats_impl(depth, rgb, start_phi, max_depth):
    """Device program for getPlanesStereo: backproject the organized stereo
    panorama, segment planes, reduce per-label stats. Module-level and
    jitted once so a per-frame call re-uses the compiled executable instead
    of re-tracing the program every frame."""
    from rgbd360_tpu.ops.normals import organized_normals
    from rgbd360_tpu.ops.plane_stats import sensor_plane_stats
    from rgbd360_tpu.ops.planes_seg import refine_plane_labels, segment_planes

    h, w = depth.shape
    step = 2.0 * jnp.pi / w
    phi = (jnp.arange(h, dtype=jnp.float32) + start_phi) * step - jnp.pi / 2
    theta = jnp.arange(w, dtype=jnp.float32) * step - jnp.pi
    cph, sph = jnp.cos(phi)[:, None], jnp.sin(phi)[:, None]
    sth, cth = jnp.sin(theta)[None, :], jnp.cos(theta)[None, :]
    valid = (depth > 0.0) & (depth < max_depth)
    d = jnp.where(valid, depth, jnp.nan)
    xyz = jnp.stack([sth * cph * d, sph * d, cth * cph * d], axis=-1)
    normals = organized_normals(xyz, max_depth_change=_MAX_DEPTH_CHANGE)
    labels_pre = segment_planes(
        xyz, normals, angular_threshold=_ANGULAR, distance_threshold=_DIST
    )
    # min_inliers=40: the stereo variant's acceptance threshold (:865) also
    # gates which regions may grow in the refinement
    labels = refine_plane_labels(
        labels_pre, xyz, normals, distance_threshold=_DIST, min_inliers=40
    )
    st = sensor_plane_stats(xyz, rgb, labels, labels_pre)
    return st, xyz


_stereo_device_stats = None  # jitted lazily: jax.jit at import time would
# bind the backend before tests can force the CPU platform


def _get_stereo_device_stats():
    global _stereo_device_stats
    if _stereo_device_stats is None:
        import jax

        _stereo_device_stats = jax.jit(_stereo_device_stats_impl)
    return _stereo_device_stats


def read_stereo_depth(path: str) -> np.ndarray:
    """Raw stereo depth panorama: [u16 h][u16 w][h*w f32 column-major]
    (reference Frame360_stereo.h:268-305) -> (h, w) f32 metres."""
    with open(path, "rb") as f:
        buf = f.read()
    h, w = struct.unpack("<HH", buf[:4])
    data = np.frombuffer(buf[4 : 4 + h * w * 4], np.float32)
    # stored as (w, h) then transposed by the reference
    return data.reshape(w, h).T.copy()


def write_stereo_depth(path: str, depth_m: np.ndarray) -> None:
    h, w = depth_m.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", h, w))
        f.write(np.ascontiguousarray(depth_m.T, np.float32).tobytes())


class Frame360Stereo(Frame360):
    """Frame360 whose panorama comes directly from files instead of the
    8-sensor stitcher."""

    def __init__(self, calib: Calib360 = None, frame_id: int = 0):
        super().__init__(calib or Calib360(), frame_id)

    def load_depth(self, path: str) -> None:
        depth_m = read_stereo_depth(path)
        self.sphere_depth_mm = jnp.asarray(
            np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
        )

    def load_rgb(self, path: str) -> None:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"))
        self.sphere_rgb = jnp.asarray(rgb[..., ::-1])  # keep BGR convention
        self.sphere_gray = gray_f32(self.sphere_rgb)

    def build_stereo(self, rgb_png: str, depth_bin: str) -> "Frame360Stereo":
        self.load_rgb(rgb_png)
        self.load_depth(depth_bin)
        return self

    def get_planes_stereo(self, start_phi: int = 166, max_depth: float = 15.0):
        """Plane segmentation over the stereo panorama cloud (reference
        Frame360_stereo.h:847-986 getPlanesStereo): the variant's own PCL
        configuration — maxDepthChange 0.05, smoothing 8, minInliers 40,
        angular threshold 0.05 rad, distance threshold 0.05 m (:859-867) —
        over the ORGANIZED stereo cloud, no per-sensor split, no rig
        transform; same area/elongation filters and local same-plane merge
        as Frame360 (:938-978). Sets and returns self.planes."""
        from rgbd360_tpu.config import default_params
        from rgbd360_tpu.core.pbmap import PbMap, Plane

        MIN_INLIERS_STEREO = 40  # :865

        import jax

        depth_m = self.sphere_depth_mm.astype(jnp.float32) * 1e-3
        st, xyz = _get_stereo_device_stats()(
            depth_m,
            self.sphere_rgb,
            jnp.float32(start_phi),
            jnp.float32(max_depth),
        )
        # ONE pytree fetch instead of a transfer per field
        st, xyz = jax.device_get((st, xyz))
        labels = st.labels
        cand = st.candidate
        xyzf = xyz.reshape(-1, 3)
        count = st.count
        mean = st.mean.astype(np.float64)
        cov = st.cov.astype(np.float64)
        normal = st.normal.astype(np.float64)
        curvature = st.curvature.astype(np.float64)
        hist = st.hist.astype(np.float64)
        sum_rgb = st.sum_rgb.astype(np.float64)
        label_id = st.label_id

        mean_pre = st.mean_pre.astype(np.float64)
        flat = labels.reshape(-1)
        candf = cand.reshape(-1)
        planes = []
        # ascending label order = PCL's region discovery (scan) order, the
        # order getPlanesStereo's loop visits regions in — the downstream
        # local_same_plane_merge absorbs into the FIRST earlier match, so
        # walking the count-sorted stat rows directly changed merge pairings
        # (same rationale as _planes_from_stats)
        for k in sorted(range(len(label_id)), key=lambda i: label_id[i]):
            n = int(count[k])
            if n < MIN_INLIERS_STEREO:
                continue  # rows are count-sorted, but we walk label order
            inl = np.flatnonzero(flat == label_id[k])
            plane = Plane(
                id=len(planes),
                # reported params are the segment-stage fit (PCL fits models
                # in segment(), before refinement — see SensorPlaneStats);
                # the refined-member centroid rides along as merge suffstats
                normal=normal[k].copy(),
                center=mean_pre[k].copy(),
                curvature=float(curvature[k]),
                inliers=inl,
                n_pts=n,
                cov=cov[k].copy(),
                ss_center=mean[k].copy(),
            )
            plane.compute_hull_area(xyzf[inl[candf[inl]]].astype(np.float64))
            if plane.area_hull < default_params.min_area_plane:  # :938
                continue
            plane.d = float(-plane.normal @ plane.center)
            if plane.elongation > default_params.max_elongation_plane:  # :945
                continue
            total = hist[k].sum()
            plane.hist_counts = hist[k].copy()
            plane.hist_h = hist[k] / total if total > 0 else hist[k]
            plane.main_color = sum_rgb[k] / max(n, 1) / 255.0
            planes.append(plane)

        # local same-plane merge (:959-978 — the same absorption loop as
        # getPlanesSensor's tail, shared with the main extraction path)
        from rgbd360_tpu.core.plane_extraction import local_same_plane_merge

        self.planes = PbMap(local_same_plane_merge(planes))
        return self.planes

    def build_sphere_cloud(self, start_phi: int = 166, max_depth: float = 15.0):
        """The stereo variant's own spherical backprojection (reference
        Frame360_stereo.h:454-517): a different convention from Frame360 —
        phi = (row + start_phi) * step - pi/2, theta = col * step - pi,
        x = sin(theta) cos(phi) d, y = sin(phi) d, z = cos(theta) cos(phi) d,
        valid depth in (0, 15) m, invalid points NaN. One vectorized op."""
        depth_m = np.asarray(self.sphere_depth_mm, np.float32) * 1e-3
        h, w = depth_m.shape
        step = 2.0 * np.pi / w
        phi = (np.arange(h, dtype=np.float32) + start_phi) * step - np.pi / 2
        theta = np.arange(w, dtype=np.float32) * step - np.pi
        cos_phi, sin_phi = np.cos(phi)[:, None], np.sin(phi)[:, None]
        sin_th, cos_th = np.sin(theta)[None, :], np.cos(theta)[None, :]
        valid = (depth_m > 0.0) & (depth_m < max_depth)
        d = np.where(valid, depth_m, np.nan)
        xyz = np.stack(
            [sin_th * cos_phi * d, sin_phi * d, cos_th * cos_phi * d], axis=-1
        )
        rgb = np.asarray(self.sphere_rgb)[..., ::-1]  # BGR -> RGB
        self.sphere_cloud = (xyz.reshape(-1, 3), rgb.reshape(-1, 3))
        return self.sphere_cloud
