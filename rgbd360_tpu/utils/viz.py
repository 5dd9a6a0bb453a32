"""Visualization artifact dumps.

The reference renders interactively through PCL viewers on a render thread
(include/*Visualizer*.h); in a headless deployment the equivalent is
artifact export: PNG panoramas, PLY/PCD point clouds and trajectory text
files that any viewer can load (SURVEY.md §2.1 'Visualizers' row).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def save_png(path: str, img: np.ndarray) -> None:
    """8-bit PNG of an (H, W) gray or (H, W, 3) RGB image, written with zlib
    alone (no imaging library): every scanline uses filter type 0."""
    img = np.ascontiguousarray(np.asarray(img).astype(np.uint8))
    if img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    elif img.ndim == 2:
        color_type = 0
    else:
        raise ValueError(f"save_png takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def depth_to_u8(depth_mm: np.ndarray, max_mm: float = 6000.0) -> np.ndarray:
    return (np.clip(np.asarray(depth_mm, np.float32) / max_mm, 0, 1) * 255).astype(np.uint8)


def save_sphere_images(frame, out_dir: str, tag: str) -> None:
    """rgb_<tag>.png + depth_<tag>.png like the reference's SAVE_IMAGES path
    (Registration/OdometryRGBD360.cpp:157-163)."""
    os.makedirs(out_dir, exist_ok=True)
    rgb = np.asarray(frame.sphere_rgb)[..., ::-1]  # BGR -> RGB for PNG
    save_png(os.path.join(out_dir, f"rgb_{tag}.png"), rgb)
    save_png(os.path.join(out_dir, f"depth_{tag}.png"), depth_to_u8(frame.sphere_depth_mm))


def save_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud (finite points only)."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    keep = np.isfinite(xyz).all(axis=1)
    xyz = xyz[keep]
    colors = None
    if rgb is not None:
        colors = np.asarray(rgb).reshape(-1, 3)[keep].astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        # vectorized formatting: a per-row f-string loop costs seconds for
        # 614k-point keyframe clouds
        if colors is not None:
            np.savetxt(f, np.concatenate([xyz, colors], axis=1),
                       fmt="%.4f %.4f %.4f %d %d %d")
        else:
            np.savetxt(f, xyz, fmt="%.4f")


def save_pcd(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    organized_shape: Optional[tuple] = None,
) -> None:
    """ASCII PCD (the reference saves sphereCloud_%u.pcd, Frame360.h:321-330).
    NaN points are kept, and organized_shape=(H, W) writes a genuinely
    organized header (WIDTH W HEIGHT H) like PCL's savePCDFile does for the
    panorama cloud — a HEIGHT-1 header would discard the organization the
    NaN padding exists to preserve."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    fields = "x y z" + (" rgb" if rgb is not None else "")
    n = len(xyz)
    if organized_shape is not None:
        hh, ww = organized_shape
        assert hh * ww == n, (organized_shape, n)
    else:
        hh, ww = 1, n
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        if rgb is not None:
            f.write("SIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n")
        else:
            f.write("SIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        f.write(f"WIDTH {ww}\nHEIGHT {hh}\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n")
        if rgb is not None:
            packed = (
                np.asarray(rgb).reshape(-1, 3).astype(np.uint32)
            )
            packed = (packed[:, 0] << 16) | (packed[:, 1] << 8) | packed[:, 2]
            np.savetxt(
                f,
                np.concatenate([xyz, packed[:, None].astype(np.float64)], axis=1),
                fmt="%.4f %.4f %.4f %d",
            )
        else:
            np.savetxt(f, xyz, fmt="%.4f")


def save_trajectory(path: str, poses) -> None:
    """One 4x4 pose per 4 lines (reference Rt dumps, OdometryRGBD360.cpp:279)."""
    with open(path, "w") as f:
        for pose in poses:
            for row in np.asarray(pose):
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")


def load_pcd(path: str):
    """Read the ASCII PCD written by save_pcd (x y z [packed rgb]).
    Returns (xyz (N,3) f32, rgb (N,3) u8 or None)."""
    with open(path) as f:
        fields = []
        n = 0
        for line in f:
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                if line.split()[1] != "ascii":
                    raise ValueError("only ascii PCD supported")
                break
        data = np.loadtxt(f, dtype=np.float64, max_rows=n)
    data = data.reshape(-1, len(fields))
    xyz = data[:, :3].astype(np.float32)
    rgb = None
    if "rgb" in fields:
        packed = data[:, 3].astype(np.uint32)
        rgb = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], axis=-1
        ).astype(np.uint8)
    return xyz, rgb
