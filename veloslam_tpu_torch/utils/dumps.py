"""Frame debug dumps: point text, bird's-eye-view image, PCD (host
numpy).

Port of veloslam_tpu/utils/dumps.py, byte-equal output on equal inputs
(tests/test_torch_apps.py): 'x y z intensity' text rows, an ASCII PCD
v0.7 readable by pcl / open3d / CloudCompare, and a BEV intensity raster
written as PNG when PIL is importable, else PGM.  A frame is a dict with
"xyz" (..., 3), "mask" and optionally "intensity" of the same leading
shape.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _frame_points(frame: Dict) -> np.ndarray:
    pts = frame["xyz"][frame["mask"]]
    return np.asarray(pts, np.float64)


def _frame_intensity(frame: Dict, n: int, default: float) -> np.ndarray:
    inten = frame.get("intensity")
    if inten is None:
        return np.full(n, default)
    return np.asarray(inten)[frame["mask"]]


def dump_txt(frame: Dict, path: str) -> int:
    """Write 'x y z intensity' rows for every valid point."""
    pts = _frame_points(frame)
    iv = _frame_intensity(frame, len(pts), 0.0)
    with open(path, "w") as f:
        for p, i in zip(pts, iv):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {i:.0f}\n")
    return len(pts)


def dump_pcd(frame: Dict, path: str) -> int:
    """ASCII PCD v0.7 with x y z intensity fields."""
    pts = _frame_points(frame)
    iv = _frame_intensity(frame, len(pts), 0.0)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z intensity\n"
                "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\n"
                "VIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        for p, i in zip(pts, iv):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {i:.1f}\n")
    return len(pts)


def bev_image(frame: Dict, range_m: float = 60.0, px_per_m: float = 8.0,
              center=None) -> np.ndarray:
    """Rasterize a bird's-eye-view intensity image (uint8 H×W): each
    valid point brightens its cell to at least its intensity; the view is
    centred on `center` (default the points' median xy)."""
    pts = _frame_points(frame)
    iv = _frame_intensity(frame, len(pts), 128.0)
    if center is None:
        center = np.zeros(2) if len(pts) == 0 else np.median(pts[:, :2], 0)
    n = int(2 * range_m * px_per_m)
    img = np.zeros((n, n), np.float32)
    if len(pts):
        xy = (pts[:, :2] - center + range_m) * px_per_m
        ij = np.floor(xy).astype(int)
        ok = np.all((ij >= 0) & (ij < n), axis=1)
        np.maximum.at(img, (n - 1 - ij[ok, 1], ij[ok, 0]), iv[ok])
    return np.clip(img, 0, 255).astype(np.uint8)


def dump_bev(frame: Dict, path: str, **kw) -> str:
    """Write the BEV image as PNG (PIL importable) or PGM.  Returns the
    path written (the extension appended when missing)."""
    img = bev_image(frame, **kw)
    try:
        from PIL import Image
    except ImportError:
        if not path.endswith(".pgm"):
            path += ".pgm"
        with open(path, "wb") as f:
            f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(img.tobytes())
        return path
    if not path.endswith(".png"):
        path += ".png"
    Image.fromarray(img).save(path)
    return path
