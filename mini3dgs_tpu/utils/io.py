"""Image / point-cloud IO.

Reference semantics: `/root/reference/src/utils/io_utils.py` — `save_image`
CHW float -> HWC uint8 PNG (io_utils.py:17-23), `load_point_cloud` multi-format
(.npz points/colors, .npy [N,>=6], COLMAP points3D.txt, generic whitespace
text; io_utils.py:33-85), plus the stubbed `load_image` / `save_point_cloud`
implemented for real.  Also PLY read/write (the canonical 3DGS interchange
format; `plyfile` is in the reference's requirements).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def _pil_image():
    """PIL's Image module, imported on first use: only the on-disk image
    datasets and image export need it (an optional extra)."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return None
    return Image


def save_image(image, path: str) -> None:
    """image: [3,H,W] float in [0,1] (host or device array).  A no-op
    without PIL."""
    Image = _pil_image()
    if Image is None:
        return
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(image)
    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(path)


def load_image(path: str, bg: float = 1.0) -> np.ndarray:
    """Returns [3,H,W] float32 in [0,1].  RGBA alpha is composited onto `bg`
    (scalar or [3]); default white follows the NeRF-synthetic convention, and
    datasets with `white_background=False` pass bg=0.0 so GT stays consistent
    with a black render background."""
    Image = _pil_image()
    if Image is None:
        raise ImportError("PIL required for load_image")
    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        rgb, a = img[..., :3], img[..., 3:4]
        img = rgb * a + (1.0 - a) * np.asarray(bg, np.float32)
    return img.transpose(2, 0, 1)


def save_point_cloud(points: np.ndarray, colors: Optional[np.ndarray],
                     path: str) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, np.float32)
    if p.suffix == ".npz":
        if colors is None:
            np.savez(p, points=points)
        else:
            np.savez(p, points=points, colors=np.asarray(colors, np.float32))
    elif p.suffix == ".npy":
        if colors is None:
            colors = np.ones_like(points)
        np.save(p, np.concatenate([points, np.asarray(colors, np.float32)], axis=1))
    elif p.suffix == ".ply":
        save_ply(points, colors, str(p))
    else:
        cols = colors if colors is not None else np.ones_like(points)
        np.savetxt(p, np.concatenate([points, cols], axis=1), fmt="%.6f")


def load_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Multi-format loader (reference io_utils.py:33-85 + PLY)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".npz":
        data = np.load(str(p))
        pts = data["points"] if "points" in data else np.zeros((0, 3), np.float32)
        cols = data["colors"] if "colors" in data else None
        return pts.astype(np.float32), (None if cols is None else cols.astype(np.float32))
    if suffix == ".npy":
        arr = np.load(str(p))
        if arr.ndim == 2 and arr.shape[1] >= 6:
            return arr[:, :3].astype(np.float32), arr[:, 3:6].astype(np.float32)
        return arr[:, :3].astype(np.float32), None
    if suffix == ".ply":
        return load_ply(str(p))
    if suffix == ".bin" and p.name == "points3D.bin":
        from ..data.colmap import read_points3d_binary
        return read_points3d_binary(str(p))
    if suffix == ".txt" and p.name == "points3D.txt":
        points, colors = [], []
        with open(p, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                if not line or line.startswith("#"):
                    continue
                parts = line.strip().split()
                if len(parts) < 10:
                    continue
                points.append([float(v) for v in parts[1:4]])
                colors.append([float(v) / 255.0 for v in parts[4:7]])
        return (np.asarray(points, np.float32), np.asarray(colors, np.float32))
    # generic whitespace text: xyz[ rgb]
    pts, cols = [], []
    with open(p, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                parts = [float(v) for v in line.split()]
            except ValueError:
                continue
            if len(parts) >= 3:
                pts.append(parts[:3])
                if len(parts) >= 6:
                    cols.append(parts[3:6])
    pts_arr = np.asarray(pts, np.float32)
    cols_arr = np.asarray(cols, np.float32) if cols else None
    return pts_arr, cols_arr


# ---- PLY (binary little-endian, canonical 3DGS layout or plain xyz+rgb) ----

def save_ply(points: np.ndarray, colors: Optional[np.ndarray], path: str) -> None:
    try:
        from plyfile import PlyData, PlyElement
    except ImportError:
        # minimal self-written binary PLY
        n = len(points)
        cols = (np.clip(colors if colors is not None else np.ones_like(points), 0, 1)
                * 255).astype(np.uint8)
        header = (b"ply\nformat binary_little_endian 1.0\n"
                  + f"element vertex {n}\n".encode()
                  + b"property float x\nproperty float y\nproperty float z\n"
                  + b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
                  + b"end_header\n")
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                 ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        rec["x"], rec["y"], rec["z"] = points.T.astype(np.float32)
        rec["red"], rec["green"], rec["blue"] = cols.T
        with open(path, "wb") as f:
            f.write(header)
            f.write(rec.tobytes())
        return
    n = len(points)
    cols = (np.clip(colors if colors is not None else np.ones_like(points), 0, 1)
            * 255).astype(np.uint8)
    rec = np.zeros(n, dtype=[("x", "f4"), ("y", "f4"), ("z", "f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = points.T.astype(np.float32)
    rec["red"], rec["green"], rec["blue"] = cols.T
    PlyData([PlyElement.describe(rec, "vertex")]).write(path)


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    try:
        from plyfile import PlyData
    except ImportError:
        return _load_ply_minimal(path)
    ply = PlyData.read(path)
    v = ply["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    names = v.data.dtype.names
    if all(c in names for c in ("red", "green", "blue")):
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
        return pts, cols
    return pts, None


def _load_ply_minimal(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        n = next(int(l.split()[-1]) for l in lines if l.startswith("element vertex"))
        props = [l.split()[1:] for l in lines if l.startswith("property")]
        fmt = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4"}
        dtype = np.dtype([(name, fmt[t]) for t, name in props])
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    names = rec.dtype.names
    if all(c in names for c in ("red", "green", "blue")):
        cols = np.stack([rec["red"], rec["green"], rec["blue"]],
                        axis=1).astype(np.float32) / 255.0
        return pts, cols
    return pts, None
