"""Mesh renderer: a C++ orthographic z-buffer rasterizer on the host.

Counterpart of ``human_dynamics_tpu/viz/renderer.py`` (the reference's
VisRenderer, src/util/render/nmr_renderer.py:43-240, without the CUDA
neural_renderer: visualisation needs no gradients). ``csrc/rasterizer.cpp``
is a copy of the JAX package's rasterizer. It is built at first use with
``g++ -O3 -shared -fPIC`` into ``ops/_build/`` (gitignored), under a name
that carries a hash of the source and the flags, and called through
ctypes. A failed build raises: nothing falls back. The numpy rasterizer
(``rasterize_numpy``, the same math) is the plain version, chosen with
``VisRenderer(..., backend="numpy")``.

Conventions, as the reference's:
- weak-perspective projection xy' = s * (xy + t), z kept, then y flipped
  to image coordinates;
- light direction [1, .5, -1], intensities dir 0.3 / amb 0.7, white
  background;
- the reference renderer's colour palette.

No cv2: the rotated view builds its rotation with a numpy Rodrigues.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from human_dynamics_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "rasterizer.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
BACKENDS = ("native", "numpy")

# The reference renderer's mesh colours (values in [0, 1]).
MESH_COLORS = {
    "blue": [0.65098039, 0.74117647, 0.85882353],
    "pink": [0.9, 0.7, 0.7],
    "mint": [166 / 255.0, 229 / 255.0, 204 / 255.0],
    "mint2": [202 / 255.0, 229 / 255.0, 223 / 255.0],
    "green": [153 / 255.0, 216 / 255.0, 201 / 255.0],
    "green2": [171 / 255.0, 221 / 255.0, 164 / 255.0],
    "red": [251 / 255.0, 128 / 255.0, 114 / 255.0],
    "orange": [253 / 255.0, 174 / 255.0, 97 / 255.0],
    "yellow": [250 / 255.0, 230 / 255.0, 154 / 255.0],
}

_LIB = None
_LOCK = threading.Lock()


def library_path() -> str:
    """Where the rasterizer's shared library is (or will be) built."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read() + b"\0")
    h.update("\0".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librasterizer_{h.hexdigest()[:16]}.so")


def load_library() -> ctypes.CDLL:
    """Build (once; a cached build is reused) and load the rasterizer.
    Raises if there is no C++ compiler or the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if not cxx:
                raise RuntimeError(
                    "no C++ compiler (g++, or $CXX) to build the rasterizer; "
                    "VisRenderer(..., backend='numpy') renders without it")
            os.makedirs(BUILD_DIR, exist_ok=True)
            # Build under a temporary name and rename, so that a concurrent
            # or interrupted build never leaves a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [cxx, *CXX_FLAGS, SOURCE, "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"building the rasterizer failed ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.render_mesh.argtypes = [
            f32, ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, f32, f32, ctypes.c_float, ctypes.c_float, f32, f32,
        ]
        lib.render_mesh.restype = None
        _LIB = lib
        return lib


def rasterize_native(proj, faces, size, color, light_dir, int_dir, int_amb):
    """(size, size, 3) rgb and (size, size) mask of ``proj`` (V, 3) screen
    coordinates in [-1, 1] (y down, z depth) by the C++ rasterizer."""
    lib = load_library()
    f32 = ctypes.POINTER(ctypes.c_float)
    proj = np.ascontiguousarray(proj, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    color = np.ascontiguousarray(color, np.float32)
    light = np.ascontiguousarray(light_dir, np.float32)
    rgb = np.zeros((size, size, 3), np.float32)
    mask = np.zeros((size, size), np.float32)
    lib.render_mesh(
        proj.ctypes.data_as(f32), len(proj),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        size, color.ctypes.data_as(f32), light.ctypes.data_as(f32),
        ctypes.c_float(int_dir), ctypes.c_float(int_amb),
        rgb.ctypes.data_as(f32), mask.ctypes.data_as(f32),
    )
    return rgb, mask


def rasterize_numpy(proj, faces, size, color, light_dir, int_dir, int_amb):
    """The plain version of ``rasterize_native``: the same math, one face
    at a time over its bounding box in numpy."""
    rgb = np.zeros((size, size, 3), np.float32)
    mask = np.zeros((size, size), np.float32)
    zbuf = np.full((size, size), 1e30, np.float32)

    half = size / 2.0
    pix = (proj[:, :2] + 1.0) * half
    z = proj[:, 2]
    l = np.asarray(light_dir, np.float32)
    l = l / np.linalg.norm(l)

    tri = pix[faces]                      # (F, 3, 2)
    tz = z[faces]                         # (F, 3)
    # Lighting per face.
    p3 = np.concatenate(
        [pix[faces][:, :, :1], -pix[faces][:, :, 1:2], tz[..., None]],
        axis=2,
    )
    n = np.cross(p3[:, 1] - p3[:, 0], p3[:, 2] - p3[:, 0])
    nn = np.linalg.norm(n, axis=1, keepdims=True)
    ok = nn[:, 0] > 1e-12
    n = n / np.maximum(nn, 1e-12)
    flip = n[:, 2] > 0
    n[flip] = -n[flip]
    intensity = np.minimum(
        1.0, int_amb + int_dir * np.maximum(0.0, n @ l)
    )
    face_rgb = np.minimum(1.0, np.asarray(color) * intensity[:, None])

    for f in np.nonzero(ok)[0]:
        (x0, y0), (x1, y1), (x2, y2) = tri[f]
        min_x = max(int(np.floor(min(x0, x1, x2))), 0)
        max_x = min(int(np.ceil(max(x0, x1, x2))), size - 1)
        min_y = max(int(np.floor(min(y0, y1, y2))), 0)
        max_y = min(int(np.ceil(max(y0, y1, y2))), size - 1)
        if min_x > max_x or min_y > max_y:
            continue
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(denom) < 1e-12:
            continue
        xs = np.arange(min_x, max_x + 1) + 0.5
        ys = np.arange(min_y, max_y + 1) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        w0 = ((y1 - y2) * (gx - x2) + (x2 - x1) * (gy - y2)) / denom
        w1 = ((y2 - y0) * (gx - x2) + (x0 - x2) * (gy - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zf = w0 * tz[f, 0] + w1 * tz[f, 1] + w2 * tz[f, 2]
        sub_z = zbuf[min_y:max_y + 1, min_x:max_x + 1]
        upd = inside & (zf < sub_z)
        sub_z[upd] = zf[upd]
        rgb[min_y:max_y + 1, min_x:max_x + 1][upd] = face_rgb[f]
        mask[min_y:max_y + 1, min_x:max_x + 1][upd] = 1.0
    return rgb, mask


def rodrigues(rvec) -> np.ndarray:
    """Axis-angle (3,) -> 3x3 rotation, float64, in cv2.Rodrigues's order
    of operations: R = cos(t) I + (1 - cos(t)) r r^T + sin(t) [r]_x."""
    rx, ry, rz = (float(v) for v in np.asarray(rvec, np.float64).reshape(3))
    theta = math.sqrt(rx * rx + ry * ry + rz * rz)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    itheta = 1.0 / theta
    r = np.array([rx * itheta, ry * itheta, rz * itheta])
    r_x = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                    [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * r_x


class VisRenderer:
    """Renders SMPL meshes with weak-perspective cameras.

    Args as the reference's: ``faces`` an (F, 3) int array (or
    ``face_path`` an .npy of them). ``backend`` "native" (the C++
    rasterizer, built at the first render) or "numpy" (the plain version).
    """

    def __init__(self, img_size: int = 256, faces=None, face_path=None,
                 backend: str = "native"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.img_size = img_size
        if faces is None:
            if face_path is None:
                raise ValueError("Provide faces array or face_path")
            faces = np.load(face_path)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.backend = backend
        self.light_dir = np.asarray([1.0, 0.5, -1.0], np.float32)
        self.int_dir = 0.3
        self.int_amb = 0.7
        self.bg_color = np.asarray([1.0, 1.0, 1.0], np.float32)

    def set_light_dir(self, direction, int_dir=0.8, int_amb=0.8):
        self.light_dir = np.asarray(direction, np.float32)
        self.int_dir = float(int_dir)
        self.int_amb = float(int_amb)

    def set_bgcolor(self, color):
        self.bg_color = np.asarray(color, np.float32)

    def _project(self, verts, cam):
        """Weak perspective + y flip -> (V, 3) screen coords."""
        cam = np.asarray(cam, np.float32).reshape(3)
        xy = cam[0] * (verts[:, :2] + cam[1:])
        proj = np.column_stack([xy[:, 0], -xy[:, 1], verts[:, 2]])
        return np.ascontiguousarray(proj, np.float32)

    def _render_single(self, verts, cam, color_name, img_size=None):
        proj = self._project(np.asarray(verts, np.float32), cam)
        color = np.asarray(MESH_COLORS[color_name], np.float32)
        raster = (rasterize_native if self.backend == "native"
                  else rasterize_numpy)
        return raster(proj, self.faces, img_size or self.img_size, color,
                      self.light_dir, self.int_dir, self.int_amb)

    def __call__(
        self,
        verts: np.ndarray,
        cam: Optional[np.ndarray] = None,
        rend_mask: bool = False,
        alpha: bool = False,
        img: Optional[np.ndarray] = None,
        color_name: str = "blue",
        img_size: Optional[int] = None,
    ) -> np.ndarray:
        """verts (V, 3) [or (B, V, 3)], cam (3,) [or (B, 3)] -> uint8 image:
        the mesh over a white background, a silhouette if ``rend_mask``,
        RGBA if ``alpha``, or composited over ``img`` ([0, 255]) when
        given."""
        verts = np.asarray(verts, np.float32)
        if verts.ndim == 3:
            outs = [
                self.__call__(
                    verts[i],
                    None if cam is None else np.asarray(cam)[i],
                    rend_mask, alpha,
                    None if img is None else img[i],
                    color_name, img_size,
                )
                for i in range(len(verts))
            ]
            return np.stack(outs)

        if cam is None:
            cam = np.asarray([0.9, 0.0, 0.0], np.float32)

        if img is not None and img_size is None:
            img_size = img.shape[0]
        rgb, mask = self._render_single(verts, cam, color_name, img_size)

        if rend_mask:
            sil = (mask * 255).astype(np.uint8)
            return np.repeat(sil[:, :, None], 3, axis=2)

        rend = rgb * mask[:, :, None] + self.bg_color * (
            1.0 - mask[:, :, None]
        )
        rend = (np.clip(rend, 0, 1) * 255).astype(np.uint8)

        if img is not None:
            m = mask[:, :, None]
            return (img * (1 - m) + rend * m).astype(np.uint8)
        if alpha:
            a = (mask * 255).astype(np.uint8)
            return np.dstack((rend, a))
        return rend

    def rotated(
        self, verts, deg, axis="y", cam=None, **kwargs
    ) -> np.ndarray:  # kwargs: rend_mask/alpha/img/color_name/img_size
        """Render a view rotated ``deg`` degrees about the vertices'
        centroid."""
        axis_vec = {
            "x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]
        }[axis]
        rot = rodrigues(np.deg2rad(deg) * np.array(axis_vec))
        verts = np.asarray(verts, np.float32)
        center = verts.mean(axis=0, keepdims=True)
        new_verts = (verts - center) @ rot.T + center
        return self.__call__(new_verts, cam=cam, **kwargs)
