"""ctypes bindings for the native iso-surface extraction library.

API parity with the reference's NumpyMarchingCubes entry point
(/root/reference/external/NumpyMarchingCubes/marching_cubes/_mcubes.pyx:19-24):
``marching_cubes(volume, isovalue, truncation) -> (verts, faces)`` with
vertices in grid (voxel-index) coordinates and truncation-aware invalid
voxel rejection.

The shared library is built from ``native/marching_cubes/marching.cpp``
on first use (it is not tracked by git). A failed build or load raises:
there is no silent switch to a slower path. ``_marching_py`` is the
pure-Python statement of the same algorithm, kept as the reference the
tests compare the library against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "marching_cubes")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmarching.so")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build_library(path: str = _LIB_PATH) -> None:
    """Compile marching.cpp into ``path``. The compiler writes to a
    temporary name in the same directory, which is then renamed into
    place, so concurrent builders (test workers) never load a partial
    file."""
    src = os.path.join(_NATIVE_DIR, "marching.cpp")
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
             "-shared", "-o", tmp, src],
            check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mc_extract.restype = ctypes.c_int
        lib.mc_extract.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mc_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def marching_cubes(volume: np.ndarray, isovalue: float = 0.0,
                   truncation: float = 1.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a TSDF volume [nx, ny, nz].

    Voxels with |v| >= truncation or non-finite values are invalid and
    their cubes are skipped. Returns (verts [V,3] float64 in voxel-index
    coords, faces [F,3] int64).
    """
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    lib = _load_library()

    vp = ctypes.POINTER(ctypes.c_double)()
    fp = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mc_extract(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vol.shape[0], vol.shape[1], vol.shape[2],
        ctypes.c_float(isovalue), ctypes.c_float(truncation),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp),
        ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError("mc_extract failed")
    verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
        if nv.value else np.zeros((0, 3))
    faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() \
        if nf.value else np.zeros((0, 3), np.int64)
    lib.mc_free(vp)
    lib.mc_free(fp)
    return verts, faces


# ---------------------------------------------------------------------------
# pure-Python reference (same algorithm; tests compare the library to it)
# ---------------------------------------------------------------------------

_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
_CORNER = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                    for c in range(8)], np.float64)


def _marching_py(vol, isovalue, truncation):
    nx, ny, nz = vol.shape
    valid = np.isfinite(vol) & (np.abs(vol) < truncation)
    verts = {}
    vlist = []
    faces = []

    def vid(p):
        k = (round(p[0] * 1e5), round(p[1] * 1e5), round(p[2] * 1e5))
        if k not in verts:
            verts[k] = len(vlist)
            vlist.append(p)
        return verts[k]

    xs, ys, zs = np.where(
        valid[:-1, :-1, :-1] & valid[1:, :-1, :-1] & valid[:-1, 1:, :-1]
        & valid[1:, 1:, :-1] & valid[:-1, :-1, 1:] & valid[1:, :-1, 1:]
        & valid[:-1, 1:, 1:] & valid[1:, 1:, 1:])
    for x, y, z in zip(xs, ys, zs):
        cv = np.array([vol[x + int(c[0]), y + int(c[1]), z + int(c[2])]
                       for c in _CORNER])
        if (cv < isovalue).all() or (cv >= isovalue).all():
            continue
        cp = _CORNER + np.array([x, y, z], np.float64)
        for tet in _TETS:
            tv, tp = cv[tet], cp[tet]
            inside = tv < isovalue
            n_in = int(inside.sum())
            if n_in in (0, 4):
                continue

            def edge(a, b):
                d = tv[b] - tv[a]
                t = 0.5 if abs(d) < 1e-12 else np.clip(
                    (isovalue - tv[a]) / d, 0, 1)
                return tuple(tp[a] + t * (tp[b] - tp[a]))

            if n_in in (1, 3):
                lone = int(np.argmax(inside if n_in == 1 else ~inside))
                oth = [i for i in range(4) if i != lone]
                tri = [vid(edge(lone, o)) for o in oth]
                if len(set(tri)) == 3:
                    faces.append(tri)
            else:
                ins = np.where(inside)[0]
                out = np.where(~inside)[0]
                q = [vid(edge(ins[0], out[0])), vid(edge(ins[0], out[1])),
                     vid(edge(ins[1], out[1])), vid(edge(ins[1], out[0]))]
                if len({q[0], q[1], q[2]}) == 3:
                    faces.append([q[0], q[1], q[2]])
                if len({q[0], q[2], q[3]}) == 3:
                    faces.append([q[0], q[2], q[3]])
    return (np.asarray(vlist, np.float64).reshape(-1, 3),
            np.asarray(faces, np.int64).reshape(-1, 3))
