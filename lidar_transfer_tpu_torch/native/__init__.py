"""The native (C++) BVH mesh raytracer, loaded through ctypes: the CPU
oracle of the mesh raycast kernel.

The port's own copy of ``lidar_transfer_tpu/native``: ``raytracer.cpp`` is
the original byte for byte (``tests/test_torch_selfcontained.py`` holds it
so), and this loader builds it with ``g++`` at first use into the port's
build directory, ``lidar_transfer_tpu_torch/_build/``, as
``_ltnative-<tag>.so``, the tag a hash of the source and of the machine's
CPU (the library is built with ``-march=native``). It builds from this
package's source alone and loads no other library. A failed build raises
with the compiler's output; nothing falls back.

No engine path calls it: ``ops/triangles.raycast_mesh`` builds its BVH
and runs the traversal kernel (``csrc/mesh_bvh.cu``,
``csrc/mesh_raycast.cu``) on the card and the dense sweep, its plain
version, on the CPU. The tests and ``chip_smoke.py`` hold those against
:func:`trace_mesh`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from lidar_transfer_tpu_torch._build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("raytracer.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
             "-march=native", "-funroll-loops")

_LIB: ctypes.CDLL | None = None
_lock = threading.Lock()


def _source_tag() -> str:
    # the key must identify the MACHINE too, not just the source: a
    # -march=native binary left in a working tree copied to another CPU
    # would otherwise load there and SIGILL on the first call instead of
    # rebuilding
    import platform

    cpu = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu += line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    with open(SRC, "rb") as f:
        return hashlib.sha256(
            f.read() + cpu.encode()).hexdigest()[:12]


def library_path() -> Path:
    """Where the library of this source and machine is built."""
    return BUILD_DIR / f"_ltnative-{_source_tag()}.so"


def _compile(out_path: Path) -> None:
    """Build ``raytracer.cpp`` into ``out_path`` through a temporary file
    renamed into place (parallel test workers build at once); raise with
    the compiler's output on a failure."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_path.parent)
    os.close(fd)
    try:
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                           check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise RuntimeError(f"native raytracer: g++ build of {SRC} "
                               f"failed: {detail}") from e
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        lib.lt_trace.restype = ctypes.c_int
        lib.lt_trace.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,       # rays
            ctypes.POINTER(ctypes.c_float),                     # origin
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,       # verts
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,       # faces
            ctypes.POINTER(ctypes.c_int32),                     # vert_labels
            ctypes.POINTER(ctypes.c_float),                     # vert_rems
            ctypes.POINTER(ctypes.c_float),                     # endpoints
            ctypes.POINTER(ctypes.c_int32),                     # labels
            ctypes.POINTER(ctypes.c_float),                     # rems
            ctypes.POINTER(ctypes.c_float),                     # range
            ctypes.POINTER(ctypes.c_int32),                     # tri
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True if the native raytracer builds (or was built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class NativeTraceResult(NamedTuple):
    endpoints: np.ndarray   # (R,3) f32; (0,0,0) on miss
    labels: np.ndarray      # (R,)  i32; 0 on miss
    remissions: np.ndarray  # (R,)  f32; 0 on miss
    range: np.ndarray       # (R,)  f32; 0 on miss
    tri: np.ndarray         # (R,)  i32 hit triangle index; -1 on miss
    hits: int


def _c32(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def trace_mesh(rays: np.ndarray, origin: np.ndarray, verts: np.ndarray,
               faces: np.ndarray, vert_labels: np.ndarray,
               vert_rems: np.ndarray) -> NativeTraceResult:
    """Nearest-hit raycast of R rays against an indexed mesh (native BVH).

    Same contract as the reference's ``C_Trace`` (RayTracerCython.pyx:15-33 →
    RayTracer.cpp:118-124): shared ray origin, per-vertex attributes, hit
    label from the triangle's vertex 0, remission = mean of its 3 vertices.
    Raises if the library cannot be built.
    """
    lib = _load()
    rays = _c32(rays, np.float32).reshape(-1, 3)
    origin = _c32(origin, np.float32).reshape(3)
    verts = _c32(verts, np.float32).reshape(-1, 3)
    faces = _c32(faces, np.int32).reshape(-1, 3)
    vert_labels = _c32(vert_labels, np.int32).reshape(-1)
    vert_rems = _c32(vert_rems, np.float32).reshape(-1)
    if faces.size and (faces.min() < 0 or faces.max() >= verts.shape[0]):
        raise ValueError("face index out of range")
    if vert_labels.shape[0] != verts.shape[0] or \
            vert_rems.shape[0] != verts.shape[0]:
        raise ValueError("per-vertex attribute length mismatch")

    n_rays = rays.shape[0]
    endpoints = np.zeros((n_rays, 3), np.float32)
    labels = np.zeros((n_rays,), np.int32)
    rems = np.zeros((n_rays,), np.float32)
    rng = np.zeros((n_rays,), np.float32)
    tri = np.full((n_rays,), -1, np.int32)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa
    hits = lib.lt_trace(
        fptr(rays), n_rays, fptr(origin), fptr(verts), verts.shape[0],
        iptr(faces), faces.shape[0], iptr(vert_labels), fptr(vert_rems),
        fptr(endpoints), iptr(labels), fptr(rems), fptr(rng), iptr(tri))
    return NativeTraceResult(endpoints=endpoints, labels=labels,
                             remissions=rems, range=rng, tri=tri, hits=hits)
