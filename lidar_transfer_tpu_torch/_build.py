"""Build the port's CUDA kernels from ``csrc/`` and call them through ctypes.

Each ``csrc/*.cu`` file (with the ``*.cuh`` headers it includes) compiles
with its own ``nvcc``, all started together, and the objects link into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library is named after a hash of the sources and flags
(``_build/_ltkernels-<hash>.so``) and is built at the first kernel launch,
never at import: importing this module needs no ``nvcc`` and no card.

``-fmad=false`` keeps every product and sum rounded on its own, as the
plain PyTorch versions round them, so a kernel and its plain version agree
bit for bit wherever they do the same arithmetic.

Each wrapper launches through :func:`launch`, which raises on a nonzero
``cudaError_t`` and adds one to the kernel's launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: argument types of each C entry (every pointer and the stream as c_void_p)
SIGNATURES = {
    "lt_zbuffer_winners": (_P, _P, _L, _L, _P, _P, _P),
    "lt_confusion": (_P, _P, _L, _I, _P, _P),
    "lt_tsdf_integrate": (_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I,
                          _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                          _I, _I, _I, _I, _I, _P),
    "lt_tsdf_integrate_chain": (_P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                                _I, _I, _I, _I, _P),
    "lt_tsdf_geometry": (_P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _F,
                         _I, _P, _P, _P, _I, _P, _P),
    "lt_probe_parts": (_P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _L, _I, _F, _F, _P),
    "lt_probe_ablate": (_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _L, _I, _F, _F, _F, _P),
    "lt_probe_write": (_P, _P, _P, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _I, _I, _I, _L, _I, _P),
    "lt_occupancy_bits": (_P, _I, _I, _I, _P, _P),
    "lt_raymarch": (_P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                    _P, _P, _P, _P, _P, _P),
    "lt_mesh_bvh_keys": (_P, _I, _P, _P, _P, _P, _P),
    "lt_mesh_bvh_hierarchy": (_P, _I, _P, _P, _P, _P),
    "lt_mesh_bvh_refit": (_P, _P, _P, _P, _P, _I, _P, _P),
    "lt_mesh_bvh_reorder": (_P, _P, _I, _P, _P),
    "lt_mesh_raycast": (_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P),
    "lt_mesh_raycast_dense": (_P, _I, _P, _I, _P, _I, _P, _P, _P),
    "lt_group_norm": (_P, _P, _P, _L, _I, _I, _L, _F, _I, _I, _I, _L, _P,
                      _P, _P, _P, _P),
    "lt_empty_launch": (_P,),
}

#: launches per kernel since the last reset_launch_counts()
_launches = {"zbuffer": 0, "confusion": 0, "tsdf_integrate": 0,
             "tsdf_integrate_chain": 0, "tsdf_geometry": 0,
             "probe_parts": 0, "probe_ablate": 0, "probe_write": 0,
             "raymarch": 0, "raymarch_pack": 0, "mesh_bvh_keys": 0,
             "mesh_bvh_hierarchy": 0, "mesh_bvh_refit": 0,
             "mesh_bvh_reorder": 0, "mesh_raycast": 0,
             "mesh_raycast_dense": 0, "group_norm": 0}
_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"_ltkernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lidar_transfer_tpu_torch need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in cus]
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
              for s, o in zip(cus, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.lt_error_string.argtypes = (ctypes.c_int,)
            lib.lt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry``; raise on a CUDA error, else count a launch
    of ``kernel``."""
    lib = library()
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.lt_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")
    _launches[kernel] += 1


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
