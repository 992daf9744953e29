"""Package rules of the PyTorch port: no jax, no build at import, no
silent fallback.

The kernels are held against their plain versions on the card by
``chip_smoke.py``; a CUDA kernel has no CPU mode to test here.
"""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lidar_transfer_tpu_torch
from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.config import (HDL32, HDL64, SensorSpec,
                                             TransferConfig)
from lidar_transfer_tpu_torch.datasets import synthetic
from lidar_transfer_tpu_torch.metrics import confusion as TF
from lidar_transfer_tpu_torch.ops import projection as TP
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.triangles import raycast_mesh
from lidar_transfer_tpu_torch.ops.tsdf_cuda import (integrate_chain_cuda,
                                                    integrate_cuda,
                                                    precompute_geometry_cuda)
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import narrow_spec, shared_cores, time_limit  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TransferConfig(voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))


def _submodules():
    pkg = lidar_transfer_tpu_torch
    return [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")]


def test_imports_leave_jax_out():
    """Importing the package and every submodule never imports jax."""
    code = ("import importlib, sys\n"
            f"for m in {_submodules()!r}: importlib.import_module(m)\n"
            "print('jax' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    assert len(_submodules()) >= 15


def test_build_needs_no_nvcc_until_a_launch(tmp_path, monkeypatch):
    """_build imports without nvcc; a build without nvcc raises."""
    names = sorted(p.name for p in _build.sources())
    assert names == ["confusion.cu", "errors.cu", "group_norm.cu",
                     "mesh_bvh.cu", "mesh_raycast.cu", "probe_ablate.cu",
                     "probe_parts.cu",
                     "probe_runs.cuh", "probe_write.cu", "raymarch.cu",
                     "tsdf_common.cuh", "tsdf_geometry.cu",
                     "tsdf_integrate.cu", "zbuffer.cu"]
    assert _build.library_path().name.startswith("_ltkernels-")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


def _small_window(spec, nscans=1):
    pts, rem, lbl = synthetic.simulate_scan(synthetic.Scene.default(),
                                            spec, np.eye(4))
    n = pts.shape[0]
    rep = lambda t: torch.from_numpy(t)[None].repeat(  # noqa: E731
        nscans, *([1] * t.ndim))
    return ScanWindow(points=rep(pts), remissions=rep(rem),
                      labels=rep(lbl),
                      valid=torch.ones((nscans, n), dtype=torch.bool),
                      rel_pose=torch.eye(4)[None].repeat(nscans, 1, 1))


def test_cpu_calls_launch_no_kernel(small_spec, narrow_spec):
    """CPU tensors take the plain versions: every launch count stays 0,
    on the mergemesh path, on the mesh path with its chain and geometry
    table, on the raymarch path, and on catmesh's oracle engine with its
    mesh raycast (to ``narrow_spec``, whose fewer rays cast against the
    same mesh)."""
    _build.reset_launch_counts()
    eng = TD.TransferEngine(small_spec, small_spec, CFG, fixed_bounds=True,
                            device="cpu")
    vs = eng.transfer_fast(_small_window(small_spec))
    eng.fused_state()
    TF.confusion_matrix(vs.label.reshape(-1), vs.label.reshape(-1), 260)
    assert bool(vs.mask.any())
    mesh = TD.TransferEngine(
        small_spec, small_spec,
        TransferConfig(adaption="mesh", number_of_scans=3,
                       voxel_size=CFG.voxel_size,
                       voxel_bounds=CFG.voxel_bounds),
        fixed_bounds=True, device="cpu", compact_volume=True)
    vm = mesh.transfer_fast(_small_window(small_spec, 3))
    state = mesh.fused_state()
    assert bool(vm.mask.any()) and bool((state.tsdf < 1).any())
    assert len(mesh._geoms) == 1
    march = TD.TransferEngine(small_spec, small_spec, CFG,
                              fixed_bounds=True, device="cpu",
                              synthesis="raymarch", compact_volume=True)
    assert bool(march.transfer_fast(_small_window(small_spec)).mask.any())
    oracle = TD.TransferEngine(
        small_spec, narrow_spec,
        TransferConfig(adaption="catmesh", voxel_size=CFG.voxel_size,
                       voxel_bounds=CFG.voxel_bounds),
        fixed_bounds=True, device="cpu", catmesh_engine="oracle")
    assert bool(oracle.transfer_fast(_small_window(small_spec)).mask.any())
    assert oracle._last_mesh is not None
    assert _build.launch_counts() == {
        "zbuffer": 0, "confusion": 0, "tsdf_integrate": 0,
        "tsdf_integrate_chain": 0, "tsdf_geometry": 0, "probe_parts": 0,
        "probe_ablate": 0, "probe_write": 0, "raymarch": 0,
        "raymarch_pack": 0, "mesh_bvh_keys": 0, "mesh_bvh_hierarchy": 0,
        "mesh_bvh_refit": 0, "mesh_bvh_reorder": 0, "mesh_raycast": 0,
        "mesh_raycast_dense": 0, "group_norm": 0}


def test_mesh_entries_are_bound_and_counted():
    """Row C's entries have their C signatures and launch keys: the four
    build kernels, the traversal (``lt_mesh_raycast``, key
    ``mesh_raycast``) and the dense kernel of the parent design under its
    own key; each entry's name is defined once in ``csrc/``, with as many
    parameters as its signature lists."""
    import re

    entries = {"lt_mesh_bvh_keys": "mesh_bvh_keys",
               "lt_mesh_bvh_hierarchy": "mesh_bvh_hierarchy",
               "lt_mesh_bvh_refit": "mesh_bvh_refit",
               "lt_mesh_bvh_reorder": "mesh_bvh_reorder",
               "lt_mesh_raycast": "mesh_raycast",
               "lt_mesh_raycast_dense": "mesh_raycast_dense"}
    counts = _build.launch_counts()
    text = "".join(p.read_text() for p in _build.sources())
    for entry, key in entries.items():
        assert entry in _build.SIGNATURES and key in counts
        defs = re.findall(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert len(defs) == 1, entry
        assert len(defs[0].split(",")) == len(_build.SIGNATURES[entry])
    assert len(_build.SIGNATURES["lt_mesh_raycast"]) == 11


def test_library_name_follows_sources_and_flags(tmp_path, monkeypatch):
    """The library is named after a hash of every source and the nvcc
    flags: one byte changed in one .cu, or another flag, names another
    library, so a stale build never loads in place of the sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    plain = _build.library_path()
    assert _build.library_path() == plain
    cu = csrc / "confusion.cu"
    text = cu.read_bytes()
    cu.write_bytes(text + b" ")
    assert _build.library_path() != plain
    cu.write_bytes(text)
    assert _build.library_path() == plain
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != plain


@pytest.mark.parametrize("case", ["raymarch", "catmesh_oracle"])
def test_engine_refuses_unported(case):
    """Nothing the engine offers is refused any more: raymarch synthesis
    constructs with the target's rays, and catmesh's oracle engine
    constructs (both ported since); a synthesis or a catmesh engine the
    engine does not know raises ValueError; the cp and catmesh adaptions
    and a denser target construct."""
    if case == "raymarch":
        eng = TD.TransferEngine(HDL64, HDL32, CFG, device="cpu",
                                synthesis="raymarch")
        assert tuple(eng.rays.shape) == (HDL32.H * HDL32.W, 3)
        with pytest.raises(ValueError, match="synthesis"):
            TD.TransferEngine(HDL64, HDL32, CFG, device="cpu",
                              synthesis="mesh")
    else:
        eng = TD.TransferEngine(HDL64, HDL32, TransferConfig(
            adaption="catmesh"), device="cpu", catmesh_engine="oracle")
        assert eng.catmesh_engine == "oracle" and not eng._mm_family_fast
        with pytest.raises(ValueError, match="catmesh_engine"):
            TD.TransferEngine(HDL64, HDL32, TransferConfig(
                adaption="catmesh"), device="cpu", catmesh_engine="bvh")
    dense = SensorSpec(name="dense", beams=128, fov_up=3.0, fov_down=-25.0,
                       angle_res_hor=360.0 / 2048.0)
    for adaption, target in (("cp", HDL32), ("catmesh", HDL32),
                             ("mergemesh", dense)):
        TD.TransferEngine(HDL64, target, TransferConfig(adaption=adaption),
                          device="cpu")


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises: no
    wrapper falls back to its plain version."""
    meta = torch.device("meta")
    pix = torch.zeros(8, dtype=torch.int32, device=meta)
    key = torch.zeros(8, dtype=torch.float32, device=meta)
    with pytest.raises(ValueError):
        TP.zbuffer_winners(pix, key, 16)
    with pytest.raises(ValueError):
        TF.confusion_matrix(pix, pix, 4)
    spec = TS.VolumeSpec((0.0, 0.0, 0.0), 0.5, (2, 2, 2))
    state = TS.TSDFState(*(t.to(meta) for t in spec.init_state()))
    img = torch.zeros((2, 4), device=meta)
    with pytest.raises(ValueError):
        integrate_cuda(state, spec, img, img.to(torch.int32), img,
                       fov_up_deg=3.0, fov_down_deg=-25.0)
    stack = img[None].repeat(3, 1, 1)
    with pytest.raises(ValueError):
        integrate_chain_cuda(state, spec, stack, stack.to(torch.int32),
                             stack, fov_up_deg=3.0, fov_down_deg=-25.0)
    with pytest.raises(ValueError):
        precompute_geometry_cuda(spec, 3.0, -25.0, 2, device=meta)
    with pytest.raises(ValueError):
        raycast_mesh(torch.zeros(3, device=meta),
                     torch.zeros((4, 3), device=meta),
                     torch.zeros((2, 3, 3), device=meta))


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system through lidar_transfer_tpu_torch
    alone: no module of jax or of the JAX package is imported by it."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "lidar_transfer_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "lidar_transfer_tpu"}, names
