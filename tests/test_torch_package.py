"""Package rules of the PyTorch port: no jax, no build at import, no
silent fallback.

The kernels are held against their plain versions on the card by
``chip_smoke.py``; a CUDA kernel has no CPU mode to test here.
"""

import ast
import os
import pkgutil
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
from lidar_transfer_tpu_torch.ops.tsdf_cuda import (integrate_chain_cuda,
                                                    integrate_cuda,
                                                    precompute_geometry_cuda)
from lidar_transfer_tpu_torch.pipeline import deform as TD
from lidar_transfer_tpu_torch.pipeline.multiscan import ScanWindow

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
    assert names == ["confusion.cu", "errors.cu", "probe_ablate.cu",
                     "probe_parts.cu", "probe_write.cu", "tsdf_common.cuh",
                     "tsdf_geometry.cu", "tsdf_integrate.cu", "zbuffer.cu"]
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


def test_cpu_calls_launch_no_kernel(small_spec):
    """CPU tensors take the plain versions: every launch count stays 0,
    on the mergemesh path and on the mesh path with its chain and
    geometry table."""
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
    assert _build.launch_counts() == {
        "zbuffer": 0, "confusion": 0, "tsdf_integrate": 0,
        "tsdf_integrate_chain": 0, "tsdf_geometry": 0, "probe_parts": 0,
        "probe_ablate": 0, "probe_write": 0}


@pytest.mark.parametrize("case", ["raymarch", "catmesh_oracle"])
def test_engine_refuses_unported(case):
    """Raymarch synthesis and catmesh's oracle engine raise
    NotImplementedError instead of routing elsewhere; the cp and catmesh
    adaptions and a denser target construct."""
    kw, cfg = {}, CFG
    if case == "raymarch":
        kw = dict(synthesis="raymarch")
    else:
        cfg = TransferConfig(adaption="catmesh")
        kw = dict(catmesh_engine="oracle")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TD.TransferEngine(HDL64, HDL32, cfg, device="cpu", **kw)
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
