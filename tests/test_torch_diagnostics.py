"""The port's miss decomposition (``metrics/diagnostics``) against the JAX
package's ``lidar_transfer_tpu.metrics.diagnostics.miss_decomposition``
(CPU).

The hand-built scene of ``tests/test_diagnostics.py`` with its exact
counts, and engine frames: the merged cloud of a synthetic window and the
JAX engine's hit mask through both functions. Tolerance: each count within
0.1 % of the target pixels of the JAX count (an atan2/asin ulp can move a
source return across a pixel boundary of the projection); the five counts
sum to H * W exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_transfer_tpu.config import SensorSpec, TransferConfig
from lidar_transfer_tpu.datasets import kitti, synthetic
from lidar_transfer_tpu.metrics import diagnostics as JDG
from lidar_transfer_tpu.pipeline import deform as JD
from lidar_transfer_tpu.pipeline import multiscan as JM
from lidar_transfer_tpu_torch import _build
from lidar_transfer_tpu_torch.metrics import diagnostics as TDG
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


#: counts within this share of the target pixels of the JAX counts
SHARE = 1e-3

SOURCE = SensorSpec(name="src32", beams=32, fov_up=5.0, fov_down=-24.0,
                    angle_res_hor=360.0 / 512.0)
CROSS = SensorSpec(name="tgt16", beams=16, fov_up=8.0, fov_down=-22.0,
                   angle_res_hor=360.0 / 256.0)
CFG = TransferConfig(voxel_size=0.25,
                     voxel_bounds=((-16.0, 16.0), (-16.0, 16.0), (-4.0, 4.0)))


def _scene():
    """tests/test_diagnostics.py's scene: target 8x16 over 8..-22 deg,
    source fov 4..-18 deg; one return per pixel centre of rows 2..5,
    columns 0..7, the far half (columns 4..7) 30 m out, outside the
    volume; the scan hit rows 2..4 of the near half."""
    H, W = 8, 16
    t_fu, t_fd = 8.0, -22.0
    fov = np.deg2rad(abs(t_fu) + abs(t_fd))
    pts = []
    for r in range(2, 6):
        pitch = np.deg2rad(t_fu) - (r + 0.5) / H * fov
        for c in range(8):
            yaw_g = -((c + 0.5) / W * 2.0 - 1.0) * np.pi
            d = 5.0 if c < 4 else 30.0
            pts.append([d * np.cos(pitch) * np.cos(yaw_g),
                        d * np.cos(pitch) * np.sin(yaw_g),
                        d * np.sin(pitch)])
    pts = np.asarray(pts, np.float32)
    vs_mask = np.zeros((H, W), bool)
    vs_mask[2:5, 0:4] = True
    kw = dict(target_H=H, target_W=W, t_fov_up=t_fu, t_fov_down=t_fd,
              s_fov_up=4.0, s_fov_down=-18.0,
              vol_bounds=np.array([[-16.0, 16.0], [-16.0, 16.0],
                                   [-4.0, 4.0]]))
    return pts, np.ones(len(pts), bool), vs_mask, kw


def test_decomposition_exhaustive_and_attributed():
    """Each planted cause in its own bucket, with the JAX test's exact
    counts; the buckets and the hits partition the image; the counts are
    0-dim int32 tensors; the plain projection launched no kernel."""
    pts, valid, vs_mask, kw = _scene()
    _build.reset_launch_counts()
    dec = TDG.miss_decomposition(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(vs_mask), **kw)
    assert all(v.dim() == 0 and v.dtype == torch.int32 for v in dec)
    d = dec.as_dict()
    H, W = kw["target_H"], kw["target_W"]
    assert sum(d.values()) == H * W
    assert d == dict(hit=12, out_of_source_fov=2 * W, empty_direction=2 * W
                     + 4 * 8, outside_volume=16, synthesis_miss=4)
    assert sum(dec.rates().values()) == pytest.approx(1.0)
    assert dec.rates()["hit"] == pytest.approx(12 / (H * W))
    assert _build.launch_counts()["zbuffer"] == 0


def test_scene_matches_jax():
    """The same scene through the JAX function: the same five counts."""
    pts, valid, vs_mask, kw = _scene()
    j = JDG.miss_decomposition(jnp.asarray(pts), jnp.asarray(valid),
                               jnp.asarray(vs_mask), **kw).as_dict()
    t = TDG.miss_decomposition(torch.from_numpy(pts),
                               torch.from_numpy(valid),
                               torch.from_numpy(vs_mask), **kw).as_dict()
    assert t == j


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("diag_kitti"))
    beams = SensorSpec(name=SOURCE.name, beams=SOURCE.beams,
                       fov_up=SOURCE.fov_up - 0.5,
                       fov_down=SOURCE.fov_down + 0.5,
                       angle_res_hor=SOURCE.angle_res_hor)
    synthetic.write_kitti_dataset(root, synthetic.Scene.default(), beams,
                                  n_scans=3)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump(SOURCE.to_dict(), f)
    seq = kitti.KittiSequence.open(root)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    return seq, cap


def _beam_target():
    """A 16-beam target with a beam table (radians; rows are beams)."""
    ba = np.deg2rad(np.linspace(-21.0, 7.0, 16))
    return SensorSpec(name="tgt16b", beams=16, fov_up=8.0, fov_down=-22.0,
                      angle_res_hor=360.0 / 256.0,
                      beam_angles=tuple(float(b) for b in ba))


@pytest.mark.parametrize("target", ["cross", "identity", "beams"])
@pytest.mark.parametrize("fixed", [True, False])
def test_engine_frame_matches_jax(dataset, target, fixed):
    """The merged cloud of a synthetic window and the JAX engine's hit
    mask of its transfer_fast frame: each count within SHARE of the
    target pixels of the JAX count, the port's counts summing to H * W;
    the frame has misses of at least three causes."""
    seq, cap = dataset
    tgt = {"cross": CROSS, "identity": SOURCE,
           "beams": _beam_target()}[target]
    je = JD.TransferEngine(SOURCE, tgt, CFG, cap, fixed_bounds=fixed)
    w = JM.load_window(seq, CFG, 1, cap)
    vs = je.transfer_fast(w)
    mpts, _, _, mvalid = JM.merge_window(w)
    ba = (None if tgt.beam_angles is None
          else np.asarray(tgt.beam_angles, np.float32))
    kw = dict(target_H=tgt.H, target_W=tgt.W, t_fov_up=tgt.fov_up,
              t_fov_down=tgt.fov_down, s_fov_up=SOURCE.fov_up,
              s_fov_down=SOURCE.fov_down, vol_bounds=CFG.voxel_bounds_array,
              beam_angles=ba)
    j = JDG.miss_decomposition(mpts, mvalid, vs.mask, **kw).as_dict()
    t = TDG.miss_decomposition(
        *(torch.from_numpy(np.array(a)) for a in (mpts, mvalid, vs.mask)),
        **kw).as_dict()
    npix = tgt.H * tgt.W
    assert sum(t.values()) == npix
    for k in j:
        assert abs(t[k] - j[k]) <= SHARE * npix, (k, t, j)
    assert sum(1 for k, v in t.items() if k != "hit" and v > 0) >= 3, t
