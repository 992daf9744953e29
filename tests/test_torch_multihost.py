"""The port's ``parallel/multihost.py`` dryrun, two processes on the CPU
(gloo), against one process's results.

As ``tests/test_multihost.py`` holds the JAX dryrun: two OS processes join
one process group (``--init-method file://`` under ``tmp_path``), each
loads only its own frame and runs the frame-parallel transfer, the
confusion counts are summed across them; the frames gathered on rank 0
equal the port's single-process ``transfer_fast`` of the same windows bit
for bit. With ``--sharded-volume`` the two ranks fuse and synthesise from
X-slabs of a (1, 2) mesh, each asserting the scan equal to its own
whole-volume run. The per-rank frame split (``local_frame_indices``) and
``load_global_windows`` are held against JAX's ``local_frame_indices``
layout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.datasets import kitti
from lidar_transfer_tpu_torch.pipeline.deform import TransferEngine
from lidar_transfer_tpu_torch.pipeline.multiscan import load_window
from lidar_transfer_tpu_torch.utils.runtime import cpu_warmup
from torch_suite import shared_cores, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _cpu_warmup():
    """PyTorch's first threaded asin and sqrt of a process on the CPU are
    at times off in one thread's share: taken here, before this module's
    tensor work (``utils/runtime.cpu_warmup``)."""
    cpu_warmup()


def _dryrun(tmp_path, n_proc, *extra):
    """Run the dryrun on ``n_proc`` processes; -> their logs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lidar_transfer_tpu_torch.parallel.multihost",
         "--init-method", f"file://{tmp_path / 'pg'}", "--num-processes",
         str(n_proc), "--process-id", str(pid), "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for pid in range(n_proc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-4000:]}"
        assert f"process {pid}: OK" in log
    assert not any("jax" in log for log in logs)
    return logs


def test_multi_process_dryrun(synthetic_dataset, tmp_path):
    """Two processes, one frame each: rank 0's gathered frames equal the
    single-process ``transfer_fast`` of frames 0 and 1 bit for bit, and the
    confusion counts summed across the processes cover every pixel."""
    out = str(tmp_path / "mh0.npz")
    logs = _dryrun(tmp_path, 2, "--dataset", synthetic_dataset, "--out",
                   out)
    assert all("2 frames over 2 ranks (gloo, cpu)" in log for log in logs)
    res = np.load(out)
    assert res["hit"] > 0.05
    assert res["conf_total"] == res["label"].size
    seq = kitti.KittiSequence.open(synthetic_dataset)
    source = SensorSpec.from_yaml(os.path.join(synthetic_dataset,
                                               "config.yaml"))
    cfg = TransferConfig(adaption="mergemesh", number_of_scans=1,
                         voxel_size=0.25,
                         voxel_bounds=((-16.0, 16.0), (-16.0, 16.0),
                                       (-4.0, 4.0)))
    eng = TransferEngine(source, source, cfg, fixed_bounds=True,
                         device="cpu")
    assert list(res["frame_indices"]) == [0, 1]
    for k, idx in enumerate(res["frame_indices"]):
        vs = eng.transfer_fast(load_window(seq, cfg, int(idx), 8192))
        np.testing.assert_array_equal(res["range"][k], vs.range.numpy())
        np.testing.assert_array_equal(res["label"][k], vs.label.numpy())
        np.testing.assert_array_equal(res["mask"][k], vs.mask.numpy())


def test_multihost_sharded_volume(tmp_path):
    """Two processes, X-slabs over the (1, 2) mesh: fusion and synthesis
    asserted bit-identical to the whole volume by every process
    (``multihost.sharded_volume_parity``)."""
    out = str(tmp_path / "sv0.npz")
    logs = _dryrun(tmp_path, 2, "--sharded-volume", "--out", out)
    for pid, log in enumerate(logs):
        assert f"process {pid}: SHARDED-VOLUME OK" in log
        assert "bit-identical to one process" in log
    res = np.load(out)
    assert res["hit"] > 0.0 and res["n_shards"] == 2


def test_local_frames_follow_the_data_axis():
    """``local_frame_indices`` gives each data row its consecutive share
    of the batch, as JAX's (P("data") in device order), the ranks of one
    row (replicated over "model") the same frames; a batch the data axis
    does not divide raises."""
    from lidar_transfer_tpu_torch.parallel import multihost

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shape, coord):
            self.shape, self.coord = shape, coord

        def get_coordinate(self):
            return self.coord

    frames = [10, 11, 12, 13, 14, 15]
    assert multihost.local_frame_indices(frames, Mesh((3, 2), (1, 0))) \
        == [12, 13]
    assert multihost.local_frame_indices(frames, Mesh((3, 2), (1, 1))) \
        == [12, 13]
    assert multihost.local_frame_indices(frames, Mesh((6, 1), (5, 0))) \
        == [15]
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_frame_indices(frames, Mesh((4, 1), (0, 0)))
    with pytest.raises(RuntimeError, match="process group"):
        from lidar_transfer_tpu_torch.parallel import make_mesh

        assert not torch.distributed.is_initialized()
        make_mesh()
