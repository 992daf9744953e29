#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidar_transfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the three CUDA kernels from ``lidar_transfer_tpu_torch/csrc`` and
   holds each against its plain PyTorch version on the card: the z-buffer
   bit-exact, the confusion counts exact, the TSDF integrate's label and
   weight equal on >= 1 - 1e-6 of voxels with tsdf/rem within 1e-5.
2. Drives the main path at the reference operating point (HDL64 64x2048
   source, voxel 0.05 m, bounds +-50/+-50/+-5 m, one scan per window, fixed
   bounds): the CLI as identity (IoU/Acc/MSE through the confusion kernel),
   as HDL64 -> HDL32 per frame and with --stream 4, then
   ``TransferEngine.fused_state()`` on the 2048x2048x208 f32 volume. Every
   kernel's launch count must be > 0 after this phase.
3. Checks the outputs: files written, the stream equal to the per-frame run,
   the card's virtual scan against the port's CPU run of the same frame, two
   X-slabs of the fused volume against the plain integrate.
4. Times each kernel against its plain version, transfer_fast per frame,
   the stream rate and the integrate rate, each with the GPU's name and
   power limit, and profiles transfer_fast for its device time, device
   launches and idle share per frame.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels as JSON. Any failed check raises, and the exit code is
then nonzero. Without a CUDA device it exits with 1 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.metrics import confusion as TF
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda

    dev = torch.device("cuda")
    gpu = _gpu_line()
    print(gpu)
    tag = f"[{gpu}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    rng = np.random.default_rng(0)
    kernels = {}

    # ---------------------------------------------------- 1. kernel checks
    n, npix = 139264, 64 * 2048
    pix = rng.integers(0, npix, n).astype(np.int32)
    key = rng.uniform(1.0, 80.0, n).astype(np.float32)
    tie = rng.integers(0, n - 1, n // 5)
    pix[tie + 1], key[tie + 1] = pix[tie], key[tie]      # exact-key ties
    pix[rng.random(n) < 0.1] = npix                      # invalid points
    pix_t = torch.from_numpy(pix).to(dev)
    key_t = torch.from_numpy(key).to(dev)
    got = TP.zbuffer_winners(pix_t, key_t, npix)
    ref = TP.zbuffer_winners_plain(pix_t, key_t, npix)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    print(f"zbuffer N={n} npix={npix}: mismatches "
          f"{int((got != ref).sum())}, winners {int((ref >= 0).sum())}")
    check(torch.equal(got, ref), "zbuffer kernel != plain (bit-exact)")
    kernels["zbuffer"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/zbuffer.cu",
        replaces="lidar_transfer_tpu/ops/projection.py:209",
        max_abs_err=err,
        ms=_cuda_ms(torch, lambda: TP.zbuffer_winners(pix_t, key_t, npix),
                    200),
        plain_ms=_cuda_ms(torch, lambda: TP.zbuffer_winners_plain(
            pix_t, key_t, npix), 50))

    m, C = 131072, 260
    pred = rng.choice([0, 10, 40, 48, 50, 70, 252], m).astype(np.int32)
    tgt = np.where(rng.random(m) < 0.8, pred,
                   rng.integers(-3, C + 3, m)).astype(np.int32)
    pred[rng.random(m) < 0.02] = -1
    pred_t = torch.from_numpy(pred).to(dev)
    tgt_t = torch.from_numpy(tgt).to(dev)
    got = TF.confusion_matrix(pred_t, tgt_t, C)
    ref = TF.confusion_scatter(pred_t, tgt_t, C)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    print(f"confusion N={m} C={C}: total {int(got.sum())} "
          f"(plain {int(ref.sum())}), max |diff| {err}")
    check(torch.equal(got, ref), "confusion kernel != plain (exact)")
    kernels["confusion"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/confusion.cu",
        replaces="lidar_transfer_tpu/metrics/confusion.py:73",
        max_abs_err=err,
        ms=_cuda_ms(torch, lambda: TF.confusion_matrix(pred_t, tgt_t, C),
                    200),
        plain_ms=_cuda_ms(torch, lambda: TF.confusion_scatter(
            pred_t, tgt_t, C), 50))

    spec = TS.VolumeSpec((-6.4, -6.4, -5.0), 0.05, (256, 256, 208))
    depth = (rng.uniform(1.0, 12.0, (64, 2048))
             * (rng.random((64, 2048)) > 0.2)).astype(np.float32)
    imgs = [torch.from_numpy(a).to(dev) for a in (
        depth, rng.integers(0, 30, (64, 2048)).astype(np.int32),
        rng.random((64, 2048)).astype(np.float32))]
    gen = torch.Generator(device=dev).manual_seed(0)
    prior = TS.TSDFState(
        tsdf=torch.rand(spec.dims, device=dev, generator=gen) * 2 - 1,
        weight=torch.randint(0, 3, spec.dims, device=dev,
                             generator=gen).float(),
        label=torch.randint(0, 30, spec.dims, device=dev, generator=gen,
                            dtype=torch.int32),
        rem=torch.rand(spec.dims, device=dev, generator=gen))
    nvox = spec.num_voxels
    worst = 0.0
    for reset in (True, False):
        for write_weight in (True, False):
            kw = dict(fov_up_deg=3.0, fov_down_deg=-25.0, reset=reset,
                      write_weight=write_weight)
            a = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)),
                               spec, *imgs, **kw)
            b = TS.integrate(TS.TSDFState(*(t.clone() for t in prior)),
                             spec, *imgs, **kw)
            torch.cuda.synchronize()
            bad_l = int((a.label != b.label).sum())
            bad_w = int((a.weight != b.weight).sum())
            same = a.label == b.label
            dt = float((a.tsdf - b.tsdf)[same].abs().max())
            dr = float((a.rem - b.rem)[same].abs().max())
            worst = max(worst, dt, dr)
            print(f"integrate {spec.dims} reset={reset} "
                  f"write_weight={write_weight}: label mismatches {bad_l}, "
                  f"weight mismatches {bad_w} of {nvox}, max |tsdf| {dt:g}, "
                  f"max |rem| {dr:g}")
            check(bad_l <= nvox * 1e-6 and bad_w <= nvox * 1e-6,
                  "integrate label/weight mismatch above 1e-6")
            check(dt <= 1e-5 and dr <= 1e-5,
                  "integrate tsdf/rem beyond 1e-5")
            del a, b
    del prior
    kernels["tsdf_integrate"] = dict(
        route="cuda",
        source="lidar_transfer_tpu_torch/csrc/tsdf_integrate.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:372",
        max_abs_err=worst)

    # ------------------------------------------------------ 2. main path
    with tempfile.TemporaryDirectory(prefix="lt_smoke_") as work:
        rows = _main_path(torch, work, kernels, tag)
    check("jax" not in sys.modules, "the port imported jax")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _main_path(torch, work, kernels, tag):
    """Phases 2-4 in the scratch directory ``work``; returns the kernel
    rows of the JSON line."""
    from lidar_transfer_tpu_torch import _build, cli
    from lidar_transfer_tpu_torch.config import (HDL64, SensorSpec,
                                                 TransferConfig)
    from lidar_transfer_tpu_torch.datasets import kitti, synthetic
    from lidar_transfer_tpu_torch.ops import projection as TP
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import (load_window,
                                                             merge_window,
                                                             stack_windows)

    dev = torch.device("cuda")
    ds = os.path.join(work, "kitti")
    synthetic.write_kitti_dataset(ds, synthetic.Scene.default(), HDL64,
                                  n_scans=6)
    cfg = TransferConfig(voxel_size=0.05, voxel_bounds=(
        (-50.0, 50.0), (-50.0, 50.0), (-5.0, 5.0)))
    cfg_path = os.path.join(work, "transfer.yaml")
    cfg.to_yaml(cfg_path)
    hdl32_path = os.path.join(REPO, "configs", "hdl32.yaml")
    hdl32 = SensorSpec.from_yaml(hdl32_path)
    base = ["-d", ds, "-c", cfg_path, "--fixed-bounds", "-b", "-w"]

    def run_cli(name, *extra):
        out = os.path.join(work, name)
        mj = os.path.join(work, f"{name}.json")
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(base + ["-p", out, "--metrics-json", mj,
                                  *extra])
        text = buf.getvalue()
        print(text, end="")
        check(rc == 0, f"cli {name} exit code {rc}")
        print(f"cli {name}: {time.perf_counter() - t:.2f} s wall")
        with open(mj) as f:
            return out, json.load(f), text

    _build.reset_launch_counts()
    _, m_id, text = run_cli("identity")
    for key in ("IoU: ", "Acc: ", "MSE: ", "Took: "):
        check(text.count(key) == 6, f"identity run printed {key!r} lines")
    out_x, m_x, _ = run_cli("cross", "-t", hdl32_path)
    out_s, m_s, _ = run_cli("stream", "-t", hdl32_path, "--stream", "4")

    seq = kitti.KittiSequence.open(ds)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev)
    w0 = load_window(seq, cfg, 0, cap, dev)
    vs_card = eng.transfer_fast(w0)
    t = time.perf_counter()
    state = eng.fused_state()
    torch.cuda.synchronize()
    print(f"fused_state {tuple(state.tsdf.shape)} f32: "
          f"{time.perf_counter() - t:.2f} s first call (allocation "
          f"included), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB {tag}")
    counts = _build.launch_counts()
    print(f"launches on the main path: {counts}")
    for k, c in counts.items():
        check(c > 0, f"kernel {k} never launched on the main path")

    # ---------------------------------------------------- 3. output checks
    check(tuple(state.tsdf.shape) == (2048, 2048, 208),
          f"volume dims {tuple(state.tsdf.shape)}")
    written = int((state.tsdf < 1).sum())
    print(f"fused volume: {written} voxels with tsdf < 1")
    check(written > 0, "fused volume has no surface")
    for name, ms in (("identity", m_id), ("cross", m_x), ("stream", m_s)):
        check(len(ms) == 6, f"{name}: {len(ms)} frames")
        for fm in ms:
            lbl = os.path.join(work, name, "sequences", "00", "labels",
                               f"{fm['index']:06d}.label")
            check(os.path.getsize(lbl) == 4 * fm["points_written"],
                  f"{name}: label file of frame {fm['index']}")
    fill = [fm["points_written"] / (hdl32.H * hdl32.W) for fm in m_x]
    print(f"cross mask fill per frame: {[round(f, 4) for f in fill]}")
    check(min(fill) > 0, "cross transfer wrote an empty scan")
    for fm in m_id:
        check(np.isfinite([fm["iou"], fm["acc"], fm["mse"]]).all()
              and 0 < fm["iou"] <= 1, f"identity metrics {fm}")
    for sub in ("velodyne", "labels"):
        d_x = os.path.join(out_x, "sequences", "00", sub)
        d_s = os.path.join(out_s, "sequences", "00", sub)
        for fn in sorted(os.listdir(d_x)):
            with open(os.path.join(d_x, fn), "rb") as a, \
                    open(os.path.join(d_s, fn), "rb") as b:
                check(a.read() == b.read(),
                      f"--stream 4 output differs from per-frame: {sub}/{fn}")
    print("--stream 4 output == per-frame output (all files)")

    _, m_cpu, _ = run_cli("cpu", "-t", hdl32_path, "--device", "cpu",
                          "--frames", "1")
    dn = abs(m_cpu[0]["points_written"] - m_x[0]["points_written"])
    print(f"cli --device cpu frame 0: {m_cpu[0]['points_written']} points, "
          f"card {m_x[0]['points_written']}")
    check(dn <= 1e-3 * hdl32.H * hdl32.W, "CPU and card point counts")
    cpu_eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device="cpu")
    vs_cpu = cpu_eng.transfer_fast(load_window(seq, cfg, 0, cap, "cpu"))
    lc, mc = vs_card.label.cpu(), vs_card.mask.cpu()
    agree = ((lc == vs_cpu.label) & (mc == vs_cpu.mask)).float().mean()
    both = ((lc == vs_cpu.label) & mc & vs_cpu.mask)
    rerr = float((vs_card.range.cpu() - vs_cpu.range)[both].abs().max())
    print(f"card vs CPU (frame 0, HDL64->HDL32): label/mask agreement "
          f"{float(agree):.6f}, max range error {rerr:g} m")
    check(float(agree) >= 0.999, "card and CPU outputs disagree")
    check(rerr <= 1e-3, "card and CPU ranges disagree")

    pts, rem, lbl, valid = merge_window(w0)
    ri = TP.range_project(pts, rem, lbl, valid, H=HDL64.H, W=HDL64.W,
                          fov_up_deg=hdl32.fov_up,
                          fov_down_deg=hdl32.fov_down)
    per_x = (state.tsdf < 1).sum(dim=(1, 2))
    fkw = dict(fov_up_deg=hdl32.fov_up, fov_down_deg=hdl32.fov_down,
               origin=eng.vol_spec.origin, active_dims=eng.vol_dims,
               reset=True, write_weight=False)
    for x0 in (int(per_x.argmax()) // 16 * 16, 1024):
        slab = TS.VolumeSpec(eng.vol_spec.origin, eng.vol_spec.voxel_size,
                             (16,) + eng.vol_dims[1:])
        ref = TS.integrate(slab.init_state(dev), slab, ri.range, ri.label,
                           ri.remission, x_offset=x0, **fkw)
        part = TS.TSDFState(*(a[x0:x0 + 16] for a in state))
        bad = int((part.label != ref.label).sum())
        same = part.label == ref.label
        dt = float((part.tsdf - ref.tsdf)[same].abs().max())
        dr = float((part.rem - ref.rem)[same].abs().max())
        print(f"fused slab x={x0}..{x0 + 15} vs plain: label mismatches "
              f"{bad} of {part.label.numel()}, max |tsdf| {dt:g}, "
              f"max |rem| {dr:g}, surface voxels "
              f"{int((ref.tsdf < 1).sum())}")
        check(bad <= part.label.numel() * 1e-6 and dt <= 1e-5
              and dr <= 1e-5, "fused slab != plain integrate")
        del ref

    # ------------------------------------------------------------ 4. timing
    integ = lambda fn: lambda: fn(  # noqa: E731
        state, eng.vol_spec, ri.range, ri.label, ri.remission, **fkw)
    k_ms = _cuda_ms(torch, integ(integrate_cuda), 10)
    p_ms = _cuda_ms(torch, integ(TS.integrate), 2, warmup=1)
    kernels["tsdf_integrate"].update(ms=k_ms, plain_ms=p_ms)
    gvox = state.tsdf.numel() / (k_ms * 1e-3) / 1e9
    print(f"integrate {eng.vol_dims} reset, no weight write: kernel "
          f"{k_ms:.3f} ms ({gvox:.2f} Gvoxel/s), plain {p_ms:.1f} ms {tag}")

    wins = [load_window(seq, cfg, i, cap, dev) for i in range(6)]
    frame_ms = _cuda_ms(torch, lambda: [eng.transfer_fast(w)
                                        for w in wins], 20) / len(wins)
    stacked = stack_windows(wins[:4])
    stream_ms = _cuda_ms(torch, lambda: eng.transfer_stream(stacked), 20)
    print(f"transfer_fast HDL64->HDL32: {frame_ms:.3f} ms/frame "
          f"({1e3 / frame_ms:.1f} scans/s) {tag}")
    print(f"transfer_stream 4 frames: {stream_ms:.3f} ms/batch "
          f"({4e3 / stream_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, frame_ms, tag)
    for name, k in kernels.items():
        print(f"kernel {name}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
              f"ms {tag}")

    return [dict(name=name, launches=counts[name], **k)
            for name, k in kernels.items()]


def _profile_frames(torch, eng, wins, frame_ms, tag):
    """Device time and device launches per frame of ``transfer_fast`` from
    a ``torch.profiler`` trace of the frames ``wins``; the idle share is
    1 - device time / the frame time measured with CUDA events (without
    the profiler, whose own host cost would inflate the frame)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for w in wins:
            eng.transfer_fast(w)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_dev:
        print("transfer_fast device time: not measured (the profiler "
              f"recorded no device activity) {tag}")
        return
    dev_ms = sum(e.time_range.elapsed_us() for e in on_dev) / 1e3 / len(wins)
    top = {}
    for e in on_dev:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
    lead = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    print(f"transfer_fast device time {dev_ms:.4f} ms/frame, "
          f"{len(on_dev) / len(wins):.1f} device launches/frame, idle share "
          f"{1 - dev_ms / frame_ms:.3f} of {frame_ms:.3f} ms {tag}")
    print("  leading device ops (us over the trace): " + "; ".join(
        f"{n[:60]} {us:.1f}" for n, us in lead))


if __name__ == "__main__":
    sys.exit(main())
