#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lidar_transfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from ``lidar_transfer_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and holds each against its plain PyTorch
   version on the card: the z-buffer bit-exact, the confusion counts exact,
   the TSDF integrate (float32 and compact state, with and without the
   geometry table) and its S-scan chain (S=3, 256x256x208) with label and
   weight equal on >= 1 - 1e-6 of voxels, float32 tsdf/rem within 1e-5 and
   compact ones within one bf16 ulp, the geometry table's rows equal on
   >= 1 - 1e-6 of voxels.
2. Drives each path at the reference operating point (HDL64 64x2048
   source, voxel 0.05 m, bounds +-50/+-50/+-5 m, fixed bounds), with the
   launch counts set to 0 just before it and read just after:
   - mergemesh, one scan per window: the CLI as identity (IoU/Acc/MSE
     through the confusion kernel), as HDL64 -> HDL32 per frame and with
     --stream 4, then ``TransferEngine.fused_state()`` on the 2048x2048x208
     float32 volume;
   - mesh, three scans per window: the CLI as identity and as HDL64 ->
     HDL32, and with --ply on one frame, then ``fused_state()`` (the
     S-scan chain with the geometry table) with a float32 and a compact
     volume.
   Every kernel of a path must have launched in its run.
3. Checks the outputs: files written, the stream equal to the per-frame run,
   the card's virtual scans against the port's CPU run of the same frame,
   16-plane X-slabs of the fused volumes against the plain integrate and
   the plain chain, a non-empty PLY.
4. Times each kernel against its plain version (the chain and the table at
   2048x2048x208; the integrate with and without the table),
   transfer_fast per frame of both adaptions, the stream rate,
   fused_state() and export_mesh(), each with the GPU's name and power
   limit, and profiles transfer_fast of both adaptions for its device
   time, device launches and idle share per frame.

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


def _bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 bits of mantissa), float32."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _compare_states(torch, a, b, what: str) -> float:
    """Hold state ``a`` (kernel) against ``b`` (plain): label and weight
    equal on >= 1 - 1e-6 of voxels; where labels agree, float32 tsdf/rem
    within 1e-5, compact ones within one bf16 ulp. -> max |tsdf|, |rem|
    difference."""
    n = a.label.numel()
    bad_l = int((a.label != b.label).sum())
    bad_w = int((a.weight != b.weight).sum())
    same = a.label == b.label
    compact = a.tsdf.dtype == torch.bfloat16
    worst = 0.0
    for f in ("tsdf", "rem"):
        x = getattr(a, f)[same].float()
        y = getattr(b, f)[same].float()
        d = (x - y).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = (bool((d <= _bf16_ulp(torch, y)).all()) if compact
              else worst <= 1e-5)
        check(ok, f"{what}: {f} beyond " +
              ("one bf16 ulp" if compact else "1e-5"))
    print(f"{what}: label mismatches {bad_l}, weight mismatches {bad_w} "
          f"of {n}, max |tsdf|/|rem| {worst:g}")
    check(bad_l <= n * 1e-6 and bad_w <= n * 1e-6,
          f"{what}: label/weight mismatch above 1e-6")
    return worst


def _check_fusion_kernels(torch, rng, kernels) -> None:
    """Phase 1 for the chain, the compact state and the geometry table at
    256x256x208, S=3, against their plain versions."""
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, integrate_cuda, precompute_geometry_cuda)

    dev = torch.device("cuda")
    spec = TS.VolumeSpec((-6.4, -6.4, -5.0), 0.05, (256, 256, 208))
    fov = dict(fov_up_deg=3.0, fov_down_deg=-25.0)
    S, H, W = 3, 64, 2048
    depth = (rng.uniform(1.0, 12.0, (S, H, W))
             * (rng.random((S, H, W)) > 0.2)).astype(np.float32)
    stacks = [torch.from_numpy(a).to(dev) for a in (
        depth, rng.integers(0, 4, (S, H, W)).astype(np.int32),
        rng.random((S, H, W)).astype(np.float32))]

    table = precompute_geometry_cuda(spec, 3.0, -25.0, H, device=dev)
    plain = TS.precompute_geometry(spec, 3.0, -25.0, H, device=dev)
    torch.cuda.synchronize()
    bad = int((table != plain).sum())
    row_err = int((table.int() - plain.int()).abs().max())
    print(f"geometry table {spec.dims}: row mismatches {bad} of "
          f"{table.numel()}, max |row diff| {row_err}, in FOV "
          f"{float((plain >= 0).float().mean()):.4f}")
    check(bad <= table.numel() * 1e-6, "geometry table != plain table")
    kernels["tsdf_geometry"] = dict(
        route="cuda", source="lidar_transfer_tpu_torch/csrc/tsdf_geometry.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:436",
        max_abs_err=row_err)

    worst = 0.0
    for compact in (False, True):
        for v_tab in (None, table):
            what = (f"chain S={S} {spec.dims} "
                    f"{'compact' if compact else 'f32'} table="
                    f"{v_tab is not None}")
            a = integrate_chain_cuda(spec.init_state(dev, compact), spec,
                                     *stacks, v_tab=v_tab, **fov)
            b = TS.integrate_chain(spec.init_state(dev, compact), spec,
                                   *stacks, v_tab=v_tab, **fov)
            torch.cuda.synchronize()
            worst = max(worst, _compare_states(torch, a, b, what))
            del a, b
        # the single integrate, compact, with the table, reset and carried
        prior = TS.integrate_chain(spec.init_state(dev, compact), spec,
                                   *stacks, **fov)
        for reset in (True, False):
            one = [t[0] for t in stacks]
            a = integrate_cuda(TS.TSDFState(*(t.clone() for t in prior)),
                               spec, *one, reset=reset, v_tab=table, **fov)
            b = TS.integrate(TS.TSDFState(*(t.clone() for t in prior)),
                             spec, *one, reset=reset, **fov)
            torch.cuda.synchronize()
            _compare_states(torch, a, b, f"integrate table=True "
                            f"{'compact' if compact else 'f32'} "
                            f"reset={reset} (plain without the table)")
            del a, b
        del prior
    kernels["tsdf_integrate_chain"] = dict(
        route="cuda",
        source="lidar_transfer_tpu_torch/csrc/tsdf_integrate.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:667",
        max_abs_err=worst)


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
            worst = max(worst, _compare_states(
                torch, a, b, f"integrate {spec.dims} reset={reset} "
                f"write_weight={write_weight}"))
            del a, b
    del prior
    kernels["tsdf_integrate"] = dict(
        route="cuda",
        source="lidar_transfer_tpu_torch/csrc/tsdf_integrate.cu",
        replaces="lidar_transfer_tpu/ops/tsdf_pallas.py:372",
        max_abs_err=worst)
    _check_fusion_kernels(torch, rng, kernels)

    # ------------------------------------------------------ 2. main path
    with tempfile.TemporaryDirectory(prefix="lt_smoke_") as work:
        counts = _main_path(torch, work, kernels, tag)
        torch.cuda.empty_cache()
        mesh_counts = _mesh_path(torch, work, kernels, tag)
    check("jax" not in sys.modules, "the port imported jax")
    for name, k in kernels.items():
        print(f"kernel {name}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
              f"ms {tag}")
    rows = [dict(name=name, launches=counts[name] + mesh_counts[name], **k)
            for name, k in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run_cli(work, base, name, *extra):
    """Run the port's CLI with ``base + extra`` and its output under
    ``work/name``; -> (output dir, per-frame metrics, printed text)."""
    from lidar_transfer_tpu_torch import cli

    out = os.path.join(work, name)
    mj = os.path.join(work, f"{name}.json")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(base + ["-p", out, "--metrics-json", mj, *extra])
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli {name} exit code {rc}")
    print(f"cli {name}: {time.perf_counter() - t:.2f} s wall")
    with open(mj) as f:
        return out, json.load(f), text


def _main_path(torch, work, kernels, tag):
    """Phases 2-4 of the mergemesh path in the scratch directory ``work``
    (it writes the synthetic dataset ``work/kitti``); returns the launch
    counts of the path."""
    from lidar_transfer_tpu_torch import _build
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
        return _run_cli(work, base, name, *extra)

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
    print(f"launches on the mergemesh path: {counts}")
    for k in ("zbuffer", "confusion", "tsdf_integrate"):
        check(counts[k] > 0, f"kernel {k} never launched on the "
              "mergemesh path")

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
    for x0 in (int(per_x.argmax()) // 16 * 16, eng.vol_dims[0] // 2):
        slab = TS.VolumeSpec(eng.vol_spec.origin, eng.vol_spec.voxel_size,
                             (16,) + eng.vol_dims[1:])
        ref = TS.integrate(slab.init_state(dev), slab, ri.range, ri.label,
                           ri.remission, x_offset=x0, **fkw)
        _compare_states(torch, TS.TSDFState(*(a[x0:x0 + 16]
                                              for a in state)), ref,
                        f"fused slab x={x0}..{x0 + 15} vs plain integrate "
                        f"({int((ref.tsdf < 1).sum())} surface voxels)")
        del ref

    # ------------------------------------------------------------ 4. timing
    integ = lambda fn: lambda: fn(  # noqa: E731
        state, eng.vol_spec, ri.range, ri.label, ri.remission, **fkw)
    k_ms = _cuda_ms(torch, integ(integrate_cuda), 10)
    p_ms = _cuda_ms(torch, integ(TS.integrate), 2, warmup=1)
    geom = eng._ensure_geom(hdl32.fov_up, hdl32.fov_down, HDL64.H)
    kt_ms = _cuda_ms(torch, lambda: integrate_cuda(
        state, eng.vol_spec, ri.range, ri.label, ri.remission, v_tab=geom,
        **fkw), 10)
    kernels["tsdf_integrate"].update(ms=k_ms, plain_ms=p_ms)
    gvox = state.tsdf.numel() / (k_ms * 1e-3) / 1e9
    print(f"integrate {eng.vol_dims} reset, no weight write: kernel "
          f"{k_ms:.3f} ms ({gvox:.2f} Gvoxel/s), with the geometry table "
          f"{kt_ms:.3f} ms, plain {p_ms:.1f} ms {tag}")

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
    return counts


def _mesh_path(torch, work, kernels, tag):
    """Phases 2-4 of the mesh adaption, three scans per window, on the
    dataset ``work/kitti``; returns the launch counts of the path."""
    from lidar_transfer_tpu_torch import _build
    from lidar_transfer_tpu_torch.config import (HDL64, SensorSpec,
                                                 TransferConfig)
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.ops import tsdf as TS
    from lidar_transfer_tpu_torch.ops.tsdf_cuda import (
        integrate_chain_cuda, precompute_geometry_cuda)
    from lidar_transfer_tpu_torch.pipeline import deform as TD
    from lidar_transfer_tpu_torch.pipeline.multiscan import load_window

    dev = torch.device("cuda")
    ds = os.path.join(work, "kitti")
    cfg = TransferConfig(adaption="mesh", number_of_scans=3,
                         voxel_size=0.05, voxel_bounds=(
                             (-50.0, 50.0), (-50.0, 50.0), (-5.0, 5.0)))
    cfg_path = os.path.join(work, "mesh.yaml")
    cfg.to_yaml(cfg_path)
    hdl32_path = os.path.join(REPO, "configs", "hdl32.yaml")
    hdl32 = SensorSpec.from_yaml(hdl32_path)
    base = ["-d", ds, "-c", cfg_path, "--fixed-bounds", "-b", "-w"]
    seq = kitti.KittiSequence.open(ds)
    cap = kitti.scan_capacity(max(os.path.getsize(f) // 16
                                  for f in seq.scan_files))
    n_frames = len(seq) - 2                     # primaries 1 .. len - 2
    ply = os.path.join(work, "ply")

    # ------------------------------------------- 2. main path (mesh)
    _build.reset_launch_counts()
    _, m_id, text = _run_cli(work, base, "mesh_identity")
    for key in ("IoU: ", "Acc: ", "MSE: ", "Took: "):
        check(text.count(key) == n_frames,
              f"mesh identity run printed {key!r} lines")
    _, m_x, _ = _run_cli(work, base, "mesh_cross", "-t", hdl32_path)
    _, m_p, _ = _run_cli(work, base, "mesh_ply", "-t", hdl32_path,
                         "--frames", "1", "--ply", ply)
    w1 = load_window(seq, cfg, 1, cap, dev)
    fused = {}
    for compact in (False, True):
        eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device=dev, compact_volume=compact)
        eng.transfer_fast(w1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = eng.fused_state()
        torch.cuda.synchronize()
        fused[compact] = time.perf_counter() - t
        print(f"mesh fused_state {tuple(state.tsdf.shape)} "
              f"{'compact' if compact else 'f32'}: {fused[compact]:.2f} s "
              f"first call (allocation and geometry table included), "
              f"{int((state.tsdf < 1).sum())} voxels with tsdf < 1 {tag}")
        # ------------------------------------- 3. the chain, slab by slab
        check(tuple(state.tsdf.shape) == (2048, 2048, 208),
              f"volume dims {tuple(state.tsdf.shape)}")
        _, ris = eng._project_window_scans(w1)
        stacks = [torch.stack([getattr(ri, f) for ri in ris])
                  for f in ("range", "label", "remission")]
        per_x = (state.tsdf < 1).sum(dim=(1, 2))
        check(int(per_x.sum()) > 0, "fused mesh volume has no surface")
        for x0 in (int(per_x.argmax()) // 16 * 16, eng.vol_dims[0] // 2):
            slab = TS.VolumeSpec(eng.vol_spec.origin,
                                 eng.vol_spec.voxel_size,
                                 (16,) + eng.vol_dims[1:])
            ref = TS.integrate_chain(
                slab.init_state(dev, compact), slab, *stacks,
                fov_up_deg=HDL64.fov_up, fov_down_deg=HDL64.fov_down,
                origin=eng.vol_spec.origin, active_dims=eng.vol_dims,
                x_offset=x0)
            _compare_states(torch, TS.TSDFState(*(a[x0:x0 + 16]
                                                  for a in state)), ref,
                            f"fused mesh slab x={x0}..{x0 + 15} "
                            f"{'compact' if compact else 'f32'} vs plain "
                            "chain")
            del ref
        del state, eng
        torch.cuda.empty_cache()
    counts = _build.launch_counts()
    print(f"launches on the mesh path: {counts}")
    for k in ("zbuffer", "confusion", "tsdf_integrate_chain",
              "tsdf_geometry"):
        check(counts[k] > 0, f"kernel {k} never launched on the mesh path")

    # ------------------------------------------- 3. outputs of the path
    for name, ms in (("identity", m_id), ("cross", m_x), ("ply", m_p)):
        check(len(ms) == (1 if name == "ply" else n_frames),
              f"mesh {name}: {len(ms)} frames")
        for fm in ms:
            lbl = os.path.join(work, f"mesh_{name}", "sequences", "00",
                               "labels", f"{fm['index']:06d}.label")
            check(os.path.getsize(lbl) == 4 * fm["points_written"] > 0,
                  f"mesh {name}: label file of frame {fm['index']}")
    for fm in m_id:
        check(np.isfinite([fm["iou"], fm["acc"], fm["mse"]]).all()
              and 0 < fm["iou"] <= 1, f"mesh identity metrics {fm}")
    ply_file = os.path.join(ply, f"{m_p[0]['index']:06d}.ply")
    print(f"PLY {ply_file}: {m_p[0]['triangles']} triangles, "
          f"{os.path.getsize(ply_file)} bytes")
    check(m_p[0]["triangles"] > 0 and os.path.getsize(ply_file) >
          94 * m_p[0]["triangles"], "the mesh PLY is empty")
    eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev)
    vs_card = eng.transfer_fast(w1)
    cpu_eng = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                                device="cpu")
    vs_cpu = cpu_eng.transfer_fast(load_window(seq, cfg, 1, cap, "cpu"))
    lc, mc = vs_card.label.cpu(), vs_card.mask.cpu()
    agree = float(((lc == vs_cpu.label) & (mc == vs_cpu.mask)).float().mean())
    both = (lc == vs_cpu.label) & mc & vs_cpu.mask
    rerr = (vs_card.range.cpu() - vs_cpu.range)[both].abs()
    print(f"mesh card vs CPU (frame 1, HDL64->HDL32, fold): label/mask "
          f"agreement {agree:.6f}, range error > 1e-3 m on "
          f"{int((rerr > 1e-3).sum())} of {int(both.sum())} pixels, mask "
          f"fill {float(mc.float().mean()):.4f}")
    check(agree >= 0.999, "mesh card and CPU outputs disagree")
    check(float(mc.float().mean()) > 0.3, "mesh virtual scan mostly empty")

    # ------------------------------------------------------ 4. timing
    wins = [load_window(seq, cfg, i, cap, dev) for i in range(1, 5)]
    fold_ms = _cuda_ms(torch, lambda: [eng.transfer_fast(w)
                                       for w in wins], 5) / len(wins)
    print(f"mesh transfer_fast (fold) HDL64->HDL32, 3 scans: "
          f"{fold_ms:.3f} ms/frame ({1e3 / fold_ms:.1f} scans/s) {tag}")
    _profile_frames(torch, eng, wins, fold_ms, tag)
    times = []
    for w in wins[:3]:
        eng.transfer_fast(w)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.fused_state()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f"mesh fused_state() (projection + chain + table read, f32), "
          f"warm: {', '.join(f'{x:.3f}' for x in times)} ms {tag}")
    lut = np.zeros((300, 3), np.uint8)
    t = time.perf_counter()
    n_tri = eng.export_mesh(os.path.join(work, "export.ply"), colorize=lut)
    print(f"export_mesh (cells, {eng.vol_dims} f32): {n_tri} triangles in "
          f"{time.perf_counter() - t:.2f} s wall {tag}")

    spec = eng.vol_spec
    state = eng.fused_state()
    _, ris = eng._project_window_scans(wins[0])
    stacks = [torch.stack([getattr(ri, f) for ri in ris])
              for f in ("range", "label", "remission")]
    geom = eng._ensure_geom(HDL64.fov_up, HDL64.fov_down, HDL64.H)
    kw = dict(fov_up_deg=HDL64.fov_up, fov_down_deg=HDL64.fov_down)
    compact_state = spec.init_state(dev, compact=True)
    for st in (state, compact_state):
        for v_tab in (geom, None):
            k_ms = _cuda_ms(torch, lambda: integrate_chain_cuda(
                st, spec, *stacks, v_tab=v_tab, **kw), 10)
            p_ms = _cuda_ms(torch, lambda: TS.integrate_chain(
                st, spec, *stacks, v_tab=v_tab, **kw), 2, warmup=1)
            name = "compact" if st is compact_state else "f32"
            print(f"chain S=3 {spec.dims} {name} table={v_tab is not None}:"
                  f" kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms {tag}")
            if st is state and v_tab is not None:
                kernels["tsdf_integrate_chain"].update(ms=k_ms,
                                                       plain_ms=p_ms)
    del compact_state
    g_ms = _cuda_ms(torch, lambda: precompute_geometry_cuda(
        spec, HDL64.fov_up, HDL64.fov_down, HDL64.H, device=dev), 10)
    gp_ms = _cuda_ms(torch, lambda: TS.precompute_geometry(
        spec, HDL64.fov_up, HDL64.fov_down, HDL64.H, device=dev), 2,
        warmup=1)
    kernels["tsdf_geometry"].update(ms=g_ms, plain_ms=gp_ms)
    print(f"geometry table {spec.dims}: kernel {g_ms:.3f} ms, plain "
          f"{gp_ms:.1f} ms {tag}")
    del state, eng
    torch.cuda.empty_cache()
    vol = TD.TransferEngine(HDL64, hdl32, cfg, fixed_bounds=True,
                            device=dev, mesh_attrs="volume",
                            compact_volume=True)
    vol_ms = _cuda_ms(torch, lambda: [vol.transfer_fast(w)
                                      for w in wins], 3) / len(wins)
    vv = vol.transfer_fast(wins[0])
    print(f"mesh transfer_fast (mesh_attrs=volume, compact, chain in the "
          f"frame): {vol_ms:.3f} ms/frame ({1e3 / vol_ms:.1f} scans/s), "
          f"mask fill {float(vv.mask.float().mean()):.4f} {tag}")
    return counts


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
