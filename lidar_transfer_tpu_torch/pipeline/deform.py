"""Transfer engine, mergemesh adaption with splat synthesis (PyTorch).

Counterpart of ``lidar_transfer_tpu/pipeline/deform.py`` for the main path:
the merged cloud of a window is z-buffered into a source-dims image at the
TARGET field of view (kernel A), every winner spawns one truncation-band
candidate, and the candidates are z-buffered into the target image
(kernel A again). The TSDF volume is deferred: the transfer never reads
it, and :meth:`TransferEngine.fused_state` integrates it on first demand
(kernel C).

Not ported yet (ROADMAP.md, queue 1), and refused with
``NotImplementedError`` at construction: the cp, mesh and catmesh
adaptions, raymarch synthesis, and targets denser than the source (their
upsampling chords).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.splat import splat_synthesize
from lidar_transfer_tpu_torch.ops.tsdf_cuda import integrate_cuda
from lidar_transfer_tpu_torch.pipeline.multiscan import (ScanWindow,
                                                         merge_window)

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


class VirtualScan(NamedTuple):
    """A synthesized target-sensor scan (all target-image-shaped; a
    streamed batch adds a leading frame axis)."""

    range: torch.Tensor      # (tH,tW) f32; 0 = no data
    label: torch.Tensor      # (tH,tW) i32; 0 = no data
    remission: torch.Tensor  # (tH,tW) f32
    points: torch.Tensor     # (tH,tW,3) f32
    mask: torch.Tensor       # (tH,tW) bool
    adaption: str


def bucket_dims(dims, multiple: tuple[int, int, int] = (64, 64, 16)
                ) -> tuple[int, int, int]:
    """Round volume dims up to bucket multiples."""
    return tuple(int(-(-int(d) // m) * m) for d, m in zip(dims, multiple))


@dataclasses.dataclass
class TransferEngine:
    """Specs, config and the volume geometry of one (source, target)
    pair; the resident volume is created on first ``fused_state()`` and
    reused across frames."""

    source: SensorSpec
    target: SensorSpec
    cfg: TransferConfig
    # True: always the full config-bounds volume; False: per-frame bounds
    # clipped to the merged cloud (one 6-float host read per frame)
    fixed_bounds: bool = False
    device: torch.device | str = "cuda"
    synthesis: str = "splat"

    def __post_init__(self):
        if self.cfg.adaption != "mergemesh":
            raise NotImplementedError(
                f"adaption {self.cfg.adaption!r} {_NOT_PORTED}")
        if self.synthesis != "splat":
            raise NotImplementedError(
                f"synthesis {self.synthesis!r} {_NOT_PORTED}")
        self.device = torch.device(self.device)
        t = self.target
        ba = (np.asarray(t.beam_angles) if t.beam_angles is not None
              else None)
        sba = (np.asarray(self.source.beam_angles)
               if self.source.beam_angles is not None else None)
        self.t_beam_angles = self._tensor(ba)
        self.s_beam_angles = self._tensor(sba)
        vb = self.cfg.voxel_bounds_array
        full_dims = np.ceil((vb[:, 1] - vb[:, 0]) /
                            self.cfg.voxel_size).astype(int)
        self.vol_dims = bucket_dims(full_dims, multiple=(64, 64, 16))
        self.vol_spec = TS.VolumeSpec(
            origin=tuple(float(v) for v in vb[:, 0]),
            voxel_size=float(self.cfg.voxel_size), dims=self.vol_dims)
        self._interp_mv, self._interp_mu = self._interp_counts(ba, sba)
        if self._interp_mv or self._interp_mu:
            raise NotImplementedError(
                f"target {t.name} ({t.H}x{t.W}) is denser than source "
                f"{self.source.name} ({self.source.H}x{self.source.W}): "
                f"upsampling chords {_NOT_PORTED}")
        self._vol_state: TS.TSDFState | None = None
        self._pending_window: ScanWindow | None = None
        self._stream_windows: ScanWindow | None = None
        self._fused = False

    def _tensor(self, a):
        return (None if a is None else
                torch.as_tensor(a, dtype=torch.float32, device=self.device))

    def _interp_counts(self, ba, sba) -> tuple[int, int]:
        """-> (rows, columns): how many interior target rows/columns fall
        between adjacent source pixels (the JAX engine's upsampling-
        interpolation counts; nonzero means the target is denser)."""
        t = self.target
        if sba is not None and len(sba) > 1:
            sd = np.degrees(np.sort(sba))
            src_pitch = float(sd[-1] - sd[0]) / (len(sd) - 1)
        else:
            # mergemesh projects the merged cloud at the TARGET fov over
            # source.H rows; span/(H-1) is the conservative row spacing
            src_pitch = (t.fov_up - t.fov_down) / max(self.source.H - 1, 1)
        if ba is not None and len(ba) > 1:
            bd = np.degrees(np.sort(ba))
            tgt_pitch = float(bd[-1] - bd[0]) / (len(bd) - 1)
        else:
            tgt_pitch = (t.fov_up - t.fov_down) / t.H
        # 0.15 slack: only a genuinely denser target activates
        rows = min(8, max(0, int(np.ceil(
            src_pitch / max(tgt_pitch, 1e-9) - 0.15)) - 1))
        cols = min(8, max(0, int(np.ceil(
            t.W / self.source.W - 0.15)) - 1))
        return rows, cols

    # ------------------------------------------------------ volume state
    def _take_state(self) -> TS.TSDFState:
        """The resident volume, allocated once and reused across frames
        (each frame's integrate runs with ``reset=True``)."""
        state = self._vol_state
        if state is None:
            state = self.vol_spec.init_state(self.device)
        self._vol_state = None
        return state

    def _keep_state(self, state: TS.TSDFState) -> None:
        self._vol_state = state

    def _frame_volume(self, pts, valid):
        """-> (origin (3,) f32, active dims (3,) int) of this frame's
        volume: the config bounds, or with clipped bounds the config
        bounds clipped to the cloud (one host read of 6 floats)."""
        if self.fixed_bounds:
            return (np.asarray(self.vol_spec.origin, np.float32),
                    np.asarray(self.vol_spec.dims))
        big = 1e9
        lo = torch.where(valid[:, None], pts, big).amin(dim=0)
        hi = torch.where(valid[:, None], pts, -big).amax(dim=0)
        cloud = np.rint(torch.stack([lo, hi], dim=1).cpu().numpy())
        cfgb = self.cfg.voxel_bounds_array.astype(np.float64)
        clip = cfgb.copy()
        clip[:, 0] = np.maximum(cfgb[:, 0], cloud[:, 0])
        clip[:, 1] = np.minimum(cfgb[:, 1], cloud[:, 1])
        clip[:, 1] = np.maximum(clip[:, 1], clip[:, 0] + self.cfg.voxel_size)
        exact_dims = np.ceil((clip[:, 1] - clip[:, 0]) /
                             self.cfg.voxel_size).astype(int)
        exact_dims = np.minimum(exact_dims, np.asarray(self.vol_dims))
        return clip[:, 0].astype(np.float32), exact_dims

    # ---------------------------------------------------------- transfer
    def _mergemesh_core_fast(self, window: ScanWindow):
        """One frame: source z-buffer, one band candidate per winning
        pixel, target z-buffer. The candidates are the winners in raster
        order, which is the relative order of the JAX body's sorted
        winner rows, so exact target ties resolve alike."""
        pts, rem, lbl, valid = merge_window(window)
        t = self.target
        win, depth = P.project_winner_order(
            pts, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles)
        has = win >= 0
        g = torch.where(has, win, 0).to(torch.int64)
        origin, active = self._frame_volume(pts, valid)
        return splat_synthesize(
            self.vol_spec,
            [(depth[g], pts[g], has, lbl[g].to(torch.int32), rem[g])],
            target_H=t.H, target_W=t.W, fov_up_deg=t.fov_up,
            fov_down_deg=t.fov_down, vol_origin=origin, active_dims=active,
            beam_angles=self.t_beam_angles, attrs="image")

    def transfer_fast(self, window: ScanWindow) -> VirtualScan:
        """Transfer one window; the volume stays deferred (see
        :meth:`fused_state`)."""
        rng, lbl, rem, ends, mask = self._mergemesh_core_fast(window)
        self._pending_window = window
        self._stream_windows = None
        self._fused = False
        return VirtualScan(range=rng, label=lbl, remission=rem, points=ends,
                           mask=mask, adaption=self.cfg.adaption)

    def transfer_stream(self, windows: ScanWindow) -> VirtualScan:
        """Transfer F windows stacked on a leading frame axis; returns
        exactly what per-frame :meth:`transfer_fast` returns, stacked.

        Afterwards ``fused_state(frame=i)`` selects the streamed frame
        whose volume to integrate.
        """
        outs = [self._mergemesh_core_fast(windows.frame(i))
                for i in range(windows.points.shape[0])]
        self._pending_window = None
        self._stream_windows = windows
        self._fused = False
        rng, lbl, rem, ends, mask = (torch.stack([o[k] for o in outs])
                                     for k in range(5))
        return VirtualScan(range=rng, label=lbl, remission=rem, points=ends,
                           mask=mask, adaption=self.cfg.adaption)

    def fused_state(self, frame: int | None = None) -> TS.TSDFState:
        """The fused TSDF volume of the last transferred frame, integrated
        on first demand (kernel C on the card). The weight volume is not
        written on this single-integrate path; its contents are
        unspecified. After ``transfer_stream`` pass ``frame=i``."""
        if frame is not None:
            sw = self._stream_windows
            if sw is None:
                raise ValueError("frame= indexing requires a preceding "
                                 "transfer_stream")
            n = int(sw.points.shape[0])
            if not -n <= frame < n:
                raise IndexError(f"frame {frame} out of range for the "
                                 f"{n}-frame stream")
            self._pending_window = sw.frame(frame)
            self._fused = False
        if self._fused and self._vol_state is not None:
            return self._vol_state
        w = self._pending_window
        if w is None:
            if self._stream_windows is not None:
                raise ValueError(
                    "fused_state() after transfer_stream is ambiguous — "
                    "pass frame=i to select one of the "
                    f"{self._stream_windows.points.shape[0]} streamed "
                    "frames")
            raise RuntimeError("no fused volume yet — run a transfer "
                               "first")
        pts, rem, lbl, valid = merge_window(w)
        t = self.target
        ri = P.range_project(
            pts, rem, lbl, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles)
        origin, active = self._frame_volume(pts, valid)
        state = integrate_cuda(
            self._take_state(), self.vol_spec, ri.range, ri.label,
            ri.remission, fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            origin=origin, active_dims=active, reset=True,
            write_weight=False)
        self._keep_state(state)
        self._fused = True
        return state
