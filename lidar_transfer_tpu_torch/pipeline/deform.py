"""Transfer engine: the cp, mergemesh, mesh and catmesh adaptions with
splat synthesis (PyTorch).

Counterpart of ``lidar_transfer_tpu/pipeline/deform.py``:

  cp        — closest point: the merged cloud z-buffered straight into the
              TARGET image (kernel A) and back-projected; no volume.
  mergemesh — the main path: the merged cloud of a window is z-buffered
              into a source-dims image at the TARGET field of view
              (kernel A), every winner spawns one truncation-band
              candidate, and the candidates are z-buffered into the target
              image (kernel A again). The splat never reads the volume, so
              it is deferred: :meth:`TransferEngine.fused_state`
              integrates it on first demand (kernel C); with
              ``defer_volume=False`` ``mergemesh()`` integrates it in the
              frame.
  mesh      — every scan of the window gets its own range image at the
              SOURCE spec, in the primary frame, and all S are splatted.
              With ``mesh_attrs="fold"`` the band attributes come from the
              class-aware fold of the S aligned images, so the volume is
              deferred too and ``fused_state()`` runs the S-scan chain
              (kernel C's chain mode); with ``"volume"`` the chain runs in
              the frame and the splat probes the volume. Under fixed bounds
              the chain reads the placement's geometry table (kernel D).
  catmesh   — on its splat engine, the mergemesh body with
              ``adaption="catmesh"`` on the output: every candidate carries
              its own source pixel's label, so labels never bleed across
              category seams, which is what per-category meshing is for.

A target denser than the source (vertically or horizontally) adds chord
candidates between adjacent connected source returns
(``ops/splat._interp_candidates``); such frames take the classic deferred
mergemesh body, as the JAX engine does by default.

Not ported yet (ROADMAP.md, queue 1), and refused with
``NotImplementedError`` at construction: raymarch synthesis and catmesh's
``"oracle"`` engine (per-category marching and a mesh raycast).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.marching import (marching_tetrahedra,
                                                   marching_tetrahedra_cells)
from lidar_transfer_tpu_torch.ops.splat import splat_synthesize
from lidar_transfer_tpu_torch.ops.surface import extract_surface_cells
from lidar_transfer_tpu_torch.ops.transforms import transform_points
from lidar_transfer_tpu_torch.ops.tsdf_cuda import (integrate_chain_cuda,
                                                    integrate_cuda,
                                                    precompute_geometry_cuda)
from lidar_transfer_tpu_torch.pipeline.multiscan import (ScanWindow,
                                                         merge_window)
from lidar_transfer_tpu_torch.utils.plyio import write_ply

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
    pair; the resident volume is created on first use and reused across
    frames."""

    source: SensorSpec
    target: SensorSpec
    cfg: TransferConfig
    # True: always the full config-bounds volume; False: per-frame bounds
    # clipped to the cloud (one 6-float host read per frame)
    fixed_bounds: bool = False
    device: torch.device | str = "cuda"
    synthesis: str = "splat"
    # 8 B/voxel state (bf16 tsdf/weight/rem, int16 labels) instead of
    # 16 B/voxel float32
    compact_volume: bool = False
    # integrate only on demand (fused_state) where the synthesis does not
    # read the volume (mergemesh; mesh with mesh_attrs="fold")
    defer_volume: bool = True
    # mesh adaption band attributes: "fold" (the S aligned images, no
    # volume) or "volume" (the materialised S-scan chain, probed)
    mesh_attrs: str = "fold"
    # volume probe: every band sample must also carry label > 0
    band_label_probe: bool = False
    # catmesh engine: "splat" (the mergemesh body) or "oracle" (per-category
    # iso-surfaces and a mesh raycast; not ported yet)
    catmesh_engine: str = "splat"
    # chord candidates for a denser target: "auto"/True when the target is
    # denser, False never (interior target rows/columns stay empty)
    upsample_interp: bool | str = "auto"
    # connectivity angle (degrees) of two adjacent returns' chord
    interp_angle_deg: float = 3.0

    def __post_init__(self):
        if self.synthesis != "splat":
            raise NotImplementedError(
                f"synthesis {self.synthesis!r} {_NOT_PORTED}")
        if self.mesh_attrs not in ("fold", "volume"):
            raise ValueError(f"mesh_attrs must be 'fold' or 'volume': "
                             f"{self.mesh_attrs!r}")
        if self.catmesh_engine not in ("splat", "oracle"):
            raise ValueError(f"catmesh_engine must be 'splat' or 'oracle': "
                             f"{self.catmesh_engine!r}")
        if self.cfg.adaption == "catmesh" and self.catmesh_engine == "oracle":
            raise NotImplementedError(
                f"catmesh_engine 'oracle' {_NOT_PORTED}")
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
        self._interp_mv, self._interp_mu = (
            self._interp_counts(ba, sba) if self.upsample_interp else (0, 0))
        self._interp_vspan = self._interp_span(sba)
        self._geoms: dict = {}
        # the z-buffer's scratch, shared by every projection and target
        # assemble of this engine: a frame allocates and initialises none
        self._zbuf = P.ZBufferWorkspace(self.device)
        self._vol_state: TS.TSDFState | None = None
        self._pending_window: ScanWindow | None = None
        self._pending_fusion = None
        self._pending_mode = "mergemesh"
        self._pending_origin = None
        self._stream_windows: ScanWindow | None = None
        self._fused = False
        self._last_origin = None
        self._last_sources = ()

    def _tensor(self, a):
        return (None if a is None else
                torch.as_tensor(a, dtype=torch.float32, device=self.device))

    def _interp_counts(self, ba, sba) -> tuple[int, int]:
        """-> (rows, columns): how many interior target rows/columns fall
        between adjacent source pixels (the JAX engine's upsampling-
        interpolation counts; nonzero means the target is denser)."""
        t, s = self.target, self.source
        if sba is not None and len(sba) > 1:
            sd = np.degrees(np.sort(sba))
            src_pitch = float(sd[-1] - sd[0]) / (len(sd) - 1)
        else:
            # mesh projects each scan at the SOURCE fov, mergemesh the
            # merged cloud at the TARGET fov, over source.H rows;
            # span/(H-1) is the conservative row spacing
            span = (s.fov_up - s.fov_down if self.cfg.adaption == "mesh"
                    else t.fov_up - t.fov_down)
            src_pitch = span / max(s.H - 1, 1)
        if ba is not None and len(ba) > 1:
            bd = np.degrees(np.sort(ba))
            tgt_pitch = float(bd[-1] - bd[0]) / (len(bd) - 1)
        else:
            tgt_pitch = (t.fov_up - t.fov_down) / t.H
        # 0.15 slack: only a genuinely denser target activates
        rows = min(8, max(0, int(np.ceil(
            src_pitch / max(tgt_pitch, 1e-9) - 0.15)) - 1))
        cols = min(8, max(0, int(np.ceil(t.W / s.W - 0.15)) - 1))
        return rows, cols

    def _interp_span(self, sba) -> int:
        """Rows a vertical chord may bridge: with a source beam table the
        projection snaps pitch to beams, and consecutive beams can land
        more than one row apart. Capped at 4 (each level adds a full
        candidate set, and a wider gap asks for more than 4x the source's
        beam density), with a warning."""
        if self._interp_mv == 0 or sba is None or len(sba) < 2:
            return 1
        t, s = self.target, self.source
        fu, fd = ((s.fov_up, s.fov_down) if self.cfg.adaption == "mesh"
                  else (t.fov_up, t.fov_down))
        fov = abs(np.radians(fu)) + abs(np.radians(fd))
        v = 1.0 - (np.sort(sba) + abs(np.radians(fd))) / fov
        occ = np.unique(np.clip(np.floor(v * s.H), 0, s.H - 1).astype(int))
        if len(occ) < 2:
            return 1
        max_gap = int(np.diff(occ).max())
        if max_gap > 4:
            warnings.warn(
                f"source beam table leaves occupied-row gaps up to "
                f"{max_gap} rows but chord interpolation bridges at most 4 "
                f"— target rows inside wider gaps will stay empty (raise "
                f"source H or thin the target density)", stacklevel=4)
        return min(4, max_gap)

    @property
    def _interp_active(self) -> bool:
        return self._interp_mv > 0 or self._interp_mu > 0

    # ------------------------------------------------------ volume state
    def _take_state(self) -> TS.TSDFState:
        """The resident volume, allocated once and reused across frames
        (each frame's first integrate runs with ``reset``)."""
        state = self._vol_state
        if state is None:
            state = self.vol_spec.init_state(self.device,
                                             compact=self.compact_volume)
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

    def _ensure_geom(self, fov_up, fov_down, H):
        """The geometry table of the fixed placement for images of this
        fov and height (kernel D on the card), built once; None with
        clipped bounds, whose placement moves every frame."""
        if not self.fixed_bounds:
            return None
        key = (float(fov_up), float(fov_down), int(H))
        if key not in self._geoms:
            self._geoms[key] = precompute_geometry_cuda(
                self.vol_spec, fov_up, fov_down, H, device=self.device)
        return self._geoms[key]

    def _integrate(self, state, ri, fov_up, fov_down, origin, active,
                   reset, geom=None, write_weight=True):
        return integrate_cuda(
            state, self.vol_spec, ri.range, ri.label, ri.remission,
            fov_up_deg=fov_up, fov_down_deg=fov_down, origin=origin,
            active_dims=active, reset=reset, write_weight=write_weight,
            v_tab=geom)

    def _integrate_chain(self, state, ris, fov_up, fov_down, origin,
                         active, geom):
        """S per-scan integrates, reset on the first, as one chain pass
        (one state write; kernel C's chain mode on the card)."""
        if len(ris) == 1:
            return self._integrate(state, ris[0], fov_up, fov_down, origin,
                                   active, reset=True, geom=geom)
        return integrate_chain_cuda(
            state, self.vol_spec, torch.stack([ri.range for ri in ris]),
            torch.stack([ri.label for ri in ris]),
            torch.stack([ri.remission for ri in ris]),
            fov_up_deg=fov_up, fov_down_deg=fov_down, origin=origin,
            active_dims=active, v_tab=geom)

    def _synthesize(self, state, origin, active, sources) -> VirtualScan:
        """Band splatting of the fused ``sources``, a list of (range
        image, fov_up, fov_down); ``state`` is read by the volume
        attributes alone."""
        srcs = []
        for ri, fu, fd in sources:
            back = P.reverse_project(ri, fov_up_deg=fu, fov_down_deg=fd,
                                     preserve_float=True)
            srcs.append((ri.range.reshape(-1), back, ri.mask.reshape(-1),
                         ri.label.reshape(-1),
                         torch.clamp(ri.remission, min=0.0).reshape(-1)))
        t = self.target
        interp = None
        if self._interp_active:
            sH, sW = sources[0][0].range.shape
            interp = (sH, sW, self._interp_mv, self._interp_mu,
                      float(np.tan(np.radians(self.interp_angle_deg))),
                      self._interp_vspan)
        rng, lbl, rem, ends, mask = splat_synthesize(
            state, self.vol_spec, srcs, target_H=t.H, target_W=t.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            vol_origin=origin, active_dims=active,
            beam_angles=self.t_beam_angles,
            attrs="auto" if len(sources) == 1 else self.mesh_attrs,
            label_probe=self.band_label_probe, interp=interp,
            workspace=self._zbuf)
        return VirtualScan(range=rng, label=lbl, remission=rem, points=ends,
                           mask=mask, adaption=self.cfg.adaption)

    def _defer(self, *, window=None, fusion=None, mode="mergemesh",
               placement=None, origin=None) -> None:
        """Record a transferred frame whose volume is integrated on first
        demand: its window (or, for mergemesh(), its fused image record)."""
        self._pending_window = window
        self._pending_fusion = fusion
        self._pending_mode = mode
        self._pending_origin = placement
        self._stream_windows = None
        self._fused = False
        self._last_origin = origin

    def _fused_now(self, state, origin, sources) -> None:
        """Keep the integrated volume of the current frame."""
        self._keep_state(state)
        self._fused = True
        self._last_origin = origin
        self._last_sources = tuple(sources)

    def _materialised(self, state, origin, sources) -> None:
        """Record a frame whose volume was integrated in the transfer."""
        self._defer(origin=origin)
        self._fused_now(state, origin, sources)

    # ---------------------------------------------------------------- cp
    def cp(self, window: ScanWindow) -> tuple[VirtualScan, P.RangeImage]:
        """Closest-point adaption: the merged cloud projected at the TARGET
        dims and fov (kernel A) and back-projected; no volume, so
        ``fused_state()`` afterwards raises. An identity transfer
        reproduces the source projection bit for bit. (The JAX engine's
        one-program ``_cp_core_fast`` is this body: PyTorch runs it
        eagerly, with no fusion to re-round the pixel coordinates.)"""
        pts, rem, lbl, valid = merge_window(window)
        t = self.target
        ri = P.range_project(
            pts, rem, lbl, valid, H=t.H, W=t.W, fov_up_deg=t.fov_up,
            fov_down_deg=t.fov_down, beam_angles=self.t_beam_angles,
            workspace=self._zbuf)
        back = P.reverse_project(ri, fov_up_deg=t.fov_up,
                                 fov_down_deg=t.fov_down,
                                 preserve_float=self.cfg.preserve_float)
        self._defer()
        vs = VirtualScan(range=ri.range, label=ri.label,
                         remission=torch.clamp(ri.remission, min=0.0),
                         points=back.reshape(t.H, t.W, 3), mask=ri.mask,
                         adaption="cp")
        return vs, ri

    # --------------------------------------------------------- mergemesh
    def _merged_image(self, window: ScanWindow):
        """-> (range image of the merged cloud at source dims and target
        fov, origin, active dims)."""
        pts, rem, lbl, valid = merge_window(window)
        t = self.target
        ri = P.range_project(
            pts, rem, lbl, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles, workspace=self._zbuf)
        origin, active = self._frame_volume(pts, valid)
        return ri, origin, active

    def _mergemesh_core(self, window: ScanWindow, state, geom=None):
        """Whole-frame body that integrates the volume in the frame."""
        ri, origin, active = self._merged_image(window)
        t = self.target
        state = self._integrate(state, ri, t.fov_up, t.fov_down, origin,
                                active, reset=True, geom=geom)
        vs = self._synthesize(state, origin, active,
                              [(ri, t.fov_up, t.fov_down)])
        return vs, ri, state, origin

    def _mergemesh_core_deferred(self, window: ScanWindow):
        """Volume-free body: projection and splat only."""
        ri, origin, active = self._merged_image(window)
        t = self.target
        vs = self._synthesize(None, origin, active,
                              [(ri, t.fov_up, t.fov_down)])
        return vs, ri, origin, active

    def mergemesh(self, window: ScanWindow
                  ) -> tuple[VirtualScan, P.RangeImage]:
        """Merged-cloud adaption with its range image: the volume
        deferred (``defer_volume``) or integrated in the frame."""
        t = self.target
        if self.defer_volume:
            vs, ri, origin, active = self._mergemesh_core_deferred(window)
            self._defer(fusion=(ri, t.fov_up, t.fov_down, origin, active),
                        origin=origin)
            self._last_sources = ((ri, t.fov_up, t.fov_down),)
            return vs, ri
        geom = self._ensure_geom(t.fov_up, t.fov_down, self.source.H)
        vs, ri, state, origin = self._mergemesh_core(
            window, self._take_state(), geom)
        self._materialised(state, origin, [(ri, t.fov_up, t.fov_down)])
        return vs, ri

    def _mergemesh_core_fast(self, window: ScanWindow):
        """One frame without image assembly: source z-buffer, one band
        candidate per winning pixel, target z-buffer. The candidates are
        the winners in raster order, which is the relative order of the
        JAX body's sorted winner rows, so exact target ties resolve
        alike. -> (range, label, remission, endpoints, mask), origin."""
        pts, rem, lbl, valid = merge_window(window)
        t = self.target
        win, depth = P.project_winner_order(
            pts, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles, workspace=self._zbuf)
        has = win >= 0
        g = torch.where(has, win, 0).to(torch.int64)
        origin, active = self._frame_volume(pts, valid)
        out = splat_synthesize(
            None, self.vol_spec,
            [(depth[g], pts[g], has, lbl[g].to(torch.int32), rem[g])],
            target_H=t.H, target_W=t.W, fov_up_deg=t.fov_up,
            fov_down_deg=t.fov_down, vol_origin=origin, active_dims=active,
            beam_angles=self.t_beam_angles, attrs="image",
            workspace=self._zbuf)
        return out, origin

    # -------------------------------------------------------------- mesh
    def _project_window_scans(self, w: ScanWindow):
        """Every scan of the window in the primary frame, and its range
        image at the source spec. -> (points (S,C,3), S range images)."""
        pts_all = transform_points(w.points, w.rel_pose)
        s = self.source
        ris = tuple(
            P.range_project(
                pts_all[i], w.remissions[i], w.labels[i], w.valid[i],
                H=s.H, W=s.W, fov_up_deg=s.fov_up, fov_down_deg=s.fov_down,
                beam_angles=self.s_beam_angles, workspace=self._zbuf)
            for i in range(w.points.shape[0]))
        return pts_all, ris

    def _mesh_sources(self, ris):
        return [(ri, self.source.fov_up, self.source.fov_down)
                for ri in ris]

    def _mesh_placement(self, w: ScanWindow, pts_all):
        return self._frame_volume(pts_all.reshape(-1, 3),
                                  w.valid.reshape(-1))

    def _mesh_core(self, window: ScanWindow, state, geom=None):
        """Materialised body: the S-scan chain, then the splat probes the
        volume (``mesh_attrs="volume"``; the fold ignores it)."""
        pts_all, ris = self._project_window_scans(window)
        origin, active = self._mesh_placement(window, pts_all)
        state = self._integrate_chain(state, ris, self.source.fov_up,
                                      self.source.fov_down, origin, active,
                                      geom)
        vs = self._synthesize(state, origin, active,
                              self._mesh_sources(ris))
        return vs, ris, state, origin

    def _mesh_fast_body(self, window: ScanWindow):
        """Volume-free body (fold synthesis)."""
        pts_all, ris = self._project_window_scans(window)
        origin, active = self._mesh_placement(window, pts_all)
        vs = self._synthesize(None, origin, active, self._mesh_sources(ris))
        return vs, ris, origin, active

    def mesh(self, window: ScanWindow) -> tuple[VirtualScan, P.RangeImage]:
        """Per-scan adaption with the primary scan's range image: fold
        synthesis with the chain deferred to ``fused_state()``, or (with
        ``mesh_attrs="volume"`` or ``defer_volume=False``) the chain in
        the frame."""
        if self.defer_volume and self.mesh_attrs == "fold":
            vs, ris, origin, active = self._mesh_fast_body(window)
            self._defer(window=window, mode="mesh",
                        placement=(origin, active), origin=origin)
            return vs, ris[0]
        geom = self._ensure_geom(self.source.fov_up, self.source.fov_down,
                                 self.source.H)
        vs, ris, state, origin = self._mesh_core(window, self._take_state(),
                                                 geom)
        self._materialised(state, origin, self._mesh_sources(ris))
        return vs, ris[0]

    # ---------------------------------------------------------- dispatch
    def transfer(self, window: ScanWindow
                 ) -> tuple[VirtualScan, P.RangeImage]:
        adaption = self.cfg.adaption
        if adaption == "cp":
            return self.cp(window)
        if adaption == "mergemesh":
            return self.mergemesh(window)
        if adaption == "mesh":
            return self.mesh(window)
        if adaption == "catmesh":
            vs, ri = self.mergemesh(window)
            return vs._replace(adaption="catmesh"), ri
        raise ValueError(f"adaption {adaption!r}")

    def transfer_fast(self, window: ScanWindow) -> VirtualScan:
        """Transfer one window without its range image; for mergemesh and
        catmesh the volume stays deferred (see :meth:`fused_state`). A
        denser target takes the classic deferred body (``transfer``),
        whose range image the chords are drawn in."""
        if (self.cfg.adaption not in ("mergemesh", "catmesh")
                or self._interp_active):
            return self.transfer(window)[0]
        (rng, lbl, rem, ends, mask), origin = \
            self._mergemesh_core_fast(window)
        self._defer(window=window, origin=origin)
        return VirtualScan(range=rng, label=lbl, remission=rem, points=ends,
                           mask=mask, adaption=self.cfg.adaption)

    def transfer_stream(self, windows: ScanWindow) -> VirtualScan:
        """Transfer F windows stacked on a leading frame axis; returns
        exactly what per-frame :meth:`transfer_fast` returns, stacked.

        Where the volume is deferred, ``fused_state(frame=i)`` afterwards
        selects the streamed frame whose volume to integrate; a frame
        whose volume was integrated in the transfer leaves the last one.
        """
        outs = [self.transfer_fast(windows.frame(i))
                for i in range(windows.points.shape[0])]
        if (self._pending_window is not None
                or self._pending_fusion is not None):
            self._pending_window = None
            self._pending_fusion = None
            self._pending_origin = None
            self._stream_windows = windows
        return VirtualScan(*(torch.stack([o[k] for o in outs])
                             for k in range(5)), adaption=outs[0].adaption)

    # ------------------------------------------------- the fused volume
    def _select_stream_frame(self, frame: int) -> None:
        sw = self._stream_windows
        if sw is None:
            raise ValueError("frame= indexing requires a preceding "
                             "transfer_stream")
        n = int(sw.points.shape[0])
        if not -n <= frame < n:
            raise IndexError(f"frame {frame} out of range for the "
                             f"{n}-frame stream")
        self._pending_window = sw.frame(frame)
        self._pending_fusion = None
        self._fused = False

    def fused_state(self, frame: int | None = None) -> TS.TSDFState:
        """The fused TSDF volume of the last transferred frame, integrated
        on first demand: mesh runs the S-scan chain (weight written),
        mergemesh one integrate whose weight is not written (its contents
        are then unspecified). Under fixed bounds the integrate reads the
        placement's geometry table. After ``transfer_stream`` pass
        ``frame=i``."""
        if frame is not None:
            self._select_stream_frame(frame)
        if self._fused and self._vol_state is not None:
            return self._vol_state
        pend = self._pending_fusion
        if pend is None:
            w = self._pending_window
            if w is None:
                if self._stream_windows is not None:
                    raise ValueError(
                        "fused_state() after transfer_stream is ambiguous "
                        "— pass frame=i to select one of the "
                        f"{self._stream_windows.points.shape[0]} streamed "
                        "frames")
                raise RuntimeError("no fused volume yet — run a transfer "
                                   "first")
            if self._pending_mode == "mesh":
                pts_all, ris = self._project_window_scans(w)
                origin, active = (self._pending_origin
                                  if self._pending_origin is not None
                                  else self._mesh_placement(w, pts_all))
                s = self.source
                state = self._integrate_chain(
                    self._take_state(), ris, s.fov_up, s.fov_down, origin,
                    active, self._ensure_geom(s.fov_up, s.fov_down, s.H))
                self._fused_now(state, origin, self._mesh_sources(ris))
                return state
            ri, origin, active = self._merged_image(w)
            t = self.target
            pend = (ri, t.fov_up, t.fov_down, origin, active)
            self._pending_fusion = pend
        ri, fu, fd, origin, active = pend
        state = self._integrate(
            self._take_state(), ri, fu, fd, origin, active, reset=True,
            geom=self._ensure_geom(fu, fd, ri.range.shape[0]),
            write_weight=False)
        self._fused_now(state, origin, [(ri, fu, fd)])
        return state

    #: volumes of at least this many voxels export through the surface
    #: cells (ops/surface.py) instead of fetching the whole state
    _CELLS_EXTRACT_MIN_VOX = 1 << 24

    def _use_cells_extract(self, extract: str) -> bool:
        if extract not in ("auto", "cells", "host"):
            raise ValueError(f"extract must be auto|cells|host: {extract!r}")
        if extract != "auto":
            return extract == "cells"
        return int(np.prod(self.vol_dims)) >= self._CELLS_EXTRACT_MIN_VOX

    def export_mesh(self, path: str, colorize=None,
                    extract: str = "auto") -> int:
        """Write the last frame's fused volume's surface as a PLY mesh;
        returns the triangle count.

        Args:
          colorize: optional (n_labels, 3) uint8 LUT applied to each
            vertex's nearest-voxel label.
          extract: "host" fetches the whole volume and marches it there;
            "cells" compacts the candidate surface cells on the volume's
            device (the same geometry, winding from the cell's trilinear
            gradient); "auto" takes "cells" from 2**24 voxels on.
        """
        state = self.fused_state()
        origin = np.asarray(self._last_origin, np.float32)
        if self._use_cells_extract(extract):
            want_labels = colorize is not None
            cells = extract_surface_cells(
                state.tsdf, state.label if want_labels else None,
                want_labels=want_labels)
            tris, tcell = marching_tetrahedra_cells(
                cells.idx, cells.vals, 0.0, return_cells=True)
            colors = None
            if want_labels and tris.shape[0]:
                g = np.rint(tris.reshape(-1, 3)).astype(np.int64)
                # a rounded vertex is always a corner of its own cell
                rows = np.repeat(tcell, 3)
                local = np.clip(g - cells.idx[rows], 0, 1)
                corner = local[:, 0] + 2 * local[:, 1] + 4 * local[:, 2]
                lbl = cells.labels[rows, corner]
                colors = colorize[np.clip(lbl, 0, colorize.shape[0] - 1)]
        else:
            tsdf = state.tsdf.cpu().to(torch.float32).numpy()
            tris = marching_tetrahedra(tsdf, 0.0)
            colors = None
            if colorize is not None and tris.shape[0]:
                g = np.clip(np.rint(tris.reshape(-1, 3)).astype(int), 0,
                            np.asarray(self.vol_dims) - 1)
                lbl = state.label.cpu().to(torch.int32).numpy()[
                    g[:, 0], g[:, 1], g[:, 2]]
                colors = colorize[np.clip(lbl, 0, colorize.shape[0] - 1)]
        verts = (tris * self.vol_spec.voxel_size + origin).reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
        write_ply(path, verts, faces, colors=colors)
        return faces.shape[0]
