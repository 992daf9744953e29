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
  catmesh   — on its splat engine (the default), the mergemesh body with
              ``adaption="catmesh"`` on the output: every candidate carries
              its own source pixel's label, so labels never bleed across
              category seams, which is what per-category meshing is for.
              On its ``"oracle"`` engine, the literal per-category
              construction: the merged image integrated in the frame
              (kernel C), one iso-surface per category (marched on the
              host from the seam-aware surface cells, or from the whole
              volume below 2**24 voxels) and the target's rays cast
              against those meshes (``ops/triangles.raycast_mesh``: the
              mesh raycast kernel on the card, its plain version on the
              CPU).

A target denser than the source (vertically or horizontally) adds chord
candidates between adjacent connected source returns
(``ops/splat._interp_candidates``); such frames take the classic deferred
mergemesh body, as the JAX engine does by default.

``synthesis="raymarch"`` marches the target's rays through the fused volume
(``ops/raycast``, the raymarch kernel on the card) in place of the splat.
The march reads the volume, so it is integrated in every frame (never
deferred), and ``transfer_fast``/``transfer_stream`` take ``transfer``.

``resynthesize_rolling_shutter`` re-casts the last frame with the rays of
a sensor that moves while it spins: by re-projecting the splat winners or
the volume's band samples against the per-column origins, or by marching
the moving rays, one origin a ray, through the fused volume.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
from lidar_transfer_tpu_torch.ops import projection as P
from lidar_transfer_tpu_torch.ops import raycast as RC
from lidar_transfer_tpu_torch.ops import tsdf as TS
from lidar_transfer_tpu_torch.ops.marching import (dedupe_mesh,
                                                   marching_tetrahedra,
                                                   marching_tetrahedra_cells)
from lidar_transfer_tpu_torch.ops.splat import (_band_samples,
                                                _target_assemble,
                                                splat_synthesize)
from lidar_transfer_tpu_torch.ops.surface import extract_surface_cells
from lidar_transfer_tpu_torch.ops.transforms import (interpolate_pose,
                                                     transform_points)
from lidar_transfer_tpu_torch.ops.triangles import (mesh_hit_attributes,
                                                    raycast_mesh)
from lidar_transfer_tpu_torch.ops.tsdf_cuda import (integrate_chain_cuda,
                                                    integrate_cuda,
                                                    precompute_geometry_cuda)
from lidar_transfer_tpu_torch.pipeline.multiscan import (ScanWindow,
                                                         merge_window)
from lidar_transfer_tpu_torch.utils.plyio import write_ply
from lidar_transfer_tpu_torch.utils.runtime import span


class CategoryMesh(NamedTuple):
    """The per-category meshes of an oracle catmesh frame, concatenated
    (host numpy): world vertices, faces, and each vertex's category and
    remission."""

    verts: np.ndarray        # (V,3) f32
    faces: np.ndarray        # (T,3) i32
    labels: np.ndarray       # (V,)  i32
    rems: np.ndarray         # (V,)  f32


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
    # "splat" (band splatting) or "raymarch" (target rays through the
    # fused volume)
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
    # iso-surfaces and a mesh raycast)
    catmesh_engine: str = "splat"
    # chord candidates for a denser target: "auto"/True when the target is
    # denser, False never (interior target rows/columns stay empty)
    upsample_interp: bool | str = "auto"
    # connectivity angle (degrees) of two adjacent returns' chord
    interp_angle_deg: float = 3.0
    # a dict to which catmesh's oracle adds the wall time (s) of each of
    # its stages, the device synchronised around each; None: not timed
    spans: dict | None = None

    def __post_init__(self):
        if self.synthesis not in ("splat", "raymarch"):
            raise ValueError(f"synthesis must be 'splat' or 'raymarch': "
                             f"{self.synthesis!r}")
        if self.mesh_attrs not in ("fold", "volume"):
            raise ValueError(f"mesh_attrs must be 'fold' or 'volume': "
                             f"{self.mesh_attrs!r}")
        if self.catmesh_engine not in ("splat", "oracle"):
            raise ValueError(f"catmesh_engine must be 'splat' or 'oracle': "
                             f"{self.catmesh_engine!r}")
        self.device = torch.device(self.device)
        t = self.target
        ba = (np.asarray(t.beam_angles) if t.beam_angles is not None
              else None)
        sba = (np.asarray(self.source.beam_angles)
               if self.source.beam_angles is not None else None)
        self.t_beam_angles = self._tensor(ba)
        self.s_beam_angles = self._tensor(sba)
        # the target's rays, built once (the target's beam angles where it
        # has them)
        self.rays = self._tensor(RC.generate_rays(
            t.H, t.W, t.fov_up, t.fov_down, beam_angles=ba))
        self._s_beam_gap = (float(np.abs(np.diff(np.sort(sba))).max())
                            if sba is not None and len(sba) > 1 else 0.0)
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
        # the oracle catmesh frame's meshes (CategoryMesh), or None
        self._last_mesh = None

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

    def _synthesize(self, state, origin, active, sources, pts=None,
                    valid=None) -> VirtualScan:
        """Band splatting of the fused ``sources``, a list of (range
        image, fov_up, fov_down), whose ``state`` is read by the volume
        attributes alone; or, with raymarch synthesis, the march through
        ``state`` with the occupancy of the fused cloud ``pts``/``valid``."""
        if self.synthesis == "raymarch":
            return self._raycast(state, origin, pts, valid)
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

    def _src_pixel_angle(self, fov_up=None, fov_down=None, H=None) -> float:
        """The largest angle a pixel of the fused source images spans, the
        bound of ``occupancy_from_points``' lateral footprint: fov / H for
        uniform rows (the source's by default), at least the largest gap of
        a source beam table (cached at construction)."""
        s = self.source
        fu = s.fov_up if fov_up is None else fov_up
        fd = s.fov_down if fov_down is None else fov_down
        h = s.H if H is None else H
        ang = float(np.deg2rad(abs(fu - fd))) / max(int(h), 1)
        return max(ang, self._s_beam_gap)

    def _raycast(self, state, origin, pts, valid) -> VirtualScan:
        """The target's rays marched through ``state`` from the sensor at
        the origin: occupancy from the fused points (O(points)), a fine
        step of 2 voxels (the negative band is at least the 5-voxel
        truncation thick along any ray, and the trilinear refinement
        recovers sub-voxel range)."""
        occ = RC.occupancy_from_points(
            pts, valid, origin, self.vol_spec,
            pixel_angle_rad=self._src_pixel_angle())
        t = self.target
        res = RC.raycast_tsdf(
            state, self.vol_spec, self.rays,
            torch.zeros(3, dtype=torch.float32, device=self.device), t.H,
            t.W, occ=occ, fine_step=2.0, vol_origin=origin)
        return VirtualScan(range=res.range, label=res.label,
                           remission=res.remission, points=res.endpoints,
                           mask=res.hit, adaption=self.cfg.adaption)

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
        fov, origin, active dims, the merged cloud's points and valid
        mask)."""
        pts, rem, lbl, valid = merge_window(window)
        t = self.target
        ri = P.range_project(
            pts, rem, lbl, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles, workspace=self._zbuf)
        origin, active = self._frame_volume(pts, valid)
        return ri, origin, active, pts, valid

    def _mergemesh_core(self, window: ScanWindow, state, geom=None):
        """Whole-frame body that integrates the volume in the frame."""
        ri, origin, active, pts, valid = self._merged_image(window)
        t = self.target
        state = self._integrate(state, ri, t.fov_up, t.fov_down, origin,
                                active, reset=True, geom=geom)
        vs = self._synthesize(state, origin, active,
                              [(ri, t.fov_up, t.fov_down)], pts, valid)
        return vs, ri, state, origin

    def _mergemesh_core_deferred(self, window: ScanWindow):
        """Volume-free body: projection and splat only."""
        ri, origin, active, _, _ = self._merged_image(window)
        t = self.target
        vs = self._synthesize(None, origin, active,
                              [(ri, t.fov_up, t.fov_down)])
        return vs, ri, origin, active

    def mergemesh(self, window: ScanWindow
                  ) -> tuple[VirtualScan, P.RangeImage]:
        """Merged-cloud adaption with its range image: the volume
        deferred (``defer_volume``) or integrated in the frame."""
        t = self.target
        if self._defer_active():
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
                              self._mesh_sources(ris),
                              pts_all.reshape(-1, 3), window.valid.reshape(-1))
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
        if self._defer_active() and self.mesh_attrs == "fold":
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

    # ----------------------------------------------------------- catmesh
    @contextlib.contextmanager
    def _stage(self, name: str):
        """The enclosed stage is the recorder's span ``oracle.<name>``
        (``utils/runtime``); with ``spans``, its wall time is also added to
        ``self.spans[name]``, the device synchronised at both ends."""
        spans = self.spans
        if spans is None:
            with span(f"oracle.{name}"):
                yield
            return
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        try:
            with span(f"oracle.{name}"):
                yield
        finally:
            sync()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0

    def catmesh(self, window: ScanWindow
                ) -> tuple[VirtualScan, P.RangeImage]:
        """Category-mesh adaption with its range image.

        ``catmesh_engine="splat"`` runs the mergemesh body. ``"oracle"``
        extracts one iso-surface per semantic category and casts the
        target's rays against them: the merged image at the target's fov
        is integrated in the frame (reset, weight not written; the
        geometry table under fixed bounds); for each category ``c`` the
        field ``tsdf where label == c else +1`` is marched, so adjacent
        categories never share a triangle; the meshes, deduplicated, are
        raycast nearest-hit (``ops/triangles.raycast_mesh``), the hit's
        label from the triangle's vertex 0 and its remission the mean of
        its 3 vertices. An empty mesh gives the all-zero scan.

        With ``spans`` a dict, the oracle adds to it the wall time (s) of
        each stage, the device synchronised around each: projection,
        integrate, cells (or volume: the whole state fetched), march[c] of
        each category, dedupe, upload, raycast, attributes.
        """
        if self.catmesh_engine == "splat":
            vs, ri = self.mergemesh(window)
            return vs._replace(adaption="catmesh"), ri
        t = self.target
        with self._stage("projection"):
            ri, origin, active, _, _ = self._merged_image(window)
        with self._stage("integrate"):
            geom = self._ensure_geom(t.fov_up, t.fov_down, self.source.H)
            state = self._integrate(self._take_state(), ri, t.fov_up,
                                    t.fov_down, origin, active, reset=True,
                                    geom=geom, write_weight=False)
        self._materialised(state, origin, [(ri, t.fov_up, t.fov_down)])
        mesh = self._category_mesh(state, origin)
        self._last_mesh = mesh
        return self._cast_mesh(mesh), ri

    def _category_mesh(self, state, origin) -> CategoryMesh | None:
        """The per-category meshes of ``state`` in world coordinates (None
        where no category has a surface): from the seam-aware surface
        cells (``ops/surface``, on the volume's device) from 2**24 voxels
        on, else from the whole volume on the host. A vertex's remission
        is its rounded voxel's (on the cells path, that of its own cell's
        corner)."""
        origin_np = np.asarray(origin, np.float32)
        vox = self.vol_spec.voxel_size
        verts_l, faces_l, lbl_l, rem_l = [], [], [], []
        v_off = 0

        def add(c, tri, rem_of):
            nonlocal v_off
            with self._stage("dedupe"):
                verts, faces, vsoup = dedupe_mesh(tri, return_index=True)
                rem = rem_of(verts, vsoup)
            verts_l.append(verts * vox + origin_np)
            faces_l.append(faces + v_off)
            lbl_l.append(np.full(verts.shape[0], int(c), np.int32))
            rem_l.append(rem)
            v_off += verts.shape[0]

        if self._use_cells_extract("auto"):
            # the seam-aware candidate set is a superset of every
            # per-category field's crossing cells, so each category's
            # field comes from the K cells' corner labels alone
            with self._stage("cells"):
                cells = extract_surface_cells(
                    state.tsdf, state.label, state.rem, seams=True,
                    want_labels=True, want_rems=True)
            cats = (np.unique(cells.labels[cells.vals < 0])
                    if cells.idx.shape[0] else np.zeros((0,), np.int32))
            for c in cats[cats > 0]:
                with self._stage(f"march[{int(c)}]"):
                    fv = np.where(cells.labels == int(c), cells.vals,
                                  np.float32(1.0))
                    sub = np.flatnonzero((fv.min(axis=1) < 0)
                                         & (fv.max(axis=1) >= 0))
                    tri, tcell = marching_tetrahedra_cells(
                        cells.idx[sub], fv[sub], 0.0, return_cells=True)
                if tri.shape[0] == 0:
                    continue

                def rem_of(verts, vsoup, sub=sub, tcell=tcell):
                    # rounded vertex -> a corner of its OWN cell
                    g = np.round(verts).astype(np.int64)
                    rows = sub[tcell[vsoup // 3]]
                    local = np.clip(g - cells.idx[rows], 0, 1)
                    corner = local[:, 0] + 2 * local[:, 1] + 4 * local[:, 2]
                    return cells.rems[rows, corner]

                add(c, tri, rem_of)
        else:
            with self._stage("volume"):
                tsdf = state.tsdf.cpu().to(torch.float32).numpy()
                label_vol = state.label.cpu().to(torch.int32).numpy()
                rem_vol = state.rem.cpu().to(torch.float32).numpy()
            for c in np.unique(label_vol[label_vol > 0]):
                with self._stage(f"march[{int(c)}]"):
                    # the category's own signed field: other categories'
                    # voxels read as +1 (outside), so the zero crossing
                    # wraps only this category's band
                    field = np.where(label_vol == int(c), tsdf,
                                     np.float32(1.0))
                    tri = marching_tetrahedra(field, 0.0)
                if tri.shape[0] == 0:
                    continue

                def rem_of(verts, vsoup):
                    gi = np.clip(np.round(verts).astype(np.int64), 0,
                                 np.asarray(tsdf.shape) - 1)
                    return rem_vol[gi[:, 0], gi[:, 1], gi[:, 2]]

                add(c, tri, rem_of)
        if not verts_l:
            return None
        return CategoryMesh(np.concatenate(verts_l), np.concatenate(faces_l),
                            np.concatenate(lbl_l),
                            np.concatenate(rem_l).astype(np.float32))

    def _cast_mesh(self, mesh: CategoryMesh | None) -> VirtualScan:
        """The target's rays from the sensor (origin 0) against ``mesh`` on
        the engine's device: range t on a hit, endpoints ray * t; range,
        label and remission 0 on a miss."""
        tH, tW = self.target.H, self.target.W
        dev = self.device
        if mesh is None:
            zero = torch.zeros((tH, tW), dtype=torch.float32, device=dev)
            return VirtualScan(
                range=zero, label=zero.to(torch.int32), remission=zero,
                points=torch.zeros((tH, tW, 3), dtype=torch.float32,
                                   device=dev),
                mask=zero.to(torch.bool), adaption="catmesh")
        with self._stage("upload"):
            verts = torch.from_numpy(mesh.verts).to(dev)
            faces = torch.from_numpy(mesh.faces).to(dev).to(torch.int64)
            v_lbl = torch.from_numpy(mesh.labels).to(dev)
            v_rem = torch.from_numpy(mesh.rems).to(dev)
            tris = verts[faces]                              # (T,3,3)
        with self._stage("raycast"):
            hits = raycast_mesh(
                torch.zeros(3, dtype=torch.float32, device=dev), self.rays,
                tris)
        with self._stage("attributes"):
            lbl, rem = mesh_hit_attributes(hits, faces, v_lbl, v_rem)
            mask = hits.hit.reshape(tH, tW)
            rng = torch.where(mask, hits.t.reshape(tH, tW), 0.0)
            ends = self.rays.reshape(tH, tW, 3) * rng[..., None]
        return VirtualScan(range=rng, label=lbl.reshape(tH, tW),
                           remission=rem.reshape(tH, tW), points=ends,
                           mask=mask, adaption="catmesh")

    # ---------------------------------------------------------- dispatch
    def _defer_active(self) -> bool:
        """The volume is deferred only where the synthesis cannot read it:
        the splat (mergemesh; mesh with ``mesh_attrs="fold"``)."""
        return self.defer_volume and self.synthesis == "splat"

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
            return self.catmesh(window)
        raise ValueError(f"adaption {adaption!r}")

    @property
    def _mm_family_fast(self) -> bool:
        """Adaptions served by the mergemesh fast body: mergemesh itself,
        and catmesh on its splat engine (the oracle integrates the volume
        and casts its meshes in ``transfer``)."""
        return (self.cfg.adaption == "mergemesh"
                or (self.cfg.adaption == "catmesh"
                    and self.catmesh_engine == "splat"))

    def transfer_fast(self, window: ScanWindow) -> VirtualScan:
        """Transfer one window without its range image; for mergemesh and
        catmesh on its splat engine the volume stays deferred (see
        :meth:`fused_state`). A denser target takes the classic deferred
        body (``transfer``), whose range image the chords are drawn in;
        raymarch synthesis and catmesh's oracle engine take ``transfer``,
        which integrates the volume they read."""
        if (not self._mm_family_fast or self._interp_active
                or self.synthesis != "splat"):
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
            ri, origin, active, _, _ = self._merged_image(w)
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

    # ---------------------------------------------------- rolling shutter
    def _rolling_splat_core(self, pts, rem, lbl, valid, R_table, tau_table):
        """Rolling shutter on the splat path: pixel (h, w) looks along
        R_w d from tau_w (``ops/raycast.generate_rays_moving``). The fused
        image's winners are the surface points themselves, so each winner
        is re-projected against the moving origins with tsdf 0 and an
        exact range (no band candidate is needed)."""
        t = self.target
        win, _ = P.project_winner_order(
            pts, valid, H=self.source.H, W=self.source.W,
            fov_up_deg=t.fov_up, fov_down_deg=t.fov_down,
            beam_angles=self.s_beam_angles, workspace=self._zbuf)
        has = win >= 0
        g = torch.where(has, win, 0).to(torch.int64)
        p = pts[g]
        # winners only, label 0 included (an unlabelled surface stays
        # opaque); the volume cast would hit content inside the configured
        # box alone
        lo = torch.tensor(self.vol_spec.origin, dtype=torch.float32,
                          device=p.device)
        hi = lo + (torch.tensor(self.vol_spec.dims, dtype=torch.float32,
                                device=p.device)
                   * float(np.float32(self.vol_spec.voxel_size)))
        valid_c = has & ((p >= lo) & (p < hi)).all(dim=1)
        return self._rolling_reproject_core(p, lbl[g].to(torch.int32),
                                            rem[g], valid_c, R_table,
                                            tau_table)

    def _rolling_reproject_core(self, p, c_lbl, c_rem, valid_c, R_table,
                                tau_table):
        """The rolling-shutter tail shared by every engine: surface points
        ``p`` (primary frame) re-projected against the per-column moving
        origins (two fixed-point iterations on the firing column, since
        ego motion over a frame moves a point by much less than a column
        an iteration), then z-buffered into the target grid; endpoints go
        back to the primary frame through their pixel's column pose."""
        t = self.target
        W = t.W

        def column_of(pos):
            yaw = -torch.atan2(pos[:, 1], pos[:, 0])
            u = 0.5 * (yaw / math.pi + 1.0) * W
            return torch.clamp(torch.floor(u), 0, W - 1).to(torch.int64)

        w = column_of(p)
        pos_s = p
        for _ in range(2):
            Rw = R_table[w]                               # (N, 3, 3)
            q = p - tau_table[w]
            # the sensor-frame position R_w^T q
            pos_s = (Rw[:, 0, :] * q[:, 0:1] + Rw[:, 1, :] * q[:, 1:2]
                     + Rw[:, 2, :] * q[:, 2:3])
            w = column_of(pos_s)
        rng, lbl, rem, ends_s, mask = _target_assemble(
            pos_s, torch.zeros_like(c_rem), c_lbl, c_rem, valid_c,
            t.fov_up, t.fov_down, self.t_beam_angles, H=t.H, W=W,
            beam_rows=self.t_beam_angles is not None,
            trunc=float(self.vol_spec.trunc_margin), workspace=self._zbuf)
        # with tsdf 0 the endpoint is the winner's sensor-frame position;
        # pixel (h, w) re-enters the primary frame through (R_w, tau_w)
        ends = (R_table[None, :, :, 0] * ends_s[..., 0:1]
                + R_table[None, :, :, 1] * ends_s[..., 1:2]
                + R_table[None, :, :, 2] * ends_s[..., 2:3])
        ends = torch.where(mask[..., None], ends + tau_table[None], 0.0)
        return rng, lbl, rem, ends, mask

    def _rolling_volume_core(self, state, vol_origin, R_table, tau_table):
        """Rolling shutter for engines whose volume is materialised: every
        fused source ray's first band sample in the volume, moved along its
        own (static) ray onto the zero crossing, t + tsdf * trunc, which is
        the surface point the static splat outputs; then the moving-origin
        tail re-projects it exactly."""
        dev = self.device
        vo = torch.as_tensor(np.asarray(vol_origin, np.float32), device=dev)
        full = torch.tensor(self.vol_spec.dims, dtype=torch.float32,
                            device=dev)
        trunc = float(np.float32(self.vol_spec.trunc_margin))
        parts = []
        for ri, fu, fd in self._last_sources:
            back = P.reverse_project(ri, fov_up_deg=fu, fov_down_deg=fd,
                                     preserve_float=True)
            pos, tc, tsdf_c, lbl_c, rem_c, found = _band_samples(
                state.tsdf, state.label, state.rem, ri.range.reshape(-1),
                back, ri.mask.reshape(-1), vo, full,
                voxel_size=self.vol_spec.voxel_size, samples_per_ray=8,
                label_probe=self.band_label_probe)
            ts = torch.clamp(tc + tsdf_c * trunc, min=0.0)
            scale = torch.where(tc > 0, ts / torch.clamp(tc, min=1e-6), 0.0)
            parts.append((pos * scale[:, None], lbl_c, rem_c, found))
        return self._rolling_reproject_core(
            *(torch.cat([q[i] for q in parts]) for i in range(4)), R_table,
            tau_table)

    def _rolling_occupancy(self, vol_origin):
        """The coarse occupancy of the fused sources' winners, ORed over
        the sources (O(points): the integrate touches voxels only within
        the truncation of an image's endpoint)."""
        occ = None
        for ri, fu, fd in self._last_sources:
            back = P.reverse_project(ri, fov_up_deg=fu, fov_down_deg=fd,
                                     preserve_float=True)
            o = RC.occupancy_from_points(
                back, ri.range.reshape(-1) > 0, vol_origin, self.vol_spec,
                pixel_angle_rad=self._src_pixel_angle(
                    fu, fd, ri.range.shape[0]))
            occ = o if occ is None else occ | o
        return occ

    def resynthesize_rolling_shutter(self, pose_next: np.ndarray,
                                     frame: int | None = None,
                                     engine: str = "auto") -> VirtualScan:
        """Re-cast the last transferred frame with rolling-shutter rays.

        ``pose_next`` is the relative pose over one frame period
        (inv(pose[i]) @ pose[i+1]); each target column's rays leave the
        sensor pose interpolated at its firing time
        (``ops/raycast.generate_rays_moving``). After ``transfer_stream``
        pass ``frame=i`` (negative counts from the end); omitting it
        raises.

        ``engine="auto"``: on the splat path with the frame's window kept
        (``transfer_fast``), the winners are the surface points and are
        re-projected against the moving origins
        (``_rolling_splat_core``); an engine whose volume is materialised
        takes each fused ray's band sample moved onto the surface, then
        the same re-projection (``_rolling_volume_core``).
        ``engine="raymarch"`` marches the moving rays, one origin a ray,
        through ``fused_state()`` (the raymarch kernel on the card), with
        the occupancy of the fused sources' winners.
        """
        if engine not in ("auto", "raymarch"):
            raise ValueError(f"engine must be 'auto' or 'raymarch': "
                             f"{engine!r}")
        if frame is not None:
            self._select_stream_frame(frame)
        if (self._stream_windows is not None
                and self._pending_window is None
                and self._pending_fusion is None):
            raise ValueError(
                "resynthesize_rolling_shutter after transfer_stream is "
                "ambiguous — pass frame=i to select one of the "
                f"{self._stream_windows.points.shape[0]} streamed frames")
        t = self.target
        poses = interpolate_pose(np.eye(4), np.asarray(pose_next, np.float64),
                                 np.linspace(0.0, 1.0, t.W, endpoint=False))
        R_table = self._tensor(poses[:, :3, :3])
        tau_table = self._tensor(poses[:, :3, 3])
        w = self._pending_window
        if engine == "auto" and w is not None and self.synthesis == "splat":
            out = self._rolling_splat_core(*merge_window(w), R_table,
                                           tau_table)
            return VirtualScan(*out, adaption="mergemesh-rolling")
        state = self.fused_state()
        vol_origin = (self.vol_spec.origin if self._last_origin is None
                      else self._last_origin)
        if engine == "auto":
            out = self._rolling_volume_core(state, vol_origin, R_table,
                                            tau_table)
            return VirtualScan(*out, adaption="mergemesh-rolling")
        ba = (np.asarray(t.beam_angles) if t.beam_angles is not None
              else None)
        rays, origins = RC.generate_rays_moving(
            t.H, t.W, t.fov_up, t.fov_down, pose_next, beam_angles=ba)
        res = RC.raycast_tsdf(
            state, self.vol_spec, self._tensor(rays), self._tensor(origins),
            t.H, t.W, occ=self._rolling_occupancy(vol_origin), fine_step=2.0,
            vol_origin=vol_origin)
        return VirtualScan(range=res.range, label=res.label,
                           remission=res.remission, points=res.endpoints,
                           mask=res.hit, adaption="mergemesh-rolling")

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
