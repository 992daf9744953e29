"""Interactive 3D/2D scan viewer (vispy), plus its testable core (the
port's counterpart of ``lidar_transfer_tpu/interactive.py``).

``FrameStepper`` and ``InteractiveViewer`` are the original's.
``frame_payload`` takes the port's ``RangeImage``/``VirtualScan`` on either
device: its title metrics come from ``metrics/compare.compare_scans`` on
that device (on the card the confusion counts are the kernel of
``csrc/confusion.cu``), and every display array is moved to the host
(``.cpu().numpy()``) before the numpy image helpers of ``utils/images``
see it. ``InteractiveViewer`` imports vispy when it is built; neither the
card machine nor a headless host has vispy, so ``lt-visualize-torch
--interactive`` exits 2 with a message there.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

#: keyboard bindings ≡ laserscanvis.py:338-354
KEY_ACTIONS = {"n": "next", "b": "back", "q": "quit",
               "1": "view_1", "2": "view_2", "3": "view_3"}


class FrameStepper:
    """Frame index + polled action queue (vispy-free).

    Mirrors the reference's unsynchronized action flag + ``get_action``
    polling loop (laserscanvis.py:32-34, 356-361), but with a real queue
    so fast key presses are not lost.
    """

    def __init__(self, n_frames: int, start: int = 0):
        if n_frames <= 0:
            raise ValueError("need at least one frame")
        self.n_frames = n_frames
        self.index = min(max(start, 0), n_frames - 1)
        self.view_mode = 3
        self._queue: collections.deque[str] = collections.deque()

    def key(self, key: str) -> str | None:
        """Translate a key press into a queued action; returns it."""
        action = KEY_ACTIONS.get(key.lower())
        if action is not None:
            self._queue.append(action)
        return action

    def get_action(self, timeout: float = 0.0) -> str:
        """Pop the next action, waiting up to ``timeout`` seconds;
        'no_action' when the queue stays empty (≡ get_action :356-361)."""
        deadline = time.monotonic() + timeout
        while True:
            if self._queue:
                return self._queue.popleft()
            if time.monotonic() >= deadline:
                return "no_action"
            time.sleep(0.01)

    def apply(self, action: str) -> bool:
        """Apply a stepping/view action; True if the frame index moved.

        Stepping clamps at the sequence ends (the reference wraps modulo
        and silently jumps from last to first; clamping is friendlier and
        documented here as a deviation).
        """
        old = self.index
        if action == "next":
            self.index = min(self.index + 1, self.n_frames - 1)
        elif action == "back":
            self.index = max(self.index - 1, 0)
        elif action.startswith("view_"):
            self.view_mode = int(action[-1])
        return self.index != old


def _host(x) -> np.ndarray:
    """A tensor of any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _colorize_range(rng: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    from lidar_transfer_tpu_torch.utils.images import convert_range

    return cmap[(convert_range(rng) * 255).astype(np.uint8)]


def frame_payload(source_ri, cfg, *, virtual=None, source_points=None,
                  source_labels=None, max_label: int = 260) -> dict:
    """All display data for one frame (numpy out; unit-tested).

    Args:
      source_ri: RangeImage of the source scan (tensors of any device).
      cfg: TransferConfig (color map).
      virtual: optional VirtualScan (or any object with its fields) on the
        source's device to show side-by-side + diff; its metrics are
        ``metrics.compare.compare_scans`` on that device.
      source_points / source_labels: raw cloud for the 3D view (tensors or
        arrays).

    Returns dict with:
      rows: [(name, HxWx3 uint8)] 2D canvas rows (source, then target);
      diff: HxWx3 uint8 label-disagreement image (when virtual given);
      title: "IoU .. Acc .. MSE .." metrics string (≡ set_diff :277-278);
      points_3d / colors_3d: source cloud view;
      virtual_points_3d / virtual_colors_3d: synthesized cloud view.
    """
    from lidar_transfer_tpu_torch.utils.images import (get_mpl_colormap,
                                                       label_image_rgb)

    viridis = get_mpl_colormap("viridis")
    src_lbl = _host(source_ri.label)
    rows = [("src range", _colorize_range(_host(source_ri.range), viridis)),
            ("src remission",
             viridis[(np.clip(_host(source_ri.remission), 0, 1) * 255
                      ).astype(np.uint8)]),
            ("src labels", label_image_rgb(src_lbl, cfg))]

    payload: dict = {"rows": rows, "title": "", "diff": None}
    lut = label_image_rgb(np.arange(max_label), cfg)

    if source_points is not None:
        payload["points_3d"] = _host(source_points)
        if source_labels is not None:
            payload["colors_3d"] = (
                lut[np.clip(_host(source_labels), 0, max_label - 1)]
                / 255.0)
        else:
            z = payload["points_3d"][:, 2]
            payload["colors_3d"] = viridis[
                (np.clip((z + 3.0) / 6.0, 0, 1) * 255).astype(np.uint8)
            ] / 255.0

    if virtual is not None:
        from lidar_transfer_tpu_torch.metrics.compare import compare_scans

        v_lbl = _host(virtual.label)
        rows += [("virt range", _colorize_range(_host(virtual.range),
                                                viridis)),
                 ("virt remission",
                  viridis[(np.clip(_host(virtual.remission), 0, 1)
                           * 255).astype(np.uint8)]),
                 ("virt labels", label_image_rgb(v_lbl, cfg))]
        if v_lbl.shape == src_lbl.shape:
            res = compare_scans(
                source_ri.label, source_ri.mask, source_ri.range,
                torch.clamp(source_ri.remission, min=0.0),
                virtual.label, virtual.range, virtual.remission,
                max_label=max_label)
            diff = _host(res.label_diff) > 0
            payload["diff"] = (np.stack([diff] * 3, -1) * 255
                               ).astype(np.uint8)
            # window-title metrics ≡ laserscanvis.py:277-278; one read
            iou, acc, mse = torch.stack(
                [res.mean_iou, res.mean_acc, res.mse]).tolist()
            payload["title"] = (f"IoU {iou:.4f}  "
                                f"Acc {acc:.4f}  "
                                f"MSE {mse:.2f}")
        pts_v = _host(virtual.points).reshape(-1, 3)
        msk_v = _host(virtual.mask).reshape(-1)
        payload["virtual_points_3d"] = pts_v[msk_v]
        payload["virtual_colors_3d"] = (
            lut[np.clip(v_lbl.reshape(-1)[msk_v], 0, max_label - 1)]
            / 255.0)
    return payload


class InteractiveViewer:
    """vispy shell: linked turntable 3D views + image canvases.

    Only constructed when vispy imports (lt-visualize --interactive).
    """

    def __init__(self, n_frames: int, load_payload, title="lidar-transfer",
                 start: int = 0):
        import vispy.scene  # noqa: F401 — hard requirement here
        from vispy import app, scene

        self.stepper = FrameStepper(n_frames, start=start)
        self._load = load_payload
        self._app = app

        self.canvas3d = scene.SceneCanvas(keys="interactive", show=True,
                                          title=title, size=(1100, 550))
        grid = self.canvas3d.central_widget.add_grid()
        self.view_src = grid.add_view(0, 0)
        self.view_virt = grid.add_view(0, 1)
        for v in (self.view_src, self.view_virt):
            v.camera = scene.TurntableCamera(fov=45.0, distance=40.0)
        # linked navigation ≡ the reference's shared camera state
        self.view_virt.camera.link(self.view_src.camera)
        self.mark_src = scene.visuals.Markers(parent=self.view_src.scene)
        self.mark_virt = scene.visuals.Markers(parent=self.view_virt.scene)

        self.canvas2d = scene.SceneCanvas(keys="interactive", show=True,
                                          title=f"{title} — images",
                                          size=(1400, 600))
        self._img_grid = self.canvas2d.central_widget.add_grid()
        self._img_visuals = []

        for c in (self.canvas3d, self.canvas2d):
            c.events.key_press.connect(self._on_key)

        self._show(self.stepper.index)

    # -- events -----------------------------------------------------------
    def _on_key(self, event):
        if event.key is None:
            return
        action = self.stepper.key(str(event.key).lower())
        if action == "quit":
            self._app.quit()
        elif action is not None:
            if action.startswith("view_"):
                # visibility toggle only — no payload reload (a reload
                # re-runs the whole transfer + metrics per keypress)
                self.stepper.apply(action)
                self._apply_view_mode()
                self.canvas3d.update()
            elif self.stepper.apply(action):
                self._show(self.stepper.index)

    # -- drawing ----------------------------------------------------------
    def _apply_view_mode(self):
        """View modes ≡ laserscanvis.py:338-354: 1 = source only,
        2 = virtual only, 3 = both."""
        mode = self.stepper.view_mode
        self.mark_src.visible = mode in (1, 3)
        self.mark_virt.visible = mode in (2, 3)

    def _show(self, idx: int):
        from vispy import scene

        payload = self._load(idx)
        self._apply_view_mode()
        if "points_3d" in payload:
            self.mark_src.set_data(payload["points_3d"],
                                   face_color=payload["colors_3d"],
                                   size=1.5, edge_width=0)
        if "virtual_points_3d" in payload:
            self.mark_virt.set_data(payload["virtual_points_3d"],
                                    face_color=payload["virtual_colors_3d"],
                                    size=1.5, edge_width=0)
        rows = list(payload["rows"])
        if payload.get("diff") is not None:
            rows.append(("diff", payload["diff"]))
        while len(self._img_visuals) < len(rows):
            r = len(self._img_visuals)
            view = self._img_grid.add_view(r, 0)
            view.camera = scene.PanZoomCamera(aspect=1)
            vis = scene.visuals.Image(parent=view.scene, method="auto")
            self._img_visuals.append((view, vis))
        for (view, vis), (_, img) in zip(self._img_visuals, rows):
            vis.set_data(img)
            vis.visible = True
            view.camera.set_range(margin=0)
        # hide surplus visuals when the row count SHRINKS (e.g. stepping
        # past the last prediction file) — stale virt/diff rows would
        # otherwise keep showing the previous frame
        for view, vis in self._img_visuals[len(rows):]:
            vis.visible = False
        # the title carries IoU/Acc/MSE of the CURRENT frame; clear it
        # when the frame has none rather than keep the previous frame's
        self.canvas2d.title = payload.get("title") or "lidar-transfer-tpu"
        self.canvas3d.update()
        self.canvas2d.update()

    def run(self):
        self._app.run()
