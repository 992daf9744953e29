"""Offline image export + display helpers (the port's copy of
``lidar_transfer_tpu/utils/images.py``, numpy only).

Two functions differ from the original, so that neither matplotlib nor PIL
is needed where the port runs: ``get_mpl_colormap("viridis")`` returns the
table :data:`VIRIDIS` written down from matplotlib, and
``save_virtual_scan_pngs`` encodes its PNGs with ``webviewer.png_bytes``.
Every function takes numpy arrays.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from lidar_transfer_tpu_torch.config import TransferConfig, make_color_lut


#: matplotlib's viridis as a 256x3 uint8 table, the rows
#: ``(matplotlib.colormaps["viridis"].resampled(256)(np.arange(256))[:, :3]
#: * 255).astype(np.uint8)`` gives (matplotlib 3.10.8; read-only)
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)


@functools.lru_cache(maxsize=8)
def get_mpl_colormap(cmap_name: str = "viridis") -> np.ndarray:
    """256x3 uint8 LUT from a matplotlib colormap (≡ tools.py:7-16).

    viridis, the one map the viewers and the PNG export use, is the
    table :data:`VIRIDIS`, so they need no matplotlib; any other name
    imports matplotlib (``ImportError`` without it). Cached: the CLI's
    --png export calls this per frame."""
    if cmap_name == "viridis":
        return VIRIDIS
    import matplotlib

    cmap = matplotlib.colormaps[cmap_name].resampled(256)
    return (cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)


def convert_range(data: np.ndarray, power: float = 16.0) -> np.ndarray:
    """Power-law range normalization for display (≡ tools.py:19-27):
    emphasizes close structure."""
    data = np.asarray(data, np.float64)
    lo, hi = data.min(), data.max()
    if hi <= lo:
        return np.zeros_like(data)
    norm = (data - lo) / (hi - lo)
    return np.power(norm, 1.0 / power)


def label_image_rgb(label: np.ndarray, cfg: TransferConfig) -> np.ndarray:
    """(H,W) raw label ids -> (H,W,3) uint8 RGB via the (BGR) color map.

    The LUT build (a Python loop over the color map) is cached per
    config object — the CLI's --png export calls this per frame."""
    # cache holds (cfg, lut) so the cfg object stays alive while its
    # LUT is cached — an id()-keyed cache could silently serve a stale
    # LUT when a garbage-collected config's address is reused
    entry = getattr(label_image_rgb, "_lut_cache", None)
    if entry is None or entry[0] is not cfg:
        entry = (cfg, make_color_lut(cfg.color_map_bgr))
        label_image_rgb._lut_cache = entry    # at most one config's LUT
    lut = entry[1]
    bgr = lut[np.clip(label, 0, lut.shape[0] - 1)]
    rgb = bgr[..., ::-1]
    return (rgb * 255).astype(np.uint8)


def range_image_rgb(rng: np.ndarray) -> np.ndarray:
    """(H,W) range -> (H,W,3) uint8 viridis rendering."""
    lut = get_mpl_colormap("viridis")
    idx = (convert_range(rng) * 255).astype(np.uint8)
    return lut[idx]


def save_virtual_scan_pngs(out_path: str, idx: int, vs,
                           cfg: TransferConfig) -> None:
    """Write labels_png/velodyne_png renders of a VirtualScan whose
    ``label`` and ``range`` are numpy arrays (the caller moves a scan on
    the card to the host). The files are encoded by
    ``webviewer.png_bytes`` (the standard library's zlib, no PIL)."""
    from lidar_transfer_tpu_torch.webviewer import png_bytes

    lbl = np.asarray(vs.label)
    rng = np.asarray(vs.range)
    for sub, img in (("labels_png", label_image_rgb(lbl, cfg)),
                     ("velodyne_png", range_image_rgb(rng))):
        os.makedirs(os.path.join(out_path, sub), exist_ok=True)
        with open(os.path.join(out_path, sub, f"{idx:06d}.png"), "wb") as f:
            f.write(png_bytes(img))
