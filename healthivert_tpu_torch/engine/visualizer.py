"""Observability: console + loss_log.txt, JSONL metric sink, HTML galleries.

A copy of healthivert_tpu/engine/visualizer.py:19-192 (the reference's
visdom/wandb/dominate/tensorboardX stack replaced by dependency-free
equivalents; the loss-log format matches the reference's
util/visualizer.py:241-257). The JAX package writes PNGs through PIL; the
port writes them with the standard library (`write_png`: zlib + struct,
8-bit grey or RGB) and does --aspect_ratio's resize with its own separable
cubic (`resize_bicubic`, PIL's BICUBIC kernel and fixed-point rounding,
ops/resample.py).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict

import numpy as np

from ..ops.resample import resample_uint8


def tensor2im(x, lo=-1.0, hi=1.0):
    """[-1,1] (or [0,1]) float image -> uint8 (util/util.py:9-29)."""
    x = np.asarray(x)
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[:, :, 0]
    x = (x - lo) / (hi - lo)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


# visuals whose label contains one of these are [0,1]-coded (segs/masks/CAM
# heatmaps/flow RGB); everything else (real_A/fake_B/real_B CT images) is
# [-1,1]-coded like the reference's fixed tensor2im mapping
_UNIT_RANGE_TOKENS = ("mask", "seg", "cam", "flow")


def visual_to_uint8(label: str, im) -> np.ndarray:
    """Render a named visual to uint8 by its KNOWN coding, not its content.
    A content heuristic (im.min() < 0) renders an all-positive CT crop at
    doubled brightness and a CAM with one tiny negative interpolation
    artifact as near-uniform gray — the same visual must map identically
    every step (util/util.py:9-29 uses a fixed [-1,1] mapping)."""
    if any(t in label.lower() for t in _UNIT_RANGE_TOKENS):
        return tensor2im(im, 0.0, 1.0)
    return tensor2im(im)


# ------------------------------------------------------------------ PNG IO

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path, arr: np.ndarray) -> None:
    """Write an 8-bit (H, W) grey or (H, W, 3) RGB uint8 array as a PNG:
    one IHDR, one zlib IDAT with filter type 0 on every row, IEND."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3) arrays, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    data = (_PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def read_png(path) -> np.ndarray:
    """Read a PNG that `write_png` wrote (8-bit grey or RGB, filter type 0,
    not interlaced) back into a uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, color {color})")
    ch = 1 if color == 0 else 3
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError(f"{path}: PNG row filters other than 0 are not supported")
    return rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, 3)).copy()


# ------------------------------------------------------------ bicubic resize


def resize_bicubic(arr: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """PIL's ``Image.fromarray(arr).resize((out_w, out_h), Image.BICUBIC)``
    on a uint8 (H, W) or (H, W, C) array: the horizontal pass, then the
    vertical, each only where its size changes."""
    if arr.shape[1] != out_w:
        arr = resample_uint8(arr, out_w, 1)
    if arr.shape[0] != out_h:
        arr = resample_uint8(arr, out_h, 0)
    return arr


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.run_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_name = os.path.join(self.run_dir, "loss_log.txt")
        self.metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self.wandb = None
        if getattr(opt, "display_id", 0) > 0:
            # honesty for reference users: --display_id/--display_server/
            # --display_port drove a live visdom dashboard in the reference
            # (util/visualizer.py:83-113, auto-spawning a server); visdom is
            # not in this image, so the live view is the HTML gallery + the
            # JSONL metric sink instead. One-time note so nobody waits on a
            # dashboard that never starts.
            print(
                "note: visdom live display (--display_id "
                f"{opt.display_id}) is replaced by the HTML gallery at "
                f"{os.path.join(self.run_dir, 'web', 'index.html')} and "
                f"{self.metrics_path}; --display_server/--display_port are "
                "ignored"
            )
        if getattr(opt, "use_wandb", False):
            # optional sink, parity with util/visualizer.py:89-91; gated
            # since wandb is not baked into this image
            try:
                import wandb

                self.wandb = wandb.init(
                    project=getattr(opt, "wandb_project_name", "HealthiVert-TPU"),
                    name=opt.name, config=vars(opt),
                )
            except ImportError:
                print("wandb requested but not installed; continuing without it")
        with open(self.log_name, "a") as f:
            f.write(
                f"================ Training Loss ({time.strftime('%c')}) ================\n"
            )

    def print_current_losses(self, epoch, iters, losses: Dict[str, float], t_comp, t_data):
        """Format parity with util/visualizer.py:241-257."""
        message = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
        for k, v in losses.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def log_scalars(self, tag: str, scalars: Dict[str, float], step: int):
        """tensorboardX replacement: append-only JSONL of scalar metrics."""
        rec = {"tag": tag, "step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log({f"{tag}/{k}": float(v) for k, v in scalars.items()}, step=step)

    def log_images(self, visuals: Dict[str, np.ndarray], step: int):
        """wandb image logging (reference util/visualizer.py:173-188): one
        wandb.Image per visual. No-op without --use_wandb."""
        if self.wandb is None:
            return
        import wandb

        imgs = {}
        for label, im in visuals.items():
            imgs[label] = wandb.Image(visual_to_uint8(label, im), caption=label)
        self.wandb.log(imgs, step=step)


class HTMLGallery:
    """Minimal dominate/HTML replacement (util/html.py:6-86).

    With history=True, rows accumulate in {web_dir}/rows.jsonl across
    gallery instances (and process restarts) and save() renders ALL of
    them newest-first — the reference's training page lists every epoch
    from current down to 1 (util/visualizer.py:198-211), not only the
    latest row."""

    def __init__(self, web_dir: str, title: str, history: bool = False):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.rows = []
        self.history_path = os.path.join(web_dir, "rows.jsonl") if history else None

    def add_images(self, ims, txts, width=256, header=None):
        row = (list(ims), list(txts), width, header)
        self.rows.append(row)
        if self.history_path:
            with open(self.history_path, "a") as f:
                f.write(json.dumps(
                    {"ims": row[0], "txts": row[1], "width": width, "header": header}
                ) + "\n")

    def save(self):
        rows = self.rows
        if self.history_path and os.path.exists(self.history_path):
            with open(self.history_path) as f:
                loaded = [json.loads(line) for line in f if line.strip()]
            rows = [
                (r["ims"], r["txts"], r["width"], r.get("header"))
                for r in reversed(loaded)  # newest first, like the reference
            ]
        parts = [
            f"<!DOCTYPE html><html><head><title>{self.title}</title></head><body>",
            f"<h1>{self.title}</h1>",
        ]
        for ims, txts, width, header in rows:
            if header:
                parts.append(f"<h3>{header}</h3>")
            parts.append("<table border='1' style='border-collapse:collapse'><tr>")
            for im, txt in zip(ims, txts):
                parts.append(
                    f"<td style='text-align:center'><img src='images/{im}' "
                    f"width='{width}'><br>{txt}</td>"
                )
            parts.append("</tr></table>")
        parts.append("</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write("\n".join(parts))


def save_images(gallery: HTMLGallery, visuals: Dict[str, np.ndarray], name: str,
                width=256, header=None, aspect_ratio=1.0):
    """Write one result row (util/visualizer.py:21-52).

    aspect_ratio != 1.0 resizes each saved PNG with the reference's exact
    (quirky, h/w-swapped) formula — util/util.py:51-66: ar > 1 stretches to
    (h, w*ar), ar < 1 to (h/ar, w), both bicubic as PIL's BICUBIC.
    """
    ims, txts = [], []
    for label, im in visuals.items():
        arr = visual_to_uint8(label, im)
        h, w = arr.shape[:2]
        if aspect_ratio > 1.0:
            arr = resize_bicubic(arr, h, int(w * aspect_ratio))
        elif aspect_ratio < 1.0:
            arr = resize_bicubic(arr, int(h / aspect_ratio), w)
        fname = f"{name}_{label}.png"
        write_png(os.path.join(gallery.img_dir, fname), arr)
        ims.append(fname)
        txts.append(label)
    gallery.add_images(ims, txts, width, header=header)
