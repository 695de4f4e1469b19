"""Iterative two-stage 3D synthesis: heal the neighbours, then the target.

Counterpart of healthivert_tpu/engine/infer3d.py:46-588. Each
of the three passes (upper neighbour, lower neighbour on the pass-1 output,
target on the twice-healed context) runs as batched generator forwards over
all slices of the vertebrae's central 4/5 z-range, shared across volumes.
Host numpy handles the per-slice band geometry between passes (it depends on
the evolving label state); the band planes are built on the device from the
raw uint8 slices and four scalars per slice. The host state is slice-major:
each vertebra's processed z-range is one contiguous (Z, H, W) CT stack and
one label stack, whose rows the geometry reads and the paste-back writes in
place; the output volumes are written from them once, at the end.

Documented deviation, kept from the JAX package: the reference runs the
target pass only inside its "lower neighbour missing" branch, so slices
whose lower neighbour exists reuse a stale output; here the target pass
always runs.

int8 (cfg.compute_dtype "int8"): `quant="auto"` calibrates static
activation scales once, on the call's first real batch, and keeps them for
all three passes; with `quant_store` they persist beside the checkpoint in
the port's own format (`torch.save` of {"meta", "quant"}, fingerprinted to
the generator's weights, written atomically), so that later calls at any
batch size give bit-equal volumes. The JAX package's `.msgpack` store is not
read: its fingerprint hashes the flax tree's paths, this one the port's
state-dict keys.

`mesh=` (parallel/mesh.make_mesh, in one process) shards each dispatch's
slice batch over the mesh's data shards, as the JAX package's shard_map does:
the batch is rounded up to a multiple of the data size, each shard runs once
on the first device of its model group (a model axis replicates, so its
other devices would compute the same numbers), each such device holds one
generator replica and the CAM stack, the shards are launched before any
output is copied back, and gathered in order. Every op is per sample, so
the sharded volumes equal the unsharded ones at the shard's batch size.
"""

from __future__ import annotations

import hashlib
import math
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..data.sampler import remove_small_cc
from ..models.generator import Generator
from ..models.layers import INT8, int8_scope
from ..models.pix2pix import (
    INT8_CALIB_PERCENTILE,
    Pix2PixConfig,
    calib_to_quant,
    calibrate_one,
    quant_scales,
)
from ..parallel.mesh import Mesh, replicate_state
from ..utils import spans
from ..utils.device import resolve_device

MAXHEIGHT = 40

# Rows of x_stage2/fine_seg the reassembly can ever read: x_upper >= x1 - 20
# and x_bottom <= x1 + max(MAXHEIGHT, height). A 64-row window starting 20
# rows above the vertebra top covers every height <= 44; taller vertebrae
# widen the pass's window to the next 32-row bucket (_run_pass).
WINDOW = 64

# bytes of a volume read at a time by the transposed copy into a stack
_BLOCK_BYTES = 1 << 18


def _band_inputs(ct, cam, x1, x2, min_x, max_x):
    """The 40-row mask band plus the context/CAM rows shifted to abut it,
    for a batch: ct, cam (B, H, W) uint8; x1, x2, min_x, max_x (B,)."""
    h = ct.shape[1]
    col = lambda v: v.reshape(-1, 1, 1)
    x1, x2, min_x, max_x = col(x1), col(x2), col(min_x), col(max_x)
    r = torch.arange(h, device=ct.device).reshape(1, h, 1)
    src = torch.where(r < min_x, r + x1 - min_x, x2 + r - max_x)
    valid = (r < min_x) | ((r >= max_x) & (src < h))
    idx = src.clamp(0, h - 1).expand(ct.shape)

    def gather(img):
        return torch.where(valid, torch.gather(img, 1, idx), 0)

    mask = ((r >= min_x) & (r <= max_x)).expand(ct.shape)  # inclusive end
    return gather(ct), mask.to(torch.uint8), gather(cam)


def _prep_inputs(ct_u8, cam_stack, zidx, x1, x2, min_x, max_x, use_bf16):
    cam_sl = cam_stack[zidx]  # (B, H, W) gathered on the device
    ctx_u8, mask_u8, camsh_u8 = _band_inputs(ct_u8, cam_sl, x1, x2, min_x, max_x)
    dt = torch.bfloat16 if use_bf16 else torch.float32
    context = ctx_u8[..., None].to(dt) / 255.0 * 2.0 - 1.0
    mask = mask_u8[..., None].to(dt)
    cam = camsh_u8[..., None].to(dt) / 255.0
    return context, mask, cam


def _calibrate_fwd(gen, ct_u8, cam_stack, zidx, x1, x2, min_x, max_x, ratio,
                   use_bf16=True):
    """One calibration forward of the int8 generator over prepped pass
    inputs (counted in `_forward.dispatches`): its calib tree
    (models.pix2pix.calib_to_quant)."""
    _forward.dispatches += 1
    context, mask, cam = _prep_inputs(
        ct_u8, cam_stack, zidx, x1, x2, min_x, max_x, use_bf16
    )
    return calibrate_one(gen, context, mask, 1.0 - cam, ratio)


def _forward_impl(gen, ct_u8, cam_stack, zidx, x1, x2, min_x, max_x, ratio, w0,
                  scales=None, use_bf16=True, win=WINDOW):
    context, mask, cam = _prep_inputs(
        ct_u8, cam_stack, zidx, x1, x2, min_x, max_x, use_bf16
    )
    with int8_scope(scales=scales):
        out = gen(context, mask, 1.0 - cam, ratio)
    # quantize on the device and crop to the WINDOW rows starting at w0:
    # only those rows are ever pasted back
    fake_u8 = torch.round((out.x_stage2.float() + 1.0) * 127.5).to(torch.uint8)
    seg_u8 = (out.fine_seg > 0.5).to(torch.uint8)
    win = min(win, fake_u8.shape[1])  # small volumes: window = whole slice
    rows = w0.reshape(-1, 1) + torch.arange(win, device=w0.device)
    rows = rows[:, :, None, None].expand(-1, -1, fake_u8.shape[2], 1)
    crop = lambda img: torch.gather(img, 1, rows)
    return crop(fake_u8), crop(seg_u8), out.pred2_h.float() * MAXHEIGHT


def _forward(gen, *args, **kwargs):
    """One batched synthesis forward (counted in `_forward.dispatches`)."""
    _forward.dispatches += 1
    with torch.no_grad():
        return _forward_impl(gen, *args, **kwargs)


_forward.dispatches = 0  # generator forwards dispatched in this process


def _clean_vertebra(label_row: np.ndarray, vert_id: int):
    """The pixels of `label_row == vert_id` that the 8-connected cleanup
    `remove_small_cc(mask, 50)` keeps, as (kept, r0, c0): a boolean box whose
    origin is slice pixel (r0, c0); None where no pixel has the id.

    Only the bounding box of the id's pixels is labelled: every component
    lies inside it, so the box keeps what the whole slice would. Counted in
    `synthesize_volumes.cc_pixels` (pixels labelled) beside
    `synthesize_volumes.slice_pixels` (pixels of the slices cleaned)."""
    vert = label_row == vert_id
    in_rows = np.flatnonzero(vert.any(axis=1))
    if in_rows.size == 0:
        return None
    r0, r1 = int(in_rows[0]), int(in_rows[-1]) + 1
    in_cols = np.flatnonzero(vert[r0:r1].any(axis=0))
    c0, c1 = int(in_cols[0]), int(in_cols[-1]) + 1
    box = vert[r0:r1, c0:c1]
    synthesize_volumes.cc_pixels += box.size
    synthesize_volumes.slice_pixels += vert.size
    return remove_small_cc(box, 50), r0, c0


def _slice_geometry(label_row: np.ndarray, ct_row: np.ndarray, vert_id: int):
    """Band geometry scalars for one slice (rows of the per-vertebra stacks);
    None if the vertebra is absent after connected-component cleanup."""
    cleaned = _clean_vertebra(label_row, vert_id)
    if cleaned is None:
        return None
    kept, r0, _ = cleaned
    rows = np.nonzero(kept)[0] + r0  # slice rows in row-major order
    if rows.size == 0:
        return None
    x1, x2 = int(rows.min()), int(rows.max())
    width = label_row.shape[0]
    height = x2 - x1
    if height > MAXHEIGHT:
        x_mean = int(rows.mean())
        x1 = x_mean - 20
        x2 = x1 + 40
    mask_x = (x1 + x2) // 2
    if mask_x <= MAXHEIGHT // 2:
        min_x = 0
    elif width - mask_x <= MAXHEIGHT / 2:
        min_x = width - MAXHEIGHT
    else:
        min_x = mask_x - MAXHEIGHT // 2
    max_x = min_x + MAXHEIGHT

    ct_u8 = ct_row.astype(np.uint8)
    # "w0" (the output crop origin) is set by _run_pass once the pass's
    # window size is known
    return dict(x1=x1, x2=x2, height=height, min_x=min_x, max_x=max_x,
                ct_u8=ct_u8, width=width)


def _reassemble(geo, x_stage2_win, fine_seg_win, pred_h, ct_row, label_row, vert_id):
    """SHRM paste-back on the host, in place: ct_row and label_row (the
    slice's rows of the per-vertebra stacks) become the pasted slice; rows that
    no paste reaches become zero.
    x_stage2_win / fine_seg_win are the device outputs cropped to the window
    rows starting at geo['w0'] (slice row r maps to r - w0)."""
    x1, x2, height, w0 = geo["x1"], geo["x2"], geo["height"], geo["w0"]
    h = ct_row.shape[0]
    ph = math.ceil(pred_h)
    if ph < height:
        ph = height
    hd = ph - height
    x_upper = x1 - hd // 2
    x_bottom = x_upper + ph
    band = x_bottom > x_upper >= 0
    tail_rows = slice(x2, x2 + h - x_bottom)

    # every source row is read before any row of the slice is written
    ori = geo["ct_u8"]
    ct_head = ((ori[hd // 2 : x1].astype(np.float64) / 255.0 * 2 - 1) + 1) * 127.5
    lb_head = label_row[hd // 2 : x1].copy()
    ct_tail = ori[tail_rows].astype(np.float64)
    lb_tail = label_row[tail_rows].copy()
    # x_stage2 arrives already mapped to the uint8 CT range
    ct_band = x_stage2_win[x_upper - w0 : x_bottom - w0] if band else None
    lb_band = fine_seg_win[x_upper - w0 : x_bottom - w0] * vert_id if band else None

    for row, mid, head, tail in ((ct_row, ct_band, ct_head, ct_tail),
                                 (label_row, lb_band, lb_head, lb_tail)):
        pasted = np.zeros(h, bool)
        pasted[:x_upper] = True
        if band:
            pasted[x_upper:x_bottom] = True
        pasted[x_bottom : x_bottom + tail.shape[0]] = True
        row[~pasted] = 0
        if band:
            row[x_upper:x_bottom] = mid
        row[:x_upper] = head
        row[x_bottom : x_bottom + tail.shape[0]] = tail


_INT_KEYS = ("x1", "x2", "min_x", "max_x", "w0")


def _chunk_arrays(jobs, ratios, job_zidx, i0, batch_size, keys=_INT_KEYS):
    """Stack one dispatch's worth of job arrays (padded by repetition).
    Calibration runs before _run_pass sets "w0", so it passes keys without
    it."""
    chunk = jobs[i0 : i0 + batch_size]
    pad = batch_size - len(chunk)
    rep = lambda key: [j[key] for j in chunk] + [chunk[-1][key]] * pad
    ct = np.stack(rep("ct_u8"))
    rat = np.array(list(ratios[i0 : i0 + len(chunk)]) + [0.0] * pad, np.float32)
    zidx = np.array(
        list(job_zidx[i0 : i0 + len(chunk)])
        + [job_zidx[i0 + len(chunk) - 1]] * pad, np.int64
    )
    ints = {k: np.array(rep(k), np.int64) for k in keys}
    return chunk, ct, rat, zidx, ints


def _run_pass(shards, jobs, ratios, job_zidx, batch_size=32, use_bf16=True, g_quant=None,
              rid=None, which=None):
    """Batched forwards over a list of geometry jobs; returns per-job
    outputs. shards: one (generator, device-resident (NZ, H, W) uint8 CAM
    stack) per shard of each dispatch, the stack's rows indexed by
    job_zidx; g_quant, a quant tree of static int8 scales. With several
    shards each dispatch of batch_size slices (a multiple of the shard
    count) is split evenly over them, every shard launched before any
    output is copied back. rid, which: the patient call and the pass that
    the dispatch and readback spans name."""
    if not jobs:
        return []
    # window for this pass: covers x1-20 .. x1+max(MAXHEIGHT, height) of the
    # tallest job, in 32-row buckets
    need = 20 + max(MAXHEIGHT, max(j["height"] for j in jobs))
    win = max(WINDOW, -(-need // 32) * 32)
    for j in jobs:
        j["w0"] = min(max(j["x1"] - 20, 0), max(j["width"] - win, 0))
    scales = {id(g): quant_scales(g, g_quant) for g, _ in shards}
    per = batch_size // len(shards)
    outs, tag = [], {"pass": which}
    for i0 in range(0, len(jobs), batch_size):
        with spans.span("hv.3d.dispatch", rid=rid, **tag):
            chunk, ct, rat, zidx, ints = _chunk_arrays(jobs, ratios, job_zidx, i0, batch_size)
            launched = []
            for k, (gen, cam_stack) in enumerate(shards):
                part = slice(k * per, (k + 1) * per)
                t = lambda a: torch.from_numpy(a[part]).to(cam_stack.device)
                launched.append(_forward(
                    gen, t(ct), cam_stack, t(zidx), t(ints["x1"]), t(ints["x2"]),
                    t(ints["min_x"]), t(ints["max_x"]), t(rat), t(ints["w0"]),
                    scales=scales[id(gen)], use_bf16=use_bf16, win=win,
                ))
        with spans.span("hv.3d.readback", rid=rid, **tag):
            x2_, seg, ph = (torch.cat([o[i].cpu() for o in launched]).numpy() for i in range(3))
            for k in range(len(chunk)):
                outs.append((x2_[k, :, :, 0], seg[k, :, :, 0], float(ph[k])))
    return outs


def _stack(vol, axis, zr, dtype) -> np.ndarray:
    """The slices `zr` of `vol` along `axis` as one C-ordered (Z, H, W)
    array of `dtype`, always a copy. Transposed a block of rows at a time,
    so that the block being read stays in the cache."""
    src = np.moveaxis(vol, axis, 0)[zr]
    out = np.empty(src.shape, dtype)
    step = max(1, _BLOCK_BYTES // max(1, src[:, :1].nbytes))
    for r in range(0, out.shape[1], step):
        out[:, r : r + step] = src[:, r : r + step]
    return out


def _label_dtype(dtype, vert_id) -> np.dtype:
    """The label stack's dtype: the label volume's own where it holds every
    id a pass writes (vert_id and its neighbours) exactly, else float64,
    the output's dtype."""
    ids = np.array([vert_id - 1, vert_id, vert_id + 1])
    with np.errstate(invalid="ignore"):
        exact = np.array_equal(ids.astype(dtype).astype(ids.dtype), ids)
    return np.dtype(dtype) if exact else np.dtype(np.float64)


def _cam_bucket(n: int) -> int:
    """Row count of the device CAM stack, padded to 16-multiples up to 64
    and to 64-multiples above."""
    if n <= 64:
        return max(16, -(-n // 16) * 16)
    return -(-n // 64) * 64


def _params_reduce(gen: Generator):
    """Sum and sum of squares over every tensor of the generator's state
    dict, in float32 on its device, as two Python floats."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in gen.state_dict().values()])
    return float(flat.sum()), float((flat * flat).sum())


def _quant_meta(gen: Generator):
    """Fingerprint tying a stored quant tree to the weights: a hash of the
    state dict's keys, shapes and dtypes, its sum and sum of squares
    (compared with a relative tolerance: another device may sum in another
    order, while retrained weights differ by far more) and the calibration
    percentile."""
    h = hashlib.blake2b(digest_size=16)
    for k, t in gen.state_dict().items():
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
    tot, sq = _params_reduce(gen)
    return {"struct": h.hexdigest(), "sum": tot, "sq": sq,
            "percentile": float(INT8_CALIB_PERCENTILE)}


def _load_quant_store(path, gen: Generator):
    """The stored quant tree, or None (then the caller recalibrates, with a
    warning) when the file is unreadable or foreign (a JAX .msgpack among
    them), has no fingerprint, or was calibrated for other weights or
    another percentile."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a truncated write, a foreign format
        warnings.warn(f"int8 quant store {path} unreadable ({e!r}); recalibrating")
        return None
    if not (isinstance(blob, dict) and isinstance(blob.get("meta"), dict)
            and isinstance(blob.get("quant"), dict)
            and all(isinstance(v, torch.Tensor) for v in blob["quant"].values())):
        warnings.warn(f"int8 quant store {path} has no weight fingerprint; recalibrating")
        return None
    meta, want = blob["meta"], _quant_meta(gen)
    ok = (
        str(meta.get("struct")) == want["struct"]
        and float(meta.get("percentile", -1)) == want["percentile"]
        and np.isclose(float(meta.get("sum", np.inf)), want["sum"], rtol=1e-4, atol=1e-6)
        and np.isclose(float(meta.get("sq", np.inf)), want["sq"], rtol=1e-4, atol=1e-6)
    )
    if not ok:
        warnings.warn(f"int8 quant store {path} was calibrated for different weights or "
                      "percentile; recalibrating (the store will be rewritten)")
        return None
    return blob["quant"]


def _save_quant_store(path, g_quant, gen: Generator):
    """Store the quant tree with its weight fingerprint, atomically (a temp
    file, then os.replace), so that a cut write leaves no truncated store."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    blob = {"meta": _quant_meta(gen), "quant": {k: v.cpu() for k, v in g_quant.items()}}
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    torch.save(blob, tmp)
    os.replace(tmp, path)


def synthesize_volumes(
    gen: Generator,
    cfg: Pix2PixConfig,
    volumes,
    batch_size: int = 32,
    use_bf16: bool = True,
    axis: int = 2,
    mesh=None,
    quant=None,
    quant_store=None,
    device="cuda",
):
    """Batched multi-vertebra synthesis: the three passes are shared across
    all volumes (vertebrae are independent).

    gen: a `Generator` on `device` whose conv dtype matches the mode:
    "int8" under cfg.compute_dtype "int8", else bfloat16 for use_bf16 and
    None without. volumes: sequence of (ct_vol, label_vol, vert_id,
    cam_vol-or-None), all with the same slice shape along `axis`. Returns a
    list of (ct_fake, label_fake) pairs in input order.

    quant (int8 only): None, per-sample dynamic activation scales; "auto",
    static scales calibrated on this call's first real batch (its first
    pass with jobs); or a quant tree (models.pix2pix.calibrate_int8).
    quant_store (with "auto"): a file of the port's quant store. If it
    holds scales for these weights they are used and no calibration runs;
    otherwise the scales calibrated here are written there.

    mesh: a one-process parallel.mesh.Mesh; each dispatch's batch_size,
    rounded up to a multiple of its data size, is split over its data
    shards' devices (`mesh.data_devices`; `device` is then the device of `gen`, which serves the shards on it)."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= takes a parallel.mesh.Mesh, got {type(mesh).__name__}")
        if mesh.processes > 1:
            raise ValueError("synthesize_volumes(mesh=...) shards over the devices of one "
                             "process; under a process group each process synthesizes its "
                             "own volumes")
        batch_size = -(-batch_size // mesh.size) * mesh.size  # shardable dispatches
    if quant is not None and cfg.compute_dtype != "int8":
        raise ValueError("quant= is only meaningful with compute_dtype='int8'")
    dev = resolve_device(device)
    want = INT8 if cfg.compute_dtype == "int8" else (torch.bfloat16 if use_bf16 else None)
    if gen.dtype != want:
        raise ValueError(
            f"compute_dtype={cfg.compute_dtype!r}, use_bf16={use_bf16} needs a generator "
            f"built with dtype={want}, got {gen.dtype}"
        )
    param_dev = next(gen.parameters()).device
    if param_dev.type != dev.type:
        raise ValueError(f"generator is on {param_dev}, device={dev}")

    synthesize_volumes.calls += 1
    rid = synthesize_volumes.calls
    with spans.span("hv.3d.prep", rid=rid):
        # each vertebra's working state is slice-major over its processed
        # z-range: a float64 CT stack (not integer after a pass) and a label
        # stack in the volume's dtype (passes write integer ids), rows
        # written in place pass after pass
        preps = []
        all_cams = []
        row_off = 0
        for ct_vol, label_vol, vert_id, cam_vol in volumes:
            vert = label_vol == vert_id
            other_axes = (0, 1) if axis == 2 else (0, 2)
            zs = np.nonzero(vert.any(axis=other_axes))[0]
            if zs.size == 0:
                preps.append(None)
                continue
            z0, z1 = int(zs.min()), int(zs.max())
            range_length = z1 - z0 + 1
            new_len = int(range_length * 4 / 5)
            nz0 = z0 + (range_length - new_len) // 2
            nz1 = nz0 + new_len - 1
            center = (nz0 + nz1) // 2
            zr = slice(nz0, nz1 + 1)
            lb = _stack(label_vol, axis, zr, _label_dtype(label_vol.dtype, vert_id))
            preps.append(
                dict(
                    vert_id=vert_id,
                    zr=zr,
                    ratios=[abs(z - center) / range_length * 2 for z in range(nz0, nz1 + 1)],
                    ct=_stack(ct_vol, axis, zr, np.float64),
                    lb=lb,
                    row0=row_off,
                )
            )
            # the CAM never changes across passes: one device-resident uint8
            # stack for all volumes, gathered by row index on the device
            if cam_vol is None:
                all_cams.append(np.zeros(lb.shape, np.uint8))
            else:
                all_cams.append((_stack(cam_vol, axis, zr, cam_vol.dtype) * 255).astype(np.uint8))
            row_off += len(lb)

        if row_off == 0:
            return [
                (np.zeros_like(v[0], np.float64), np.zeros_like(v[0], np.float64))
                for v in volumes
            ]
        cams = np.concatenate(all_cams)
        bucket = _cam_bucket(row_off)
        cam_host = torch.from_numpy(np.pad(cams, ((0, bucket - row_off), (0, 0), (0, 0))))
        cam_stack = cam_host.to(dev)
        shards = [(gen, cam_stack)]
        if mesh is not None:
            stacks = {d: cam_host.to(d) for d in set(mesh.data_devices)}
            shards = [(g, stacks[d])
                      for g, d in zip(replicate_state(gen, mesh), mesh.data_devices)]

        g_quant = None if quant == "auto" else quant
        if quant == "auto" and quant_store and os.path.exists(quant_store):
            g_quant = _load_quant_store(quant_store, gen)
        if g_quant is not None:
            g_quant = {k: v.to(dev) for k, v in g_quant.items()}

    # three passes: upper neighbour, lower neighbour, target; jobs from
    # every volume share the dispatches
    for which, nb in (("upper", -1), ("lower", +1), ("target", 0)):
        tag = {"pass": which}
        with spans.span("hv.3d.geometry", rid=rid, **tag):
            jobs, job_refs, job_ratio, job_rows = [], [], [], []
            for prep in preps:
                if prep is None:
                    continue
                vert_id, ct_rows, lb_rows = prep["vert_id"], prep["ct"], prep["lb"]
                vid = vert_id + nb
                if which == "upper":
                    # both neighbour-presence checks read the original
                    # labels, which the stack holds until the first paste
                    prep["present"] = {
                        d: np.count_nonzero(lb_rows == vert_id + d, axis=(1, 2)) > 200
                        for d in (-1, +1)
                    }
                if which == "upper" and not vert_id > 8:
                    continue
                if which == "lower" and not vert_id < 24:
                    continue
                present = prep["present"].get(nb)
                for i in range(len(ct_rows)):
                    if present is not None and not present[i]:
                        continue
                    geo = _slice_geometry(lb_rows[i], ct_rows[i], vid)
                    if geo is None:
                        continue
                    jobs.append(geo)
                    job_refs.append((prep, i, vid))
                    job_ratio.append(prep["ratios"][i])
                    job_rows.append(prep["row0"] + i)
        if quant == "auto" and g_quant is None and jobs:
            # one calibration forward on this call's first real batch
            _, ct, rat, zidx, ints = _chunk_arrays(
                jobs, job_ratio, job_rows, 0, min(batch_size, len(jobs)),
                keys=("x1", "x2", "min_x", "max_x"),
            )
            t = lambda a: torch.from_numpy(a).to(dev)
            calib = _calibrate_fwd(gen, t(ct), cam_stack, t(zidx), t(ints["x1"]),
                                   t(ints["x2"]), t(ints["min_x"]), t(ints["max_x"]),
                                   t(rat), use_bf16)
            g_quant = calib_to_quant(calib, percentile=INT8_CALIB_PERCENTILE)
            if quant_store:
                _save_quant_store(quant_store, g_quant, gen)
        outs = _run_pass(shards, jobs, job_ratio, job_rows, batch_size, use_bf16, g_quant,
                         rid=rid, which=which)
        with spans.span("hv.3d.reassemble", rid=rid, **tag):
            for geo, (prep, i, vid), (x2_, seg, ph) in zip(jobs, job_refs, outs):
                _reassemble(geo, x2_, seg, ph, prep["ct"][i], prep["lb"][i], vid)

    with spans.span("hv.3d.assemble", rid=rid):
        # zeros, then the processed range in one transposed copy (labels
        # widened to float64 here); np.zeros_like would also write every
        # page that the copy writes anyway
        results = []
        for (ct_vol, *_), prep in zip(volumes, preps):
            order = "F" if np.isfortran(ct_vol) else "C"
            ct_fake = np.zeros(ct_vol.shape, np.float64, order=order)
            lb_fake = np.zeros(ct_vol.shape, np.float64, order=order)
            if prep is not None:
                np.moveaxis(ct_fake, axis, 0)[prep["zr"]] = prep["ct"]
                np.moveaxis(lb_fake, axis, 0)[prep["zr"]] = prep["lb"]
            results.append((ct_fake, lb_fake))
    return results


synthesize_volumes.calls = 0  # patient calls in this process: the request id of its spans
synthesize_volumes.cc_pixels = 0  # pixels the geometry's cleanup labelled (the vertebra's box)
synthesize_volumes.slice_pixels = 0  # pixels of the slices that cleanup was run on


def synthesize_volume(
    gen: Generator,
    cfg: Pix2PixConfig,
    ct_vol: np.ndarray,
    label_vol: np.ndarray,
    vert_id: int,
    cam_vol: Optional[np.ndarray] = None,
    batch_size: int = 32,
    use_bf16: bool = True,
    axis: int = 2,
    mesh=None,
    quant=None,
    quant_store=None,
    device="cuda",
):
    """Synthesize the pseudo-healthy target vertebra across all central
    slices (axis=2 sagittal, axis=1 coronal). Returns (ct_fake, label_fake)
    volumes, zero outside the processed range."""
    return synthesize_volumes(
        gen, cfg, [(ct_vol, label_vol, vert_id, cam_vol)],
        batch_size=batch_size, use_bf16=use_bf16, axis=axis, mesh=mesh,
        quant=quant, quant_store=quant_store, device=device,
    )[0]
