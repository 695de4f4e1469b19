"""Timing ablation of the contextual-attention forward on the card.

Counterpart of the JAX package's experiments/attn_ablate.py. It runs the
forward of `attention_v2` with one stage dropped or changed at a time, so
that the differences give each stage's cost (the numerics of a dropped
stage are meaningless; only its time counts), plus two candidate designs
that must match `full`:

  full         the forward as it ships
  no_score     s = 0.5 everywhere, no norm and no score GEMM -> score cost
  no_fuse      the softmax of the unfused scores          -> fuse cost
  no_softmax   probs = the fused scores as they stand     -> softmax cost
  no_paste     y = 0, no paste GEMM                       -> paste cost
  paste_bf16   CANDIDATE: probs rounded once to bf16 for the paste (bf16:
               the hi plane alone, one product in place of the hi/lo pair;
               float32: probs and b_full rounded to bf16, exact in TF32,
               one product in place of the three of 3xTF32)
  fold_norm    CANDIDATE: the softmax stores exp * g unnormalised, and each
               probs column's 1/sum scales it as the paste loads it
  floor        y = 0 and nothing else: the launch floor

The dtype picks the route, both on the tensor cores, each mode an
instantiation of the forward's kernels and channels zero-padded to 64 here
(no copy at C = 64); `full` equals `attention_v2` of the same dtype bit for
bit:
  bfloat16  csrc/attention_tc_ablate.cu: the kernels of
            csrc/attention_tc.cu (TMA-fed wgmma score and paste GEMMs, the
            fuse + softmax sweep writing probs split hi/lo), a ring of 4
  float32   csrc/attention_tf32_ablate.cu: the kernels of
            csrc/attention_tf32.cu (the same GEMMs in 3xTF32, every operand
            split into TF32 big and small halves), a ring of 2
No switch and no fallback: a launch the route refuses raises. Its four
entry functions keep the JAX names and arguments, minus the TPU-only
channel padding to 128 lanes and its lane packing:

  run         the wrapper's layout work in PyTorch (b_full split into its
              2 x 2 phase planes, the output interleaved back), around the
              kernel in the phase layout: wrapper cost included
  run_padded  the phase-layout kernel alone on operands built beforehand:
              wrapper cost excluded
  run_fold    the natural-layout kernel: no wrapper layout work. On the
              tensor-core route its paste reads b_full through a tensor map
              with element stride 2 (every second row, one column phase)
  run_auto    on the TPU, `run` with Mosaic's automatic double-buffered
              block pipeline in place of manual DMAs. Here: `run` with every
              GEMM's TMA ring at depth 1 (each tile loaded, waited for and
              multiplied before the next load), so that auto - full is what
              the forward's ring (4 stages in bf16, 2 in float32) buys

On a CUDA tensor each launches the kernel or raises, and counts its
launches in `.launches` (`attention_v2_ablate.tc_launches` and
`.tf32_launches` count those on the bf16 and the float32 route); on a CPU
tensor it runs the plain PyTorch version of the mode (`ablate_reference`).
`main` also times the v1 kernel (`attention_scores_paste`, patch tensors
built beforehand) against `full`.

Run on the card:  python -m healthivert_tpu_torch.experiments.attn_ablate [batch]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.attention_cuda import (
    _check,
    _tc_call,
    attention_scores_paste,
    check_aligned,
    load_library,
    pad_channels,
    tc_geometry,
    v1_fold,
    v1_patches,
)
from ..ops.contextual_attention import _fold_overlap_add, extract_patches, fuse_scores
from ..utils.device import resolve_device

MODES = ("full", "no_score", "no_fuse", "no_softmax", "no_paste",
         "paste_bf16", "fold_norm", "floor")
LAYOUTS = ("natural", "phases")
# each stage's cost is full's time minus that of the mode without it
STAGE_MODES = {"score": "no_score", "fuse": "no_fuse", "softmax": "no_softmax",
               "paste": "no_paste"}
# TMA ring depths: the forward's on each route, and run_auto's
RINGS, RING_SYNC = {torch.bfloat16: 4, torch.float32: 2}, 1
# main's setting, the JAX main's: a 32 x 32 grid of 64 channels in bf16,
# seed 0, and timing windows of 10 calls
GRID, CHANNELS, DTYPE, SEED, REPS = 32, 64, torch.bfloat16, 0, 10
# kernel vs plain version of one mode (`ablate_within`): the forward's y
# tolerance (float32 atol 3e-4, the same float32 sums in another order; bf16
# 1e-3 + 1.6e-2 |y|, two bf16 ulps, since both round float32 values to bf16)
# plus ABLATE_REL of the largest output (no_softmax pastes unnormalised
# scores and reaches hundreds); paste_bf16 adds two bf16 rounding straddles
# of the largest probability times the largest raw value, / 4 (equal float32
# probabilities may round to neighbouring bf16 values); no_paste and floor
# exactly zero.
Y_TOL = {torch.float32: (3e-4, 0.0), torch.bfloat16: (1e-3, 1.6e-2)}
ABLATE_REL = 1e-5


def to_phases(x, hd: int, wd: int):
    """(B, 2hd, 2wd, C) -> its 2 x 2 phase planes (B, 2, 2, hd, wd, C),
    [b, r, t, i, j] = x[b, 2i + r, 2j + t]; a copy."""
    bs, c = x.shape[0], x.shape[-1]
    return x.reshape(bs, hd, 2, wd, 2, c).permute(0, 2, 4, 1, 3, 5).contiguous()


def from_phases(x):
    """Inverse of `to_phases`: the phases interleaved back; a copy."""
    bs, _, _, hd, wd, c = x.shape
    return x.permute(0, 3, 1, 4, 2, 5).reshape(bs, 2 * hd, 2 * wd, c)


def ablate_reference(fd, bd, b_full, mm, hd: int, wd: int, scale: float = 10.0,
                     mode: str = "full"):
    """Plain PyTorch version of one mode, read off the JAX `_kernel`
    (experiments/attn_ablate.py:52-243), in float32, natural layout.
    Returns y (B, 2hd, 2wd, C) in fd's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if mode in ("no_paste", "floor"):
        return torch.zeros_like(b_full, dtype=fd.dtype)
    bs, _, _, c = fd.shape
    num_l = hd * wd
    f32 = torch.float32
    if mode == "no_score":
        s = torch.full((bs, num_l, num_l), 0.5, dtype=f32, device=fd.device)
    else:
        fpat = extract_patches(fd.to(f32), 3, 1).reshape(bs, num_l, -1)
        wpat = extract_patches(bd.to(f32), 3, 1).reshape(bs, num_l, -1)
        nrm = torch.sqrt(torch.sum(wpat * wpat, dim=-1, keepdim=True))
        s = torch.einsum("blk,bpk->blp", wpat, fpat) / torch.clamp(nrm, min=1e-4)
    fused = s if mode == "no_fuse" else fuse_scores(s, wd)
    g = mm.to(f32)[:, :, None]
    inv = None
    if mode == "no_softmax":
        probs = fused
    else:
        logits = fused * g * scale
        e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        col_sum = e.sum(dim=1, keepdim=True)  # (B, 1, P)
        if mode == "fold_norm":
            probs, inv = e * g, 1.0 / col_sum
        else:
            probs = e / col_sum * g
    raw = extract_patches(b_full.to(f32), 4, 2).reshape(bs, num_l, -1)
    if mode == "paste_bf16":
        probs = probs.to(torch.bfloat16).to(f32)
        raw = raw.to(torch.bfloat16).to(f32)
    if inv is not None:  # 1/sum belongs to the probs column p, not to the output
        probs = probs * inv
    vals = torch.einsum("blp,blk->bpk", probs, raw).reshape(bs, hd, wd, 4, 4, c)
    return _fold_overlap_add(vals, 2 * hd, 2 * wd, 2, 4).to(fd.dtype)


def ablate_layout_reference(fd, bd, b_in, mm, hd: int, wd: int, scale: float = 10.0,
                            mode: str = "full", layout: str = "natural"):
    """`ablate_reference` with b_in and the result in `layout`."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    if layout == "natural":
        return ablate_reference(fd, bd, b_in, mm, hd, wd, scale, mode)
    y = ablate_reference(fd, bd, from_phases(b_in), mm, hd, wd, scale, mode)
    return to_phases(y, hd, wd)


def _check_ablate(fd, bd, b_in, mm, hd, wd, mode, layout):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    bs, c = fd.shape[0], fd.shape[-1]
    want = (bs, 2 * hd, 2 * wd, c) if layout == "natural" else (bs, 2, 2, hd, wd, c)
    if tuple(b_in.shape) != want or not b_in.is_contiguous():
        raise ValueError(
            f"attention_v2_ablate: b_in is {tuple(b_in.shape)}, expected contiguous {want} "
            f"for layout {layout!r}"
        )
    _check(fd, bd, b_in.view(bs, 2 * hd, 2 * wd, c), mm, hd, wd)


def attention_v2_ablate(fd, bd, b_in, mm, hd: int, wd: int, scale: float = 10.0,
                        mode: str = "full", layout: str = "natural", ring: int | None = None):
    """One mode of the forward in one layout: the kernel on a CUDA tensor
    (uncounted; the entry functions below count), the plain version on a
    CPU tensor. b_in is b_full (natural) or its phase planes (phases); the
    result has b_in's shape and fd's dtype. ring: the TMA ring depth of
    every GEMM, the forward's (None, or RINGS[dtype]) or RING_SYNC (phase
    layout only)."""
    if fd.device.type == "cpu":
        return ablate_layout_reference(fd, bd, b_in, mm, hd, wd, scale, mode, layout)
    if fd.device.type != "cuda":
        raise ValueError(f"attention_v2_ablate: no kernel for device {fd.device}")
    _check_ablate(fd, bd, b_in, mm, hd, wd, mode, layout)
    ring = RINGS[fd.dtype] if ring is None else ring
    if ring not in (RINGS[fd.dtype], RING_SYNC):
        raise ValueError(f"attention_v2_ablate: ring {ring} is not {RINGS[fd.dtype]} or "
                         f"{RING_SYNC} for {fd.dtype}")
    return _ablate_kernel(fd, bd, b_in, mm, hd, wd, scale, mode, layout, ring)


attention_v2_ablate.tc_launches = 0  # launches on the bf16 tensor-core route
attention_v2_ablate.tf32_launches = 0  # launches on the float32 (3xTF32) route


def _scratch(shape, dtype, device, used):
    """Scratch only for the stages the mode launches (floor fills y alone,
    no_score fills s in place of the norm and score stages): None else."""
    return torch.empty(shape, dtype=dtype, device=device) if used else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ablate_kernel(fd, bd, b_in, mm, hd, wd, scale, mode, layout, ring):
    """attention_v2_ablate on the route of fd's dtype: bf16
    (csrc/attention_tc_ablate.cu; the paste's operand probsT in hi and lo
    bf16 planes, hi alone for paste_bf16) or float32
    (csrc/attention_tf32_ablate.cu; probsT in big and small float32 planes,
    big alone for paste_bf16, and fd's and bd's big and small halves (4, B,
    hd, wd, Cp); fd and bd go to split_kernel: `check_aligned`). No float32
    probs."""
    lib, _ = load_library()
    bs, c = fd.shape[0], fd.shape[-1]
    cp = -(-c // 64) * 64
    wdp, kp = tc_geometry(hd, wd)
    num_l = hd * wd
    dev = fd.device
    f32 = fd.dtype == torch.float32
    pt_dtype = torch.float32 if f32 else torch.bfloat16
    fd_p, bd_p = pad_channels(fd, cp), pad_channels(bd, cp)
    if layout == "natural":
        b_op = pad_channels(b_in, cp)
    else:
        b_op = pad_channels(b_in.view(bs, 4, hd, wd, c), cp)
    scores = mode not in ("floor", "no_score")
    y = torch.empty_like(b_in)
    s = _scratch((bs, num_l, num_l), torch.float32, dev, mode != "floor")
    nrm_raw = _scratch((bs, num_l), torch.float32, dev, scores)
    pt_hi = _scratch((bs, num_l, kp), pt_dtype, dev, mode != "floor")
    pt_lo = _scratch((bs, num_l, kp), pt_dtype, dev, mode not in ("floor", "paste_bf16"))
    col_inv = _scratch((bs, num_l), torch.float32, dev, mode == "fold_norm")
    if f32:
        if scores:
            check_aligned("attention_v2_ablate", fd=fd_p, bd=bd_p)
        maps = [_ptr(_scratch((4, bs, hd, wd, cp), torch.float32, dev, scores))]
        fn, name = lib.hv_attention_tf32_ablate, "attention_v2_ablate (3xTF32)"
    else:
        maps = []
        fn, name = lib.hv_attention_tc_ablate, "attention_v2_ablate (tensor cores)"
    with torch.cuda.device(dev):
        rc = fn(
            fd_p.data_ptr(), bd_p.data_ptr(), b_op.data_ptr(), mm.data_ptr(), y.data_ptr(),
            _ptr(s), _ptr(nrm_raw), *maps, _ptr(pt_hi), _ptr(pt_lo), _ptr(col_inv),
            bs, hd, wd, c, cp, wdp, kp, float(scale), MODES.index(mode),
            LAYOUTS.index(layout), ring, torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call(name, rc)
    if f32:
        attention_v2_ablate.tf32_launches += 1
    else:
        attention_v2_ablate.tc_launches += 1
    return y


def run(fd, bd, b_full, mm, hd: int, wd: int, scale: float = 10.0, mode: str = "full"):
    """JAX `run` (experiments/attn_ablate.py:247): b_full split into its
    phase planes and the output interleaved, in PyTorch, around the
    phase-layout kernel. Returns y (B, 2hd, 2wd, C)."""
    out = attention_v2_ablate(fd, bd, to_phases(b_full, hd, wd), mm, hd, wd, scale, mode,
                              "phases")
    if out.is_cuda:
        run.launches += 1
    return from_phases(out)


def run_padded(fd, bd, bph, mm, hd: int, wd: int, scale: float = 10.0, mode: str = "full"):
    """JAX `run_padded` (:289): the phase-layout kernel alone on phase
    planes bph (B, 2, 2, hd, wd, C) built beforehand, at the real C.
    Returns the output phase planes (B, 2, 2, hd, wd, C)."""
    out = attention_v2_ablate(fd, bd, bph, mm, hd, wd, scale, mode, "phases")
    if out.is_cuda:
        run_padded.launches += 1
    return out


def run_auto(fd, bd, b_full, mm, hd: int, wd: int, scale: float = 10.0, mode: str = "full"):
    """JAX `run_auto` (:466): `run`'s function with each GEMM's TMA ring at
    depth 1, on either route. Returns y (B, 2hd, 2wd, C)."""
    out = attention_v2_ablate(fd, bd, to_phases(b_full, hd, wd), mm, hd, wd, scale, mode,
                              "phases", RING_SYNC)
    if out.is_cuda:
        run_auto.launches += 1
    return from_phases(out)


def run_fold(fd, bd, b_full, mm, hd: int, wd: int, scale: float = 10.0, mode: str = "full"):
    """JAX `run_fold` (:657): the natural-layout kernel, the phase split and
    interleave done by its own indexing. Returns y (B, 2hd, 2wd, C)."""
    out = attention_v2_ablate(fd, bd, b_full, mm, hd, wd, scale, mode, "natural")
    if out.is_cuda:
        run_fold.launches += 1
    return out


# kernel launches in this process, counted above
run.launches = run_padded.launches = run_auto.launches = run_fold.launches = 0


def best_ms(fn, device, reps=None):
    """The least mean time per call of `fn` over three windows of `reps`
    calls (REPS by default), after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    reps = REPS if reps is None else reps
    fn()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) / reps * 1e3
        best = min(best, ms)
    return best


def ablate_within(got, want, mode: str, pmax: float, rmax: float):
    """A mode's kernel output `got` against its plain version `want`, within
    the tolerance stated at ABLATE_REL; pmax is the largest probability of
    the inputs' full forward and rmax their largest |b_full|. Returns (ok,
    max abs error)."""
    atol, rtol = Y_TOL[got.dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if mode in ("no_paste", "floor"):
        return bool((got == 0).all() and (want == 0).all()), float(err.max())
    atol += ABLATE_REL * float(want.abs().max())
    if mode == "paste_bf16":
        atol += 2 * 2.0**-7 * pmax * rmax / 4
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def rel_err(y, y0):
    """max |y - y0| / max |y0|, in float32."""
    y, y0 = y.float(), y0.float()
    return float((y - y0).abs().max()) / max(float(y0.abs().max()), 1e-6)


def make_inputs(bs: int, hd: int, wd: int, c: int, dtype, device, seed: int = 0):
    """The JAX main's inputs: standard normal fd, bd and b_full, a gate that
    keeps each patch with probability 0.7; from numpy with a seed."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    fd = t(rng.standard_normal((bs, hd, wd, c), dtype=np.float32))
    bd = t(rng.standard_normal((bs, hd, wd, c), dtype=np.float32))
    bf = t(rng.standard_normal((bs, 2 * hd, 2 * wd, c), dtype=np.float32))
    mm = torch.from_numpy((rng.random((bs, hd * wd)) > 0.3).astype(np.float32)).to(device)
    return fd, bd, bf, mm


def main(argv=None) -> dict:
    """Times every mode through `run`, then `run_padded`, `run_auto` and
    `run_fold` in full and floor, and the v1 kernel; prints the JAX main's
    lines and one JSON line, and returns its contents."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bs, hd, wd, c = args.batch, GRID, GRID, CHANNELS
    fd, bd, bf, mm = make_inputs(bs, hd, wd, c, DTYPE, dev, SEED)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "batch": bs, "grid": [hd, wd], "channels": c, "dtype": str(DTYPE).split(".")[-1],
           "reps": REPS, "ms": {}, "rel_err_vs_full": {}}
    ms, errs = out["ms"], out["rel_err_vs_full"]

    with torch.no_grad():
        for mode in MODES:
            ms[mode] = best_ms(lambda: run(fd, bd, bf, mm, hd, wd, mode=mode), dev)
            saves = f"  (saves {ms['full'] - ms[mode]:6.3f} ms)" if mode != "full" else ""
            print(f"{mode:12s} {ms[mode]:7.3f} ms{saves}", flush=True)
        out["stage_ms"] = {st: ms["full"] - ms[m] for st, m in STAGE_MODES.items()}
        print("stage split (full minus the mode without it): " + ", ".join(
            f"{st} {v:.3f} ms" for st, v in out["stage_ms"].items()), flush=True)

        bph = to_phases(bf, hd, wd)
        for mode in ("full", "floor"):
            ms[f"padded-{mode}"] = best_ms(
                lambda: run_padded(fd, bd, bph, mm, hd, wd, mode=mode), dev)
            print(f"padded-{mode:7s} {ms[f'padded-{mode}']:7.3f} ms  (wrapper excluded)",
                  flush=True)

        for mode in ("full", "floor"):
            ms[f"auto-{mode}"] = best_ms(
                lambda: run_auto(fd, bd, bf, mm, hd, wd, mode=mode), dev)
            print(f"auto-{mode:7s} {ms[f'auto-{mode}']:7.3f} ms  (TMA ring depth 1)",
                  flush=True)
        y0 = run(fd, bd, bf, mm, hd, wd, mode="full")
        errs["auto-full"] = rel_err(run_auto(fd, bd, bf, mm, hd, wd, mode="full"), y0)
        print(f"auto-full: rel max err vs full = {errs['auto-full']:.4g}", flush=True)

        for mode in ("paste_bf16", "fold_norm"):
            errs[mode] = rel_err(run(fd, bd, bf, mm, hd, wd, mode=mode), y0)
            print(f"{mode}: rel max err vs full = {errs[mode]:.4g}", flush=True)

        for mode in ("full", "floor"):
            ms[f"fold-{mode}"] = best_ms(
                lambda: run_fold(fd, bd, bf, mm, hd, wd, mode=mode), dev)
            print(f"fold-{mode:7s} {ms[f'fold-{mode}']:7.3f} ms  (natural layout)",
                  flush=True)
        errs["fold-full"] = rel_err(run_fold(fd, bd, bf, mm, hd, wd, mode="full"), y0)
        print(f"fold-full: rel max err vs full = {errs['fold-full']:.4g}", flush=True)

        # v1: the same forward on patch tensors built beforehand, then folded
        patches = v1_patches(fd, bd, bf)
        ms["v1"] = best_ms(lambda: attention_scores_paste(*patches, mm, hd, wd), dev)
        print(f"v1           {ms['v1']:7.2f} ms  (patches built beforehand, no fold)",
              flush=True)
        ms["v1-route"] = best_ms(
            lambda: v1_fold(attention_scores_paste(*v1_patches(fd, bd, bf), mm, hd, wd),
                            hd, wd), dev)
        print(f"v1-route     {ms['v1-route']:7.2f} ms  (patch building + v1 + fold)",
              flush=True)
        errs["v1"] = rel_err(v1_fold(attention_scores_paste(*patches, mm, hd, wd), hd, wd), y0)
        print(f"v1: rel max err vs full = {errs['v1']:.4g}", flush=True)

    print(json.dumps({"ablation": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
