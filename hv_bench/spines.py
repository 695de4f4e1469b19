"""Synthetic straightened spines, the benchmark's traffic for the 3D
synthesis: the shapes of the straightening pipeline's output (256 x 256 x 64,
vertebra ids stacked along the rows), drawn on the device from a seed.

The same geometry as the system's own synthetic fixture (an elliptic
cylinder a vertebra, an anterior wedge for a fractured one, a trabecular
texture, soft-tissue noise, a CAM on the fractured body), drawn with torch
in a few large calls instead of numpy, so that a run's patients are made in
well under a second.
"""

from __future__ import annotations

import numpy as np
import torch


def spine(gen: torch.Generator, shape, vert_ids, vert_height, gap, fractured, device):
    """One spine: (ct float32 in [0, 255], labels int16, cam float32 in
    [0, 1]) on `device`. fractured: {vertebra id: height fraction}."""
    h, w, z = shape
    rr = torch.arange(h, device=device, dtype=torch.float32).reshape(h, 1, 1)
    cc = torch.arange(w, device=device, dtype=torch.float32).reshape(1, w, 1)
    zz = torch.arange(z, device=device, dtype=torch.float32).reshape(1, 1, z)
    noise = torch.randn((2,) + tuple(shape), generator=gen, device=device)
    ct = 30.0 + 8.0 * noise[0]
    labels = torch.zeros(shape, dtype=torch.int16, device=device)
    cam = torch.zeros(shape, dtype=torch.float32, device=device)
    pitch = vert_height + gap
    start = (h - len(vert_ids) * pitch + gap) // 2
    in_cols = (cc - w * 0.5).abs() <= w * 0.18
    in_z = (zz - z * 0.5).abs() <= z * 0.42
    texture = 160.0 + 25.0 * torch.sin(rr / 3.0)
    for i, vid in enumerate(vert_ids):
        c_row = start + i * pitch + vert_height // 2
        frac = fractured.get(vid, 1.0)
        eff_h = vert_height * (frac + (1 - frac) * cc / w) / 2.0
        body = ((rr - c_row).abs() <= eff_h) & in_cols & in_z
        labels = torch.where(body, torch.tensor(vid, dtype=torch.int16, device=device), labels)
        ct = torch.where(body, texture, ct)
        if frac < 1.0:
            cam = torch.where(body, min(1.0, (1 - frac) * 1.5), cam)
    ct = torch.clamp(ct + 4.0 * noise[1], 0.0, 255.0)
    return ct, labels, cam


def patients(seed: int, count: int, traffic: dict, device) -> list:
    """`count` patients drawn from `seed`: each a list of (ct, labels,
    vertebra id, cam) volumes on the host, one a target vertebra of
    traffic["vert_ids"], all of one spine with one fractured vertebra whose
    height fraction is uniform in traffic["fracture"]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = np.random.default_rng(seed)
    ids = tuple(traffic["vert_ids"])
    lo, hi = traffic["fracture"]
    out = []
    for _ in range(count):
        frac = {int(draw.choice(ids)): float(draw.uniform(lo, hi))}
        ct, labels, cam = spine(gen, tuple(traffic["shape"]), ids, traffic["vert_height"],
                                traffic["gap"], frac, device)
        ct, labels, cam = ct.cpu().numpy(), labels.cpu().numpy(), cam.cpu().numpy()
        out.append([(ct, labels, vid, cam) for vid in ids])
    return out


def seed_stream(seed: int, salt: int) -> int:
    """A second seed derived from `seed`, for draws that must not repeat the
    traffic's (the warm-up patients, the comparison's sample)."""
    return (seed * 1_000_003 + salt) % (2 ** 63 - 1)

