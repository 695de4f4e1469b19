"""Port vs JAX package on the CPU: the three-pass 3D synthesis.

`synthesize_volume` at ngf=4 on a (64, 64, 16) synthetic spine, as in
tests/test_engine.py, with the same seeded random weights on both sides
and use_bf16=False.

Tolerance. The synthesis turns float outputs into discrete ones: the predicted
height goes through ceil(), the seg through > 0.5, the CT through uint8
rounding, and each pass feeds the next. Float32 differences of ~1e-7 can
flip one of these where a value sits on the edge, so: |delta CT| <= 1 grey
level everywhere, and labels agree on >= 99.9 % of voxels (seen: both
volumes equal).
"""

import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import make_spine_volume as jax_make_spine_volume
from healthivert_tpu.engine.infer3d import synthesize_volume as jax_synthesize_volume
from healthivert_tpu.models.pix2pix import Pix2PixConfig as JaxConfig
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig
from healthivert_tpu_torch.utils.weights import flax_to_state_dict
from torch_port_fixtures import random_generator_vars


def _spine(seed=0):
    return make_spine_volume(
        np.random.default_rng(seed), shape=(64, 64, 16), vert_ids=(19, 20, 21),
        vert_height=12, gap=5, fractured={20: 0.6},
    )


@pytest.fixture(scope="module")
def weights():
    return random_generator_vars(4)


def _port_gen(v, dtype=None):
    gen = Generator(cnum=4, dtype=dtype)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    return gen.eval()


def test_synthetic_volume_is_a_copy():
    for a, b in zip(_spine(), jax_make_spine_volume(
            np.random.default_rng(0), shape=(64, 64, 16), vert_ids=(19, 20, 21),
            vert_height=12, gap=5, fractured={20: 0.6})):
        np.testing.assert_array_equal(a, b)


def test_synthesize_volume_matches_jax(weights):
    ct, labels, cam = _spine()
    want_ct, want_lb = jax_synthesize_volume(
        weights["params"], weights["sn"], JaxConfig(ngf=4, image_size=64),
        ct, labels, 20, cam, batch_size=8, use_bf16=False,
    )
    before = infer3d._forward.dispatches
    got_ct, got_lb = infer3d.synthesize_volume(
        _port_gen(weights), Pix2PixConfig(ngf=4, image_size=64),
        ct, labels, 20, cam, batch_size=8, use_bf16=False, device="cpu",
    )
    assert infer3d._forward.dispatches > before
    assert got_ct.shape == ct.shape and got_lb.shape == labels.shape
    assert np.abs(got_ct - want_ct).max() <= 1.0
    assert np.mean(got_lb == want_lb) >= 0.999
    zs = np.nonzero((labels == 20).any(axis=(0, 1)))[0]
    z_mid = (zs.min() + zs.max()) // 2
    assert got_ct[:, :, z_mid].max() > 0 and got_ct[:, :, 0].max() == 0


def test_band_inputs_match_jax(rng):
    from healthivert_tpu.engine.infer3d import _band_inputs as jax_band_inputs

    ct = rng.integers(0, 256, (3, 64, 8)).astype(np.uint8)
    cam = rng.integers(0, 256, (3, 64, 8)).astype(np.uint8)
    x1, x2 = np.array([5, 30, 44]), np.array([17, 42, 60])
    min_x, max_x = np.array([0, 16, 24]), np.array([40, 56, 64])
    got = infer3d._band_inputs(*map(torch.from_numpy, (ct, cam, x1, x2, min_x, max_x)))
    for i in range(3):
        want = jax_band_inputs(ct[i], cam[i], x1[i], x2[i], min_x[i], max_x[i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_cam_bucket_and_window_match_jax():
    from healthivert_tpu.engine import infer3d as jinfer

    for n in (1, 16, 17, 64, 65, 200):
        assert infer3d._cam_bucket(n) == jinfer._cam_bucket(n)
    assert (infer3d.WINDOW, infer3d.MAXHEIGHT) == (jinfer.WINDOW, jinfer.MAXHEIGHT)


def test_unported_options_raise(weights):
    ct, labels, cam = _spine()
    gen, cfg = _port_gen(weights), Pix2PixConfig(ngf=4, image_size=64)
    vols = [(ct, labels, 20, cam)]
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is parallel.mesh's
        infer3d.synthesize_volumes(gen, cfg, vols, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        infer3d.synthesize_volumes(gen, cfg, vols, quant="auto", device="cpu")
    with pytest.raises(ValueError, match="use_bf16"):
        infer3d.synthesize_volumes(gen, cfg, vols, use_bf16=True, device="cpu")


def test_entry_point_refuses_missing_cuda(weights, monkeypatch):
    ct, labels, cam = _spine()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer3d.synthesize_volume(_port_gen(weights), Pix2PixConfig(ngf=4, image_size=64),
                                  ct, labels, 20, cam, use_bf16=False)


# --- The slice-major host state against the per-slice one it replaced -------
#
# A deterministic stand-in replaces the generator forward, so that both
# versions receive the same outputs for the same job and only their host
# state differs. The oracle is the per-slice algorithm as it stood before the
# host state went slice-major: float64 slice copies in dicts, the cleanup on the
# whole slice, fresh zeroed slices per paste-back, volumes filled slice by
# slice. It is frozen here, apart from the package.

H, W, Z = 128, 40, 10


def _stand_in(ct, cam, x1, x2, min_x, max_x, rat, row):
    """Generator stand-in, per sample from the job's inputs: full-slice
    (B, H, W) uint8 CT and 0/1 seg, (B,) float32 heights (already times
    MAXHEIGHT). The seg fills the mask band but every fifth column; the
    height exceeds the band's by up to 6.2 rows away from the top edge."""
    col = lambda v: v.reshape(-1, 1, 1)
    r = torch.arange(ct.shape[1]).reshape(1, -1, 1)
    c = torch.arange(ct.shape[2]).reshape(1, 1, -1)
    fake = ((ct.long() * 3 + cam.long() * 5 + col(x1) + 7 * col(x2) + col(row)) % 256)
    seg = (r >= col(min_x) + 3) & (r < col(max_x) - 3) & ((ct.long() + c) % 5 != 0)
    ph = (x2 - x1).float() + (x1 > 4).float() * (row % 5).float() * 1.3 + rat
    return fake.to(torch.uint8), seg.to(torch.uint8), ph


def _stand_in_forward(gen, ct, cam_stack, zidx, x1, x2, min_x, max_x, rat, w0,
                      scales=None, use_bf16=True, win=infer3d.WINDOW):
    """infer3d._forward's contract on the stand-in: outputs cropped to the
    `win` rows from w0, as (B, win, W, 1)."""
    fake, seg, ph = _stand_in(ct, cam_stack[zidx], x1, x2, min_x, max_x, rat, zidx)
    win = min(win, ct.shape[1])
    rows = (w0.reshape(-1, 1) + torch.arange(win))[:, :, None].expand(-1, -1, ct.shape[2])
    crop = lambda img: torch.gather(img, 1, rows)[..., None]
    return crop(fake), crop(seg), ph


def _oracle_geometry(label_sl, ct_sl, vert_id):
    from healthivert_tpu_torch.data.sampler import remove_small_cc

    vert = remove_small_cc((label_sl == vert_id).astype(np.float64), 50)
    coords = np.argwhere(vert)
    if coords.size == 0:
        return None
    rows = coords[:, 0]
    x1, x2 = int(rows.min()), int(rows.max())
    width = label_sl.shape[0]
    height = x2 - x1
    if height > 40:
        x_mean = int(rows.mean())
        x1 = x_mean - 20
        x2 = x1 + 40
    mask_x = (x1 + x2) // 2
    if mask_x <= 20:
        min_x = 0
    elif width - mask_x <= 20:
        min_x = width - 40
    else:
        min_x = mask_x - 20
    return dict(x1=x1, x2=x2, height=height, min_x=min_x, max_x=min_x + 40,
                ct_u8=ct_sl.astype(np.uint8))


def _oracle_reassemble(geo, x_stage2, fine_seg, pred_h, ct_sl, label_sl, vert_id):
    x1, x2, height = geo["x1"], geo["x2"], geo["height"]
    h = ct_sl.shape[0]
    ph = int(np.ceil(pred_h))
    if ph < height:
        ph = height
    hd = ph - height
    x_upper = x1 - hd // 2
    x_bottom = x_upper + ph
    fake = np.zeros_like(ct_sl, np.float64)
    if x_bottom > x_upper >= 0:
        fake[x_upper:x_bottom] = x_stage2[x_upper:x_bottom]
    ori = geo["ct_u8"].astype(np.float64)
    fake[:x_upper] = ((ori[hd // 2 : x1] / 255.0 * 2 - 1) + 1) * 127.5
    tail = ori[x2 : x2 + h - x_bottom]
    fake[x_bottom : x_bottom + tail.shape[0]] = tail
    seg = np.zeros_like(label_sl, np.float64)
    if x_bottom > x_upper >= 0:
        seg[x_upper:x_bottom] = fine_seg[x_upper:x_bottom] * vert_id
    seg[:x_upper] = label_sl[hd // 2 : x1]
    stail = label_sl[x2 : x2 + h - x_bottom]
    seg[x_bottom : x_bottom + stail.shape[0]] = stail
    return fake, seg


def _oracle_synthesize(volumes, axis):
    """The per-slice synthesis on the stand-in, one job at a time."""
    get = lambda vol, z: vol[:, :, z] if axis == 2 else vol[:, z, :]
    preps, cams, row_off = [], {}, 0
    for ct_vol, label_vol, vert_id, cam_vol in volumes:
        cam_vol = cam_vol if cam_vol is not None else np.zeros_like(ct_vol, np.float32)
        zs = np.nonzero((label_vol == vert_id).any(axis=(0, 1) if axis == 2 else (0, 2)))[0]
        if zs.size == 0:
            preps.append(None)
            continue
        z0, z1 = int(zs.min()), int(zs.max())
        range_length = z1 - z0 + 1
        new_len = int(range_length * 4 / 5)
        nz0 = z0 + (range_length - new_len) // 2
        nz1 = nz0 + new_len - 1
        center = (nz0 + nz1) // 2
        z_list = list(range(nz0, nz1 + 1))
        prep = dict(vert_id=vert_id, label_vol=label_vol, z_list=z_list,
                    ratios={z: abs(z - center) / range_length * 2 for z in z_list},
                    ct={z: get(ct_vol, z).astype(np.float64) for z in z_list},
                    lb={z: get(label_vol, z).astype(np.float64) for z in z_list},
                    row={z: row_off + i for i, z in enumerate(z_list)})
        for z in z_list:
            cams[prep["row"][z]] = (get(cam_vol, z) * 255).astype(np.uint8)
        preps.append(prep)
        row_off += len(z_list)
    for which, nb in (("upper", -1), ("lower", +1), ("target", 0)):
        jobs = []
        for prep in preps:
            if prep is None:
                continue
            vert_id, vid = prep["vert_id"], prep["vert_id"] + nb
            for z in prep["z_list"]:
                original = np.sum(get(prep["label_vol"], z) == vid)
                if which == "upper" and not (vert_id > 8 and original > 200):
                    continue
                if which == "lower" and not (vert_id < 24 and original > 200):
                    continue
                geo = _oracle_geometry(prep["lb"][z], prep["ct"][z], vid)
                if geo is not None:
                    jobs.append((geo, prep, z, vid))
        outs = []
        for geo, prep, z, vid in jobs:
            t = lambda v, dt=torch.int64: torch.tensor([v], dtype=dt)
            row = prep["row"][z]
            fake, seg, ph = _stand_in(
                torch.from_numpy(geo["ct_u8"][None]), torch.from_numpy(cams[row][None]),
                t(geo["x1"]), t(geo["x2"]), t(geo["min_x"]), t(geo["max_x"]),
                t(prep["ratios"][z], torch.float32), t(row))
            outs.append((fake[0].numpy(), seg[0].numpy(), float(ph[0])))
        for (geo, prep, z, vid), (fake, seg, ph) in zip(jobs, outs):
            prep["ct"][z], prep["lb"][z] = _oracle_reassemble(
                geo, fake, seg, ph, prep["ct"][z], prep["lb"][z], vid)
    results = []
    for (ct_vol, *_), prep in zip(volumes, preps):
        ct_fake = np.zeros_like(ct_vol, np.float64)
        lb_fake = np.zeros_like(ct_vol, np.float64)
        if prep is not None:
            for z in prep["z_list"]:
                sl = (slice(None), slice(None), z) if axis == 2 else (slice(None), z)
                ct_fake[sl] = prep["ct"][z]
                lb_fake[sl] = prep["lb"][z]
        results.append((ct_fake, lb_fake))
    return results


def _spine_hwz(rng, bodies, extra=()):
    """(ct float32, labels int16, cam float32) of shape (H, W, Z): each body
    (id, first row, rows) spans columns 6-33 and z 1-8; extra: (id, rows,
    cols, zs) blobs painted afterwards."""
    ct = rng.uniform(0, 255, (H, W, Z)).astype(np.float32)
    labels = np.zeros((H, W, Z), np.int16)
    for vid, top, rows in bodies:
        labels[top : top + rows, 6:34, 1:9] = vid
    for vid, rows, cols, zs in extra:
        labels[rows, cols, zs] = vid
    cam = rng.uniform(0, 1, (H, W, Z)).astype(np.float32)
    return ct, labels, cam


SPINE = ((19, 8, 22), (20, 40, 30), (21, 80, 24))


def _case(name, rng):
    """(volumes, axis, a check of the geometries synthesize_volumes computed)."""
    spine = lambda bodies=SPINE, extra=(): _spine_hwz(rng, bodies, extra)
    if name in ("sagittal", "coronal"):
        ct, lb, cam = spine()
        if name == "coronal":  # (H, Z, W): slices along axis 1
            ct, lb, cam = (np.ascontiguousarray(np.moveaxis(a, 2, 1)) for a in (ct, lb, cam))
        vols = [(ct, lb, vid, cam) for vid in (19, 20, 21)]  # one patient's arrays
        return vols, 2 if name == "sagittal" else 1, lambda geos: len(geos) > 0
    if name == "tall":  # the rows.mean() branch
        ct, lb, cam = spine(((19, 6, 20), (20, 30, 50), (21, 86, 24)))
        return [(ct, lb, 20, cam)], 2, lambda geos: any(g["height"] > 40 for g in geos)
    if name == "edges":  # bands clamped at the top and the bottom of the slice
        top = spine(((20, 0, 22), (21, 30, 26)))
        bottom = spine(((19, 70, 26), (20, 104, 24)))
        return ([(*top[:2], 20, top[2]), (*bottom[:2], 20, None)], 2,
                lambda geos: {0, H - 40} <= {g["min_x"] for g in geos})
    if name == "stray":  # a 12-px component (dropped), a 60-px one at the edge (kept)
        ct, lb, cam = spine(extra=((20, slice(110, 113), slice(2, 6), 3),
                                   (20, slice(112, 118), slice(0, 10), 5),
                                   (19, slice(0, 2), slice(36, 40), 4)))
        return [(ct, lb, 20, cam)], 2, lambda geos: any(g["height"] > 40 for g in geos)
    if name == "missing_neighbours":
        # no 19 and a 21 under 200 px; ids 8 and 24 skip a pass
        a = spine(((20, 40, 30), (21, 80, 6)))
        b = spine(((7, 8, 22), (8, 40, 30), (9, 80, 24)))
        c = spine(((23, 8, 22), (24, 40, 30), (25, 80, 24)))
        return [(*a[:2], 20, a[2]), (*b[:2], 8, b[2]), (*c[:2], 24, c[2])], 2, \
            lambda geos: len(geos) > 0
    if name == "absent":  # one target absent from its volume
        ct, lb, cam = spine()
        return [(ct, lb, 20, cam), (ct, lb, 22, cam)], 2, lambda geos: len(geos) > 0
    if name == "none_present":
        ct, lb, cam = spine()
        return [(ct, lb, 23, cam), (ct, lb, 24, None)], 2, lambda geos: not geos
    if name == "cli_like":  # float64, Fortran-ordered volumes, as the NIfTI reader gives
        ct, lb, cam = spine()
        f = lambda a: np.asfortranarray(a, np.float64)
        return [(f(ct), f(lb), 20, cam), (f(ct), f(lb), 21, cam)], 2, lambda geos: len(geos) > 0
    raise KeyError(name)


@pytest.mark.parametrize("name", ["sagittal", "coronal", "tall", "edges", "stray",
                                  "missing_neighbours", "absent", "none_present",
                                  "cli_like"])
def test_slice_major_synthesis_matches_per_slice_oracle(name, monkeypatch):
    vols, axis, check = _case(name, np.random.default_rng(7))
    before = [tuple(a.copy() if a is not None else None for a in (v[0], v[1], v[3]))
              for v in vols]
    geos = []

    def recording(*args):
        geo = slice_geometry(*args)
        geos.extend([geo] if geo is not None else [])
        return geo

    slice_geometry = infer3d._slice_geometry
    monkeypatch.setattr(infer3d, "_slice_geometry", recording)
    monkeypatch.setattr(infer3d, "_forward", _stand_in_forward)
    got = infer3d.synthesize_volumes(Generator(cnum=4).eval(), Pix2PixConfig(ngf=4, image_size=H),
                                     vols, batch_size=8, use_bf16=False, axis=axis,
                                     device="cpu")
    want = _oracle_synthesize(vols, axis)
    assert check(geos)
    assert len(got) == len(want) == len(vols)
    for g_pair, w_pair in zip(got, want):
        for g, w in zip(g_pair, w_pair):
            assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
            assert (g.flags.c_contiguous, g.flags.f_contiguous) == \
                (w.flags.c_contiguous, w.flags.f_contiguous)
            assert g.tobytes() == w.tobytes()
    outs = [a for pair in got for a in pair]
    ins = [a for v in vols for a in (v[0], v[1], v[3]) if a is not None]
    assert not any(np.shares_memory(a, b) for k, a in enumerate(outs) for b in outs[k + 1:] + ins)
    for v, b in zip(vols, before):  # the inputs are read, never written
        for a, a0 in zip((v[0], v[1], v[3]), b):
            assert a is None or np.array_equal(a, a0)


def _label_slice(rng):
    """A (48, 40) label slice: id 5 as rectangles of 1-60 px (one touching an
    edge of the slice) and speckle, id 6 speckle; at times no 5 at all."""
    sl = np.zeros((48, 40), np.int16)
    if rng.random() < 0.15:
        return sl
    for k in range(int(rng.integers(1, 6))):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 11))
        r = 0 if k == 0 and rng.random() < 0.5 else int(rng.integers(0, 48 - h + 1))
        c = 40 - w if k == 0 and r != 0 else int(rng.integers(0, 40 - w + 1))
        sl[r : r + h, c : c + w] = 5
    sl[rng.random(sl.shape) < 0.02] = 5
    sl[rng.random(sl.shape) < 0.02] = 6
    return sl


@pytest.mark.parametrize("seed", range(6))
def test_cropped_cleanup_matches_whole_slice(seed):
    from healthivert_tpu_torch.data.sampler import remove_small_cc

    rng = np.random.default_rng(seed)
    for _ in range(40):
        sl = _label_slice(rng)
        want = remove_small_cc((sl == 5).astype(np.float64), 50) != 0
        rows, cols = np.nonzero(sl == 5)
        cc0, px0 = infer3d.synthesize_volumes.cc_pixels, infer3d.synthesize_volumes.slice_pixels
        got = infer3d._clean_vertebra(sl, 5)
        cc = infer3d.synthesize_volumes.cc_pixels - cc0
        px = infer3d.synthesize_volumes.slice_pixels - px0
        if rows.size == 0:
            assert got is None and (cc, px) == (0, 0)
            continue
        kept, r0, c0 = got
        full = np.zeros(sl.shape, bool)
        full[r0 : r0 + kept.shape[0], c0 : c0 + kept.shape[1]] = kept
        np.testing.assert_array_equal(full, want)
        box = (np.ptp(rows) + 1) * (np.ptp(cols) + 1)  # the id's bounding box
        assert (cc, px) == (box, sl.size) and kept.shape == (np.ptp(rows) + 1, np.ptp(cols) + 1)


@pytest.mark.parametrize("dtype, vert_id, want", [
    (np.int16, 20, np.int16), (np.uint8, 20, np.uint8), (np.uint8, 255, np.float64),
    (np.uint8, 0, np.float64), (np.float32, 20, np.float32), (np.float64, 20, np.float64),
    (np.bool_, 1, np.float64), (np.int16, 20.5, np.float64),
])
def test_label_stack_dtype_holds_every_written_id(dtype, vert_id, want):
    assert infer3d._label_dtype(np.dtype(dtype), vert_id) == np.dtype(want)


@pytest.mark.parametrize("seed", range(4))
def test_reassemble_in_place_matches_fresh_slices(seed):
    """The paste-back into the stack rows against the fresh zeroed slices of
    the per-slice synthesis, over geometries short and tall, near the edges,
    and heights from none to past the slice: the same values where the
    per-slice one succeeds (zeroed rows included), an error where it fails."""
    rng = np.random.default_rng(seed)
    h, w, pasted, failed = 64, 8, 0, 0
    for _ in range(300):
        height = int(rng.integers(0, 61))
        x1 = int(rng.integers(-20, 12)) if height > 40 else int(rng.integers(0, h - height))
        geo = dict(x1=x1, x2=x1 + min(height, 40), height=height, w0=0)
        ct_row = rng.uniform(0, 255, (h, w))
        lb_row = rng.choice(np.array([0, 19, 20, 21], np.int16), (h, w))
        geo["ct_u8"] = ct_row.astype(np.uint8)
        x_stage2 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        fine_seg = rng.integers(0, 2, (h, w)).astype(np.uint8)
        pred_h = float(rng.uniform(-2, 80))
        try:
            want = _oracle_reassemble(geo, x_stage2, fine_seg, pred_h, ct_row, lb_row, 20)
        except ValueError:
            with pytest.raises(ValueError):
                infer3d._reassemble(geo, x_stage2, fine_seg, pred_h, ct_row, lb_row, 20)
            failed += 1
            continue
        infer3d._reassemble(geo, x_stage2, fine_seg, pred_h, ct_row, lb_row, 20)
        assert ct_row.tobytes() == want[0].tobytes()
        assert lb_row.astype(np.float64).tobytes() == want[1].tobytes()
        pasted += 1
    assert pasted > 100 and failed > 10
