"""Port vs JAX package on the CPU: int8 inference (--compute_dtype int8).

The JAX package is the oracle, run on the CPU as tests/test_int8.py runs it.
The generator is at its published width (ngf=16: at ngf=4 nearly every conv
has fewer than 8 outputs and runs bf16), 64 x 64, batch 2, with seeded
random weights.

Exact. The int8 product, both the plain version and the card route (im2col
of int8 views and `torch._int_mm`, called here on CPU tensors), equals XLA's
int8 conv with int32 sums bit for bit. The quantized conv (the spectrally
normalised kernel given, dynamic and static scales) equals the JAX layer's
bf16 output bit for bit. Calibration on the same input: the |x| max exactly,
the quantiles within rtol 1e-6 (torch.quantile interpolates as lerp, JAX as
a weighted sum). `calib_to_quant` on the same calib tree: exactly.

Tolerances. With spectral norm the two packages' sigma differ in the last
float32 bit, so a whole SNConv agrees within one bf16 ulp (rtol 2^-8).
Through the whole generator, bf16 rounding of the elementwise ops (ELU, the
resizes, the attention) differs by an ulp here and there, and where an
activation then sits near a rounding boundary of the int8 grid the two
packages quantize it one step apart. Measured with the static scales of the
test below (the JAX forward op by op, each conv's input captured): a step
flipped in 0.0 % of the first convs' inputs, in 36 % of
all 3.1 M quantized inputs of the 43 int8 convs (20-27 % in the deepest
trunk convs); on the shipped weights 5.7 %. Each flip moves its conv's
output by one grid step of one input, so the forward is held to the bf16
parity test's tolerance (tests/test_torch_generator.py): maps mean abs
error <= 2e-3 and max <= 3e-2 (seen at most 1.5e-3 and 1.8e-2), height
fractions atol 1e-3 (seen 5e-5). Per-conv calibration statistics through
the generator differ as its activations do (seen 1.4 %): rtol 3e-2.

The 3D synthesis runs the shipped weights (at 64 x 64, as the CLI tests
do): a random generator's seg map hovers around 0.5, where every flip
changes a label. Its passes turn floats into discrete pastes, so: CT within
8 grey levels (seen 5) and within 0.5 on average over the synthesized
voxels (seen 0.07), labels equal on >= 99.9 % of voxels (seen all).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healthivert_tpu.data.synthetic import SyntheticDataset
from healthivert_tpu.engine import infer3d as jinfer
from healthivert_tpu.models import pix2pix as jpix
from healthivert_tpu.models.layers import CALIB_PERCENTILES as JAX_PERCENTILES
from healthivert_tpu.models.layers import SNConv as JaxSNConv
from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.models.generator import Generator
from healthivert_tpu_torch.models.layers import (
    CALIB_PERCENTILES,
    SNConv,
    int8_conv,
    int8_scope,
    quantize_weight,
)
from healthivert_tpu_torch.ops import int8_conv as ic
from healthivert_tpu_torch.utils.weights import (
    flax_calib_to_flat,
    flax_quant_to_flat,
    flax_to_state_dict,
    load_npz_trees,
)
from torch_port_fixtures import one_torch_thread  # noqa: F401 (fixture)
from torch_port_fixtures import random_generator_vars

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NGF, SIZE = 16, 64
MAPS = ["coarse_seg", "fine_seg", "x_stage1", "x_stage2"]


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _jax_int8_conv(qx, qw, s, p, d):
    """XLA's int8 conv with int32 sums, NCHW / OIHW numpy in and out."""
    y = jax.lax.conv_general_dilated(
        jnp.asarray(qx.transpose(0, 2, 3, 1)), jnp.asarray(qw.transpose(2, 3, 1, 0)),
        window_strides=(s, s), padding=((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    return np.asarray(y).transpose(0, 3, 1, 2)


# (C, O, k, stride, padding, dilation, H): the generator's stems, its
# stride-2 downsamples, the atrous trunk and 3 x 3 convs, a K = C k^2 that
# is no multiple of 8 (45, 297) and an O that is none either (12)
CONV_CASES = {
    "stem5x5_c3": (3, 16, 5, 1, 2, 1, 20), "stem5x5_c4": (4, 16, 5, 1, 2, 1, 20),
    "stride2": (16, 32, 3, 2, 1, 1, 19), "dil1_k45": (5, 12, 3, 1, 1, 1, 12),
    "dil2": (64, 64, 3, 1, 2, 2, 16), "dil4": (64, 64, 3, 1, 4, 4, 16),
    "dil8": (64, 64, 3, 1, 8, 8, 20), "dil16": (64, 64, 3, 1, 16, 16, 24),
    "c33_k297": (33, 32, 3, 1, 1, 1, 10), "c128": (128, 64, 3, 1, 1, 1, 8),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_product_equals_xla(case):
    c, o, k, s, p, d, h = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    qx, qw = _q(rng, (2, c, h, h + 3)), _q(rng, (o, c, k, k))
    want = _jax_int8_conv(qx, qw, s, p, d)
    tx, tw = torch.from_numpy(qx), torch.from_numpy(qw)
    for route in (ic.int8_conv2d_reference, ic.int8_conv2d_im2col, ic.int8_conv2d):
        got = route(tx, tw, s, p, d)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape, route.__name__
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route.__name__)
    # channels-last activations (the generator's layout) give the same
    cl = tx.contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(ic.int8_conv2d_im2col(cl, tw, s, p, d).numpy(), want)


def test_card_route_chunks_and_pads(monkeypatch):
    """Batches past IM2COL_BYTES run in chunks of samples; fewer than 17
    output rows are padded with zero rows; both leave the result exact."""
    rng = np.random.default_rng(1)
    qx, qw = torch.from_numpy(_q(rng, (5, 6, 9, 9))), torch.from_numpy(_q(rng, (8, 6, 3, 3)))
    want = ic.int8_conv2d_reference(qx, qw, 1, 1, 1)
    monkeypatch.setattr(ic, "IM2COL_BYTES", 2 * 81 * 56)  # two samples a chunk
    assert torch.equal(ic.int8_conv2d_im2col(qx, qw, 1, 1, 1), want)
    tiny = qx[:1, :, :3, :3]
    assert torch.equal(ic.int8_conv2d_im2col(tiny, qw, 1, 1, 1),
                       ic.int8_conv2d_reference(tiny, qw, 1, 1, 1))
    a = ic.im2col(qx[:1], 3, 1, 1, 1, 56)
    assert a.shape == (81, 56) and not a[:, 54:].any()


def test_wrapper_runs_plain_on_cpu_and_refuses_the_rest():
    rng = np.random.default_rng(2)
    qx, qw = torch.from_numpy(_q(rng, (1, 4, 6, 6))), torch.from_numpy(_q(rng, (8, 4, 3, 3)))
    before = ic.int8_conv2d.launches
    assert torch.equal(ic.int8_conv2d(qx, qw, 1, 1, 1), ic.int8_conv2d_reference(qx, qw, 1, 1, 1))
    assert ic.int8_conv2d.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        ic.int8_conv2d(qx.float(), qw)
    with pytest.raises(ValueError):
        ic.int8_conv2d(qx, qw[:, :3])
    with pytest.raises(ValueError, match="no route"):
        ic.int8_conv2d(qx.to("meta"), qw.to("meta"))


def _jax_conv(features, k=3, s=1, p=1, d=1, use_sn=False):
    return JaxSNConv(features=features, kernel_size=k, stride=s, padding=p, dilation=d,
                     use_sn=use_sn, dtype="int8")


def _inputs(rng, shape, spread=True):
    """NHWC float32 samples of very different magnitudes."""
    scale = rng.uniform(0.3, 40.0, (shape[0], 1, 1, 1)) if spread else 1.0
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("scales", ["dynamic", "static"])
@pytest.mark.parametrize("geom", [(3, 16, 5, 1, 2, 1), (16, 32, 3, 2, 1, 1),
                                  (64, 64, 3, 1, 16, 16), (33, 8, 3, 1, 1, 1)],
                         ids=["stem", "stride2", "dil16", "c33"])
def test_quantized_conv_equals_the_jax_layer(geom, scales):
    """The JAX layer without spectral norm and the port's int8_conv on the
    same kernel: equal bit for bit, with per-sample or static scales, on
    float32 and on bf16 inputs (the generator's)."""
    c, o, k, s, p, d = geom
    rng = np.random.default_rng(o + k)
    x32 = _inputs(rng, (3, 24, 24, c))
    conv = _jax_conv(o, k, s, p, d)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x32))
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    v = {"params": {"kernel": v["params"]["kernel"], "bias": jnp.asarray(bias)}}
    act_scale = None
    if scales == "static":
        act_scale = np.float32(0.8 * np.abs(x32).max() / 127)
        v["quant"] = {"act_scale": jnp.asarray(act_scale)}
    qw, sw = quantize_weight(torch.from_numpy(
        np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
    for dtype in (jnp.float32, jnp.bfloat16):
        x = jnp.asarray(x32).astype(dtype)
        want = np.asarray(conv.apply(v, x).astype(jnp.float32))
        tx = _nchw(np.array(x.astype(jnp.float32)))
        if dtype == jnp.bfloat16:
            tx = tx.to(torch.bfloat16)
        got = int8_conv(tx, qw, sw, torch.from_numpy(bias), s, p, d,
                        None if act_scale is None else torch.tensor(act_scale))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_nhwc(got), want, err_msg=str(dtype))


def _port_conv(v, fin, features, k=3, s=1, p=1, d=1, dtype="int8"):
    conv = SNConv(fin, features, k, s, p, d, dtype=dtype)
    sd = flax_to_state_dict({"conv": v["params"]}, {"conv": v["sn"]})
    conv.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    return conv


def test_snconv_int8_with_spectral_norm():
    """A whole SNConv(dtype="int8") against the JAX layer: its output is
    int8_conv of its own normalised weight, and the JAX layer's within one
    bf16 ulp (sigma differs in the last float32 bit)."""
    rng = np.random.default_rng(4)
    x = _inputs(rng, (2, 20, 20, 16))
    jconv = JaxSNConv(features=32, kernel_size=3, padding=1, dtype="int8")
    v = jconv.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jconv.apply(v, jnp.asarray(x)).astype(jnp.float32))
    conv = _port_conv(v, 16, 32)
    with torch.no_grad():
        got = conv(_nchw(x))
        qw, sw = quantize_weight(conv.normalized_weight())
        again = int8_conv(_nchw(x), qw, sw, conv.bias, 1, 1, 1)
    assert torch.equal(got, again)
    np.testing.assert_allclose(_nhwc(got), want, rtol=2 ** -8, atol=1e-6)


def test_narrow_heads_run_bf16():
    """Under int8 a conv with fewer than 8 outputs runs the bf16 conv, bit
    for bit; the JAX head agrees within the bf16 conv tolerance of
    tests/test_torch_layers.py (it rounds once more, after the bias)."""
    rng = np.random.default_rng(3)
    x = _inputs(rng, (2, 16, 16, 9), spread=False)
    jhead = JaxSNConv(features=1, kernel_size=3, padding=1, dtype="int8")
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jhead.apply(v, jnp.asarray(x)).astype(jnp.float32))
    head8, head_bf16 = _port_conv(v, 9, 1), _port_conv(v, 9, 1, dtype=torch.bfloat16)
    with torch.no_grad():
        y8, ybf = head8(_nchw(x)), head_bf16(_nchw(x))
    assert y8.dtype == torch.bfloat16 and torch.equal(y8, ybf)
    np.testing.assert_allclose(_nhwc(y8), want, atol=3e-2, rtol=2e-2)


def test_dynamic_scale_is_per_sample():
    """A sample's output does not depend on what shares its batch."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (1, 4, 12, 12)).astype(np.float32)
    b = rng.normal(0, 50, (1, 4, 12, 12)).astype(np.float32)
    conv = SNConv(4, 8, 3, 1, 1, dtype="int8")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32)))
        solo = conv(torch.from_numpy(a))
        paired = conv(torch.from_numpy(np.concatenate([a, b])))[:1]
    assert torch.equal(solo, paired)


def test_calibration_statistics_equal_the_jax_layer():
    """|x| max exactly and the quantile grid within rtol 1e-6, on an input
    large enough for the subsample stride (2 x 256 x 256 x 16 elements:
    stride 2), max-merged over two calls as the JAX sow merges them; then
    calib_to_quant of the JAX tree equals the JAX function's."""
    assert CALIB_PERCENTILES == JAX_PERCENTILES
    rng = np.random.default_rng(5)
    xs = [_inputs(rng, (2, 256, 256, 16)), _inputs(rng, (2, 256, 256, 16))]
    jconv = JaxSNConv(features=8, kernel_size=3, padding=1, dtype="int8")
    v = jconv.init(jax.random.PRNGKey(1), jnp.asarray(xs[0][:, :8, :8]))
    conv = _port_conv(v, 16, 8)
    calib, want = {}, None
    with torch.no_grad(), int8_scope(calib=calib):
        for x in xs:
            conv(_nchw(x))
            _, mut = jconv.apply(v, jnp.asarray(x), mutable=["calib"])
            one = {k: np.asarray(a) for k, a in mut["calib"].items()}
            want = one if want is None else {k: np.maximum(want[k], a) for k, a in one.items()}
    got = calib[conv]
    assert float(got["act_absmax"]) == float(want["act_absmax"])
    np.testing.assert_allclose(got["act_pq"].numpy(), want["act_pq"], rtol=1e-6, atol=0)

    tree = {"coarse_generator": {"conv1": {"conv": want}}}
    flat = flax_calib_to_flat(tree)
    for pct in (None, *CALIB_PERCENTILES):
        jq = jpix.calib_to_quant(tree, percentile=pct)
        q = pix2pix.calib_to_quant(flat, percentile=pct)
        assert list(q) == ["coarse_generator.conv1.conv"]
        np.testing.assert_array_equal(q["coarse_generator.conv1.conv"].numpy(),
                                      np.asarray(jq["coarse_generator"]["conv1"]["conv"]["act_scale"]))
        np.testing.assert_array_equal(flax_quant_to_flat(jq)["coarse_generator.conv1.conv"].numpy(),
                                      q["coarse_generator.conv1.conv"].numpy())
    for bad in (95.0, 99.95):
        with pytest.raises(ValueError, match="act_pq"):
            pix2pix.calib_to_quant(flat, percentile=bad)
        with pytest.raises(ValueError):
            jpix.calib_to_quant(tree, percentile=bad)
    merged = pix2pix.merge_calib(flat, {k: {s: 2 * t for s, t in d.items()} for k, d in flat.items()})
    assert float(merged["coarse_generator.conv1.conv"]["act_absmax"]) == 2 * float(want["act_absmax"])
    assert pix2pix.merge_calib(None, flat) is flat


@pytest.fixture(scope="module")
def small():
    """Random generator weights at ngf=16, a 64 x 64 batch of 2, both
    packages' generators and JAX's calib tree and its 99.5 % quant tree."""
    import types

    v = random_generator_vars(NGF)
    opt = types.SimpleNamespace(batch_size=2, seed=3, crop_size=SIZE)
    batch = SyntheticDataset(opt, batch_size=2, seed=3, n_volumes=2).sample_batch()
    jcfg = jpix.Pix2PixConfig(ngf=NGF, image_size=SIZE, compute_dtype="int8")
    jgen = jpix.build_modules(jcfg)[0]
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    jcalib = jpix.calibrate_int8(jgen, v["params"], v["sn"], [jb], jcfg, return_calib=True)
    jquant = jpix.calib_to_quant(jcalib, percentile=pix2pix.INT8_CALIB_PERCENTILE)
    cfg = pix2pix.Pix2PixConfig(ngf=NGF, image_size=SIZE, compute_dtype="int8")
    gen = Generator(NGF, dtype=cfg.module_dtype)
    gen.load_state_dict(flax_to_state_dict(v["params"], v["sn"]))
    tb = {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}
    return dict(v=v, jcfg=jcfg, jgen=jgen, jb=jb, jcalib=jcalib, jquant=jquant, cfg=cfg,
                gen=gen.eval(), tb=tb)


def test_calibrate_int8_against_jax(small):
    """Every int8 conv records statistics, under the JAX tree's paths; the
    first conv, whose input is the same in both packages, exactly; the
    others as their activations agree; the quant tree is the calib tree
    through calib_to_quant."""
    got = pix2pix.calibrate_int8(small["gen"], [small["tb"]], small["cfg"], return_calib=True)
    want = flax_calib_to_flat(small["jcalib"])
    assert set(got) == set(want) and len(got) == 43
    first = "coarse_generator.conv1.conv"
    assert float(got[first]["act_absmax"]) == float(want[first]["act_absmax"])
    np.testing.assert_allclose(got[first]["act_pq"].numpy(), want[first]["act_pq"].numpy(),
                               rtol=1e-6)
    for k in want:
        for s in ("act_absmax", "act_pq"):
            np.testing.assert_allclose(got[k][s].numpy(), want[k][s].numpy(), rtol=3e-2,
                                       err_msg=f"{k} {s}")
    quant = pix2pix.calibrate_int8(small["gen"], [small["tb"]], small["cfg"], percentile=99.9)
    for k, t in pix2pix.calib_to_quant(got, percentile=99.9).items():
        assert torch.equal(quant[k], t)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_generator_forward_int8_matches_jax(small, scales):
    jq = small["jquant"] if scales == "static" else None
    want = jax.jit(lambda p, s, b, q: jpix.generator_forward(
        small["jgen"], p, s, b, small["jcfg"], update_sn=False, g_quant=q))(
        small["v"]["params"], small["v"]["sn"], small["jb"], jq)
    with torch.no_grad():
        got = pix2pix.generator_forward(small["gen"], small["tb"], small["cfg"],
                                        g_quant=None if jq is None else flax_quant_to_flat(jq))
    for name in MAPS:
        g = getattr(got["gen"], name)
        assert g.dtype == torch.bfloat16, name
        err = np.abs(g.float().numpy() - np.asarray(getattr(want["gen"], name).astype(jnp.float32)))
        assert err.mean() <= 2e-3 and err.max() <= 3e-2, (name, err.mean(), err.max())
    for name in ("pred1_h", "pred2_h"):
        assert getattr(got["gen"], name).dtype == torch.float32
        np.testing.assert_allclose(getattr(got["gen"], name).numpy(),
                                   np.asarray(getattr(want["gen"], name)), atol=1e-3)


def test_static_scales_do_not_outlive_their_call(small):
    gen, tb, cfg = small["gen"], small["tb"], small["cfg"]
    quant = flax_quant_to_flat(small["jquant"])
    with torch.no_grad():
        dyn = pix2pix.generator_forward(gen, tb, cfg)["gen"].x_stage2
        static = pix2pix.generator_forward(gen, tb, cfg, g_quant=quant)["gen"].x_stage2
        after = pix2pix.generator_forward(gen, tb, cfg)["gen"].x_stage2
    assert torch.equal(dyn, after) and not torch.equal(dyn, static)
    with pytest.raises(KeyError):
        pix2pix.quant_scales(gen, {"fine_generator.nowhere.conv": torch.tensor(1.0)})


def _spine():
    return make_spine_volume(np.random.default_rng(0), shape=(64, 64, 16), vert_ids=(19, 20, 21),
                             vert_height=12, gap=5, fractured={20: 0.6})


@pytest.fixture(scope="module")
def shipped():
    """The shipped generator at int8 on the CPU, and its flax trees."""
    cfg = pix2pix.Pix2PixConfig(ngf=NGF, image_size=SIZE, compute_dtype="int8")
    params, sn = load_npz_trees(PRETRAINED_NPZ)
    return dict(gen=load_generator(PRETRAINED_NPZ, cfg, device="cpu"), cfg=cfg,
                params=params, sn=sn)


@pytest.fixture(scope="module")
def stored(shipped, tmp_path_factory):
    """One int8 synthesis of the spine with quant="auto" at batch 8, which
    calibrates and writes the store: its volumes, store and dispatches."""
    ct, labels, cam = _spine()
    vols = [(ct, labels, 20, cam)]
    store = tmp_path_factory.mktemp("store") / "int8_quant.pt"
    before = infer3d._forward.dispatches
    (a_ct, a_lb), = infer3d.synthesize_volumes(
        shipped["gen"], shipped["cfg"], vols, batch_size=8, quant="auto",
        quant_store=str(store), device="cpu")
    return dict(vols=vols, labels=labels, store=store, ct=a_ct, lb=a_lb,
                dispatches=infer3d._forward.dispatches - before)


def _store_copy(stored, tmp_path):
    path = tmp_path / "int8_quant.pt"
    path.write_bytes(stored["store"].read_bytes())
    return str(path)


def test_synthesize_volumes_int8_auto_matches_jax(shipped, stored):
    jcfg = jpix.Pix2PixConfig(ngf=NGF, image_size=SIZE, compute_dtype="int8")
    (want_ct, want_lb), = jinfer.synthesize_volumes(
        shipped["params"], shipped["sn"], jcfg, stored["vols"], batch_size=8, use_bf16=True,
        quant="auto")
    got_ct, got_lb = stored["ct"], stored["lb"]
    assert stored["store"].is_file()
    d = np.abs(got_ct - want_ct)
    synthesized = (got_ct != 0) | (want_ct != 0)
    assert d.max() <= 8 and d[synthesized].mean() <= 0.5, (d.max(), d[synthesized].mean())
    assert np.mean(got_lb == want_lb) >= 0.999
    zs = np.nonzero((stored["labels"] == 20).any(axis=(0, 1)))[0]
    assert got_ct[:, :, (zs.min() + zs.max()) // 2].max() > 0


def test_quant_store_round_trip_and_batch_independence(shipped, stored, tmp_path):
    """A later call at another batch size loads the stored scales and gives
    bit-equal volumes (its own first batch would calibrate otherwise); the
    loaded tree passed as quant= does the same without the calibration
    forward, which the first call counted as a dispatch."""
    store = _store_copy(stored, tmp_path)
    loaded = infer3d._load_quant_store(store, shipped["gen"])
    assert loaded is not None and len(loaded) == 43
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in loaded.values())
    (b_ct, b_lb), = infer3d.synthesize_volumes(shipped["gen"], shipped["cfg"], stored["vols"],
                                               batch_size=5, quant="auto", quant_store=store,
                                               device="cpu")
    np.testing.assert_array_equal(stored["ct"], b_ct)
    np.testing.assert_array_equal(stored["lb"], b_lb)
    before = infer3d._forward.dispatches
    (c_ct, _), = infer3d.synthesize_volumes(shipped["gen"], shipped["cfg"], stored["vols"],
                                            batch_size=8, quant=loaded, device="cpu")
    assert infer3d._forward.dispatches - before == stored["dispatches"] - 1
    np.testing.assert_array_equal(stored["ct"], c_ct)
    infer3d._save_quant_store(store, loaded, shipped["gen"])
    assert os.listdir(tmp_path) == ["int8_quant.pt"]  # the atomic write leaves no temp file


def test_quant_store_rejects_stale_corrupt_and_foreign(shipped, stored, small, tmp_path):
    store = _store_copy(stored, tmp_path)
    good = infer3d._load_quant_store(store, shipped["gen"])
    other = Generator(NGF, dtype="int8")
    other.load_state_dict(flax_to_state_dict(**random_generator_vars(NGF, seed=7)))

    def warned(path, gen, what):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert infer3d._load_quant_store(path, gen) is None
        assert any(what in str(x.message) for x in w), [str(x.message) for x in w]

    warned(store, other, "different weights")
    blob = open(store, "rb").read()
    with open(store, "wb") as f:
        f.write(blob[: len(blob) // 2])
    warned(store, shipped["gen"], "unreadable")
    # the end-to-end call recovers: it recalibrates, rewrites the store and
    # gives the first call's volumes
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        (b_ct, _), = infer3d.synthesize_volumes(shipped["gen"], shipped["cfg"], stored["vols"],
                                                batch_size=8, quant="auto", quant_store=store,
                                                device="cpu")
    assert any("unreadable" in str(x.message) for x in w)
    np.testing.assert_array_equal(stored["ct"], b_ct)
    assert infer3d._load_quant_store(store, shipped["gen"]) is not None
    # a store without the fingerprint
    torch.save(dict(good), store)
    warned(store, shipped["gen"], "no weight fingerprint")
    # the JAX package's own .msgpack store is foreign here
    msgpack = str(tmp_path / "int8_quant.msgpack")
    jinfer._save_quant_store(msgpack, small["jquant"], small["v"]["params"])
    warned(msgpack, shipped["gen"], "unreadable")


def test_quant_needs_int8_and_a_matching_generator(small):
    ct, labels, cam = _spine()
    vols = [(ct, labels, 20, cam)]
    gen_bf16 = Generator(NGF, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype='int8'"):
        infer3d.synthesize_volumes(gen_bf16, pix2pix.Pix2PixConfig(ngf=NGF, image_size=SIZE,
                                                                   compute_dtype="bfloat16"),
                                   vols, quant="auto", device="cpu")
    with pytest.raises(ValueError, match="dtype=int8"):
        infer3d.synthesize_volumes(gen_bf16, small["cfg"], vols, device="cpu")
