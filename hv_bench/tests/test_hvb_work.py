"""The yardstick's work counts against hand-worked values, and the counts
stored in the configurations recomputed."""

import json

import pytest

from hv_bench import work
from hv_bench.tests.conftest import REPO


def test_attention_bound_by_hand():
    # B=64, 32 x 32 grid, C=64, bf16: 25 products of 2 L P C operations a
    # sample, 64 * 25 * 2 * 1024^2 * 64 = 2.147e11, at 989 TFLOP/s 0.217 ms
    flops, nbytes = work.attention_fwd(64, 32, 32, 64, "bfloat16")
    assert flops == 64 * 25 * 2 * 1024 * 1024 * 64
    assert nbytes == 64 * (10 * 1024 * 64 * 2 + 1024 * 4)
    assert work.least_s(flops, nbytes, "bfloat16") * 1e3 == pytest.approx(0.2171, abs=5e-5)


def test_attention_backward_by_hand():
    flops, _ = work.attention_bwd(32, 32, 32, 64, "float32")
    assert flops == 32 * 100 * 1024 * 1024 * 64
    assert work.least_s(flops, 0, "float32") == pytest.approx(flops / 495e12)


def test_least_time_is_the_larger_bound():
    assert work.least_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(989e9, 3.35e12, "bfloat16") == pytest.approx(1.0)


def test_attention_grid_of_the_generator():
    assert work.attention_grid(256, 16) == (32, 32, 64)


@pytest.mark.parametrize("name", ["healthivert-bf16", "healthivert-f32"])
def test_stored_counts_recomputed(name):
    config = json.loads((REPO / "hv_bench" / "configs" / f"{name}.json").read_text())
    assert work.count(config) == config["work"]


def test_slice_count_holds_the_attention():
    config = json.loads((REPO / "hv_bench" / "configs" / "healthivert-bf16.json").read_text())
    w = config["work"]
    attn, _ = work.attention_fwd(1, 32, 32, 64, "bfloat16")
    # a slice's forward is its convs, its attention and the height heads
    assert w["slice_fwd_flops"] - w["slice_fwd_conv_flops"] - attn < 1e6
