"""Least time of the attention work of the traced steps (a forward and a
backward at the recipe's batch per step, and a forward per example of any
eval epoch among them) over the device time of the attention route's
kernels."""

import re

# the kernels of both routes of ops/attention_cuda (bf16 csrc/attention_tc*.cu,
# float32 csrc/attention_tf32*.cu): GEMMs, the norm, the fused softmax and
# its adjoint, the sweeps and splits
KERNELS = re.compile(r"patch_norm_kernel|lp_gemm|pc_gemm|fuse_softmax_tc|fuse_adj_tc|"
                     r"softmax_bwd|dn2_kernel|split_rows|split_kernel")


def read(layer):
    win = layer.get("window")
    if win is None or "attention_least_s" not in layer:
        return None
    spent = sum(s for k, s in win.kernels.items() if KERNELS.search(k))
    if spent <= 0:
        return None
    return 100.0 * layer["attention_least_s"] / spent
