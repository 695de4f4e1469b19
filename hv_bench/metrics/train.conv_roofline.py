"""Least time of the convolutions of the traced steps (the reference's conv
operations and elements of one example's step, counted at the
configuration's shapes, times the examples; eval forwards among them
counted alike) over the device time of cuDNN's convolution kernels and the
layout transforms and transforms of its FFT and Winograd engines."""

import re

KERNELS = re.compile(
    r"xmma_(fprop|dgrad|wgrad)|xmma_gemm_cf32|ImplicitGemmConvolution|s16816(fprop|dgrad|wgrad)|"
    r"convolve_common_engine|implicit_convolve_sgemm|conv2d_grouped_direct|"
    r"dgrad2d_grouped_direct|wgrad2d|dgrad_engine|wgrad_alg|fft2d_|DSE::|"
    r"region_transform_ABC|winograd|scalePackedTensor|nchwToNhwcKernel|nhwcToNchwKernel|"
    r"nhwcAddPaddingKernel|flip_filter")


def read(layer):
    win = layer.get("window")
    if win is None or "conv_least_s" not in layer:
        return None
    spent = sum(s for k, s in win.kernels.items() if KERNELS.search(k))
    if spent <= 0:
        return None
    return 100.0 * layer["conv_least_s"] / spent
