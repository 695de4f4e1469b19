"""The training work of the window's examples (the reference's operations
of one example's step, counted at the configuration's shapes) over the
window's seconds, as a share of the card's peak for the configuration's
dtype (bf16 989, float32 495 TFLOP/s)."""


def read(layer):
    if not layer.get("images") or not layer.get("window_s"):
        return None
    rate = layer["images"] * layer["example_flops"] / layer["window_s"]
    return 100.0 * rate / layer["peak_flops"]
