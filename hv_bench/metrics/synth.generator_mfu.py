"""The generator work of the window's useful slices (the reference's
operations a slice, counted at the configuration's shapes) over the
window's seconds, as a share of the card's peak for the configuration's
dtype."""


def read(layer):
    if not layer.get("slices") or not layer.get("window_s"):
        return None
    return 100.0 * layer["slices"] * layer["slice_flops"] / layer["window_s"] / layer["peak_flops"]
