"""Generator slices the window's patients need, counted by the benchmark's
reference driver, per batched forward the system dispatched (its counter
`engine.infer3d._forward.dispatches`)."""


def read(layer):
    if not layer.get("dispatches"):
        return None
    return layer["slices"] / layer["dispatches"]
