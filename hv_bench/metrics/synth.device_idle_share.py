"""Share of the measured window (run without the profiler) in which no
kernel, copy or fill ran on the card: one minus the device-busy seconds of
a patient (the union of the traced patient's device records) over the
seconds of a patient in the measured window. The traced patients' own length
is not used: tracing slows the host, so it would read the idle share high
where the host leads."""


def read(layer):
    busy, each = layer.get("unit_busy_s"), layer.get("unit_s")
    if busy is None or not each:
        return None
    return 100.0 * (1.0 - busy / each)
