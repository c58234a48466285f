"""Device time per step in ms: the union of the traced window's kernel,
copy and set intervals over its steps: the device's own work, without the
host's share of the window, which paces the rate."""

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train" or layer["summary"].units <= 0:
        return None
    s = layer["summary"]
    return 1e3 * s.busy_s / s.units if s.busy_s > 0 else None
