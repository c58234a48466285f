"""Share of the traced window in which no operation ran on the device
(the union of kernel, copy and set intervals), train cells."""

UNIT = "%"


def read(layer):
    if layer.get("kind") != "train":
        return None
    s = layer["summary"]
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
