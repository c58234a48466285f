"""Device kernels launched per train step, counted in the trace (copies and
sets left out)."""

UNIT = "kernels"


def read(layer):
    if layer.get("kind") != "train" or layer["summary"].units <= 0:
        return None
    s = layer["summary"]
    return sum(c for c, _ in s.kernels.values()) / s.units
