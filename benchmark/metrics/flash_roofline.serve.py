"""K1 (``csrc/flash_fwd.cu``) against its bound: the frozen bound of a
chunk's attention calls (``flops.flash_bounds``) over K1's device time per
traced chunk."""

UNIT = "%"


def read(layer):
    if layer.get("kind") != "serve":
        return None
    s = layer["summary"]
    _, t = s.kernels_matching("flash_fwd")
    if t <= 0 or s.units <= 0:
        return None
    return 100.0 * layer["flash_bound_s"] / (t / s.units)
