"""K1 + K2 (the flash kernels, ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
against their bound: the frozen bound of a step's attention calls
(``flops.flash_bounds``) over their device time per traced step."""

UNIT = "%"


def read(layer):
    if layer.get("kind") != "train":
        return None
    s = layer["summary"]
    _, t_fwd = s.kernels_matching("flash_fwd")
    _, t_bwd = s.kernels_matching("flash_bwd")
    if t_fwd + t_bwd <= 0 or s.units <= 0:
        return None
    return 100.0 * layer["flash_bound_s"] / ((t_fwd + t_bwd) / s.units)
