"""cuDNN convolution device time per train step, forward and backward
(kernel families ``conv`` and ``conv backward``), in ms."""

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train" or layer["summary"].units <= 0:
        return None
    s = layer["summary"]
    conv = s.family_s("conv") + s.family_s("conv backward")
    # a model with no convolution has nothing here to read
    return 1e3 * conv / s.units if conv > 0 else None
