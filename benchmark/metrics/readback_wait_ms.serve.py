"""Host ms per served chunk in the program's read-back span
(``mme.serve.readback``: the host waiting for the device, then the copy
of the answers)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "serve":
        return None
    return spans.mean_ms(layer, "mme.serve.chunk", "mme.serve.readback")
