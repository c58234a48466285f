"""Host ms per train step in the program's backward span
(``mme.train.backward``: ``autograd.grad`` and the zero fill)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_ms(layer, "mme.train.step", "mme.train.backward")
