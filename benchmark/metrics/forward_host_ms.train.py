"""Host ms per train step in the program's forward span (``mme.train.forward``:
the model and the loss enqueued)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_ms(layer, "mme.train.step", "mme.train.forward")
