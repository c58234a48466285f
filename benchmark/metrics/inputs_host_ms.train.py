"""Host ms per train step in the program's inputs span (``mme.train.inputs``:
the batch, labels, mask and weights onto the device; a pageable copy
waits there for the device to drain its queue)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_ms(layer, "mme.train.step", "mme.train.inputs")
