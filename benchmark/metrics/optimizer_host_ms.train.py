"""Host ms per train step in the program's optimizer span
(``mme.train.optimizer``: from the gradients to the updated parameters:
the cast, the norms and clip, the AdamW update)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_ms(layer, "mme.train.step", "mme.train.optimizer")
