"""Host ms per train step blocked on the prefetch queue and its copies'
event (``mme.prefetch.wait``, which belongs to the step after it)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_ms(layer, "mme.train.step", "mme.prefetch.wait")
