"""Host ms per served chunk in the program's forward span
(``mme.serve.forward``: the normalisation and the forward enqueued)."""

from harness import spans

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "serve":
        return None
    return spans.mean_ms(layer, "mme.serve.chunk", "mme.serve.forward")
