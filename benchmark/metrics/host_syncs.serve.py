"""Host syncs per served chunk: the program's ``host_syncs`` counter over
``mme.serve.chunk`` and the spans under it."""

from harness import spans

UNIT = "syncs"


def read(layer):
    if layer.get("kind") != "serve":
        return None
    return spans.mean_count(layer, "mme.serve.chunk", "host_syncs")
