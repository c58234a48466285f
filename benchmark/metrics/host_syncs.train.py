"""Host syncs per train step: the program's ``host_syncs`` counter over
``mme.train.step`` and the spans under it (every CUDA call that made the
host wait for the device)."""

from harness import spans

UNIT = "syncs"


def read(layer):
    if layer.get("kind") != "train":
        return None
    return spans.mean_count(layer, "mme.train.step", "host_syncs")
