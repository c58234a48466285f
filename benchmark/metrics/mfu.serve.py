"""Whole served chunk's share of the chip's peak: model FLOPs per
utterance (one forward, ``flops.py``) times the utterances per second of
the traced run's untraced first half, over the compute dtype's peak."""

UNIT = "%"


def read(layer):
    if layer.get("kind") != "serve":
        return None
    return 100.0 * layer["flops_per_utt"] * layer["utt_per_s"] / layer[
        "peak_flops"]
