"""Host-to-device copy device time per served chunk (``Predictor``'s
``_to_device``), in ms."""

UNIT = "ms"


def read(layer):
    if layer.get("kind") != "serve" or layer["summary"].units <= 0:
        return None
    s = layer["summary"]
    t = sum(sec for n, (_, sec) in s.copies.items() if "HtoD" in n)
    return 1e3 * t / s.units
