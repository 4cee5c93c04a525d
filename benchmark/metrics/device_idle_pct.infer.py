"""The share of the device's traced stretch (the card's activity alone, no
host ops recorded) in which no kernel, copy or set ran on the card."""

from harness import readers


def read(data):
    return readers.device_idle_pct(data, "infer")
