"""Ms a step that the calling thread spends blocked on the device, by
the program's ``wait`` and ``batch.to_device`` spans (the device's traced
stretch)."""

from harness import program_spans


def read(data):
    return program_spans.mean(data, "train", "device_wait_ms")
