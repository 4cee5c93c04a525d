"""The calling thread's ms a request outside its device waits, by the
program's spans: the outermost spans on the calling thread, less the
device waits among them and the wait for a prefetched batch (the device's
traced stretch, so without the cost of recording host ops).  It is the
host's own work only while the host keeps ahead of the card: once CUDA's
launch queue is full, each kernel launch blocks until the card drains it,
and that wait lies inside the spans, so for a step that keeps the card
busy this tracks the whole step."""

from harness import program_spans


def read(data):
    return program_spans.mean(data, "infer", "host_self_ms")
