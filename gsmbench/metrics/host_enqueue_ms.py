"""host_enqueue_ms: the host's ms to enqueue one frame while a sleep kernel
holds the device (harness/timing.py::frame_split); None where the host
waited on the device in every attempt."""


def read(ctx):
    split = ctx["split"]
    return split["host_ms"] if split["host_ahead"] else None
