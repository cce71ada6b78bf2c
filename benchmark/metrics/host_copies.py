"""Copies from the device to the host a batch: the program's counter
``host_copies`` (one a call of `utils.profiling.to_host`, the batch
path's way to the host) over the batches of the traced pass that traces
the device alone (`program_trace.py`).  Nothing where the program keeps
no trace or the pass ran no device operation."""

from benchmark import program_trace


def read(record):
    return program_trace.mean_counter(record, "host_copies")
