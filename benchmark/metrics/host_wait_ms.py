"""Milliseconds a batch the host waits on the device: the program's leaf
spans ``host_copy`` (each copy from the device to the host) and ``sync``
(each stage end's synchronization) over the batches of the traced pass
that traces the device alone (`program_trace.py`).  Nothing where the
program keeps no trace or the pass ran no device operation."""

from benchmark import program_trace


def read(record):
    seconds = program_trace.mean_seconds(record, "host_copy", "sync")
    return None if seconds is None else 1e3 * seconds
