"""The device's idle share: 1 - the device's busy seconds a batch (the
union of its operations' intervals, kernels, copies and sets, in the
traced window, over its batches) over the wall seconds a batch of the
measured window, which ran without the profiler.  The profiler's own
cost, on the host and at each launch, lengthens the traced window's
batches, so its wall time would count that cost as idle."""

from benchmark import tracing


def read(record):
    if not record.device_ops or not record.traced_batches or \
            not record.n_batches or record.measured_s <= 0:
        return None
    busy = tracing.busy_seconds(record) / record.traced_batches
    return 100.0 * (1.0 - busy / (record.measured_s / record.n_batches))
