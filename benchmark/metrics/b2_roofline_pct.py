"""Kernel B2's share of its roofline over the traced window: the summed
least time of its launches (`work.b2_work`, bf16 peak) over their summed
device time in the profiler's trace (the query rounding and the scan).
Nothing where the launches counted and the kernels traced disagree."""

from benchmark import tracing, work


def read(record):
    seconds, _ = record.kernel_seconds(tracing.B2_KERNELS)
    if not record.b2_work or seconds <= 0 or \
            record.count_kernels(tracing.B2_MAIN_KERNEL) != len(
                record.b2_work):
        return None
    least = sum(work.least_seconds(n_bytes, ops, work.BF16_FLOPS)
                for n_bytes, ops in record.b2_work)
    return 100.0 * least / seconds
