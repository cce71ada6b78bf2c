"""Kernel B4's share of its roofline over the traced window: the summed
least time of its launches (`work.b4_work`, the f32 instruction rate)
over their summed device time in the profiler's trace.  Nothing where
the launches counted and the kernels traced disagree."""

from benchmark import tracing, work


def read(record):
    seconds, n = record.kernel_seconds(tracing.B4_KERNELS)
    if not record.b4_work or seconds <= 0 or n != len(record.b4_work):
        return None
    least = sum(work.least_seconds(n_bytes, ops, work.F32_INSTR_PER_S)
                for n_bytes, ops in record.b4_work)
    return 100.0 * least / seconds
