"""Milliseconds a batch in the vectorize stage: the window's stage seconds
(`stage_seconds["vectorize"]` of `ann_open_search_batch`, the device
synchronised at the stage's end, as the engine runs it) over its batches."""


def read(record):
    seconds = record.stage_seconds.get("vectorize")
    if seconds is None or not record.n_batches:
        return None
    return 1e3 * seconds / record.n_batches
