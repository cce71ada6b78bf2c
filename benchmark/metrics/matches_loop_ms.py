"""Milliseconds a batch in the matches stage's loop over rows on the host
(`search.best_pair_matches`: one NumPy array a row), read from the
program's own span ``matches.rows`` over the batches of the traced pass
that traces the device alone (`program_trace.py`).  Nothing where the
program keeps no trace or the pass ran no device operation."""

from benchmark import program_trace


def read(record):
    seconds = program_trace.mean_seconds(record, "matches.rows")
    return None if seconds is None else 1e3 * seconds
