"""The share of the traced batches' queries whose certificate failed at
both stage-2 tiers, so that rescoring ran the greedy over all of their C
candidates (in 8,192-pair chunks, each ending in a host copy).  Nothing
where no stage-2 call ran."""


def read(record):
    if not record.tiers:
        return None
    t0 = min(t for _, t in record.tiers)
    first = sum(rows for rows, t in record.tiers if t == t0)
    return 100.0 * record.full_rows / first if first else None
