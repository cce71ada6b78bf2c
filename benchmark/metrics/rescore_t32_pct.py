"""The share of the traced batches' queries whose certificate failed at
rescoring's first tier (t0 = 8 candidates by bound) and which were
rescored again at the second (32): the rows of the stage-2 calls at the
larger t over those at the smallest.  Nothing where no stage-2 call ran."""


def read(record):
    if not record.tiers:
        return None
    t0 = min(t for _, t in record.tiers)
    first = sum(rows for rows, t in record.tiers if t == t0)
    later = sum(rows for rows, t in record.tiers if t > t0)
    return 100.0 * later / first if first else None
