"""``tick_ms``: the traced window's milliseconds over the decode ticks the
engine ran in it (its ``decode_steps`` counter).  Layer: the
``serve.engine`` host loop; moves ``tbt_p95_ms``."""


def read(record):
    (t0, c0), (t1, c1) = record["counted"]["open"], record["counted"]["close"]
    ticks = c1["decode_steps"] - c0["decode_steps"]
    return (t1 - t0) * 1e3 / ticks if ticks else None
