"""``device_idle_share``: the share of the traced window in which no
kernel, copy or set ran on the card (1 - the union of the device's
intervals in the profiler trace, over the window).  Layer: the device;
moves ``output_tok_s``."""

from bench.devtrace import busy_seconds


def read(record):
    tr = record["trace"]
    if not tr["events"]:
        return None
    return 100.0 * (1.0 - busy_seconds(tr["events"], tr["t0"], tr["t1"])
                    / (tr["t1"] - tr["t0"]))
