"""``slot_occupancy``: the share of decode slots that decoded a token, over
the traced window's ticks (the engine's ``active_slot_steps`` over its
``slot_steps``).  Layer: ``serve.pages`` ``PagedScheduler``; moves
``output_tok_s``."""


def read(record):
    c0, c1 = record["counted"]["open"][1], record["counted"]["close"][1]
    slots = c1["slot_steps"] - c0["slot_steps"]
    return (c1["active_slot_steps"] - c0["active_slot_steps"]) / slots \
        if slots else None
