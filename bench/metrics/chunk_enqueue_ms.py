"""``chunk_enqueue_ms``: the mean length of the engine's ``prefill_chunk``
spans that start in the traced window.  The span closes when the host has
queued the chunk, not when the card has run it: it is the host's enqueue
time of one chunk.  Layer: the ``serve.engine`` host loop; moves
``output_tok_s`` (a prefilling slot adds one chunk to every tick)."""


def read(record):
    t0, t1 = record["trace"]["t0"], record["trace"]["t1"]
    d = [s["end"] - s["start"] for s in record["spans"]
         if s["name"] == "prefill_chunk" and t0 <= s["start"] < t1]
    return sum(d) / len(d) * 1e3 if d else None
