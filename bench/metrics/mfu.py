"""``mfu``: the model FLOPs of the tokens the traced window processed, over
the window and the card's bf16 peak.  Each prompt and decode token costs 2
x the parameters it multiplies through (the top-k routed and the shared
experts, never the dispatch's padding), each row whose logits were taken 2
x the head, and each token the score and value products over its context
(the reference's ``arithmetic``).  Layer: the ``models.model`` step;
moves ``output_tok_s``."""

from bench.work import PEAK_BF16_FLOPS, model_calls


def read(record):
    t0, t1 = record["trace"]["t0"], record["trace"]["t1"]
    a = record["reference"].arithmetic(record["config"])
    window = record["config"].get("sliding_window") or 0
    flops = 0.0
    for call in model_calls(record, t0, t1):
        ctx = call["contexts"]
        flops += len(ctx) * a["token"] + call["heads"] * a["head"]
        flops += a["context"] * sum(min(c, window) if window else c
                                    for c in ctx)
    return 100.0 * flops / ((t1 - t0) * PEAK_BF16_FLOPS) if flops else None
