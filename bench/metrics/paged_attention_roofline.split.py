"""``paged_attention_roofline.split``: the least time the window's
grouped-query attention needed on the card, over the device time of the
paged kernel's ``split`` body and its combine pass (``paged_split_kernel``
and ``paged_combine_kernel`` in ``csrc/paged_attention.cu``).

The work: each context token's keys and values (``num_key_value_heads`` x
``head_dim`` each) read once per decode token and once per prompt (a chunk
reads its own new rows), the queries and outputs of
``num_attention_heads`` once, and the causal score and value products over
the context (within ``sliding_window`` when set); each call once per
layer, at the card's peaks.  Layer: ``kernels.paged_attention``; moves
``output_tok_s``."""

from bench.devtrace import seconds_of
from bench.work import bound_s, model_calls

KERNEL = r"\bpaged_(split|combine)_kernel\b"


def read(record):
    cfg, tr = record["config"], record["trace"]
    t0, t1 = tr["t0"], tr["t1"]
    kernel_s = seconds_of(tr["events"], KERNEL, t0, t1)
    if not kernel_s:
        return None
    h, g = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg.get("head_dim") or cfg["assumed"]["head_dim"]
    window = cfg.get("sliding_window") or 0
    least = 0.0
    for call in model_calls(record, t0, t1):
        ctx = [min(c, window) if window else c for c in call["contexts"]]
        rows = len(ctx) if call["kind"] == "chunk" else sum(ctx)
        nbytes = 2 * (rows * 2 * g * d + len(ctx) * 2 * h * d)
        ops = 2 * h * 2 * d * sum(ctx)
        least += bound_s(nbytes, ops)
    return 100.0 * least * cfg["num_hidden_layers"] / kernel_s
