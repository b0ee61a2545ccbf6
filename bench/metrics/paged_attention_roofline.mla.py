"""``paged_attention_roofline.mla``: the least time the window's latent
attention needed on the card, over the device time of the paged kernel's
``mla`` body (``paged_mla_kernel`` in ``csrc/paged_attention.cu``).

The work is MLA's absorbed form over one latent row of ``kv_lora_rank +
qk_rope_head_dim`` a token, which is both key and value: each context byte
read once per decode token and once per prompt (a chunk reads its own new
rows), the queries and outputs of ``num_attention_heads`` once, and the
causal score and value products; each call once per layer, at the card's
peaks.  It depends on neither the chunking nor the kernel.  Layer:
``kernels.paged_attention``; moves ``output_tok_s``."""

from bench.devtrace import seconds_of
from bench.work import bound_s, model_calls

KERNEL = r"\bpaged_mla_kernel\b"


def read(record):
    cfg, tr = record["config"], record["trace"]
    t0, t1 = tr["t0"], tr["t1"]
    kernel_s = seconds_of(tr["events"], KERNEL, t0, t1)
    if not kernel_s:
        return None
    h = cfg["num_attention_heads"]
    d = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    dv = cfg["kv_lora_rank"]
    least = 0.0
    for call in model_calls(record, t0, t1):
        ctx = call["contexts"]
        rows = len(ctx) if call["kind"] == "chunk" else sum(ctx)
        nbytes = 2 * (rows * d + len(ctx) * h * (d + dv))
        ops = 2 * h * (d + dv) * sum(ctx)
        least += bound_s(nbytes, ops)
    return 100.0 * least * cfg["num_hidden_layers"] / kernel_s
