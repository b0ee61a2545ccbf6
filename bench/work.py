"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work could take on it, and the model calls a window made.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense rates, at
its 700 W limit); ``bound_s`` is the larger of bytes over the memory
bandwidth and operations over the bf16 tensor-core rate, as the port's
kernel table measures its kernels against.
"""

from __future__ import annotations

import bisect
from typing import Dict, List

PEAK_BF16_FLOPS = 989e12        # FLOP/s, dense, tensor cores
HBM_BYTES_PER_S = 3.35e12       # bytes/s
HBM_BYTES = 80 * 10**9


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds one H100 could take for ``nbytes`` of memory
    traffic and ``ops`` bf16 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def model_calls(record: dict, lo: float, hi: float) -> List[Dict]:
    """The model calls whose host span starts in ``[lo, hi)``, each
    ``{"kind": "chunk" | "decode", "contexts": [...], "heads": n}``: the
    context length of each row the call processed (a prompt token at
    position ``p`` attends to ``p + 1`` keys; a decode row of a request's
    ``j``-th token, ``j >= 1``, to ``prompt + j``) and the rows whose logits
    it took.  Chunks come from the engine's ``prefill_chunk`` spans; a
    decode tick's rows are the tokens the clients got after its
    ``decode_tick`` span closed and before the next one began."""
    calls = []
    ticks = sorted((s["start"], s["end"]) for s in record["spans"]
                   if s["name"] == "decode_tick")
    rows: Dict[int, List[int]] = {}
    ends = [e for _, e in ticks]
    for i, toks in enumerate(record["tokens"]):
        plen = record["prompt_lens"][i]
        for j, (t, _) in enumerate(toks[1:], start=1):
            k = bisect.bisect_right(ends, t) - 1
            if k >= 0:
                rows.setdefault(k, []).append(plen + j)
    for k, (start, _) in enumerate(ticks):
        if lo <= start < hi and k in rows:
            calls.append({"kind": "decode", "contexts": rows[k],
                          "heads": len(rows[k])})
    for s in record["spans"]:
        if s["name"] == "prefill_chunk" and lo <= s["start"] < hi:
            done, n = s["args"]["done"], s["args"]["tokens"]
            calls.append({"kind": "chunk",
                          "contexts": list(range(done + 1, done + n + 1)),
                          "heads": 1})
    return calls
