"""The end-to-end metrics of one window, from the clients' record.

Every time is the host clock the ``ClosedLoop`` callback stamped.  A
request is timed from when its client sent it, not from when the engine
took it in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, interpolated
    linearly between the two nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_samples(loop, t_open: float, t_close: float) -> Dict[str, List]:
    """``tokens``: the times of the tokens delivered inside the window;
    ``ttft``: send to first token of each request sent inside it; ``tbt``:
    each gap between two successive tokens of one request, both inside."""
    tokens, ttft, tbt = [], [], []
    for i, toks in enumerate(loop.tokens):
        times = [t for t, _ in toks]
        inside = [t for t in times if t_open <= t < t_close]
        tokens += inside
        tbt += [b - a for a, b in zip(inside, inside[1:])]
        sent = loop.send[i]
        if sent is not None and t_open <= sent < t_close and times:
            ttft.append(times[0] - sent)
    return {"tokens": tokens, "ttft": ttft, "tbt": tbt}


def end_to_end(loop, t_open: float, t_close: float) -> Dict[str, float]:
    """The window's ``output_tok_s``, ``ttft_p50_s`` and ``tbt_p95_ms``, and
    the counts they rest on."""
    s = window_samples(loop, t_open, t_close)
    if not s["ttft"] or not s["tbt"]:
        raise RuntimeError("the window holds no request or no token gap")
    return {
        "output_tok_s": len(s["tokens"]) / (t_close - t_open),
        "ttft_p50_s": percentile(s["ttft"], 50),
        "tbt_p95_ms": percentile(s["tbt"], 95) * 1e3,
        "n_tokens": len(s["tokens"]),
        "n_ttft": len(s["ttft"]),
        "n_tbt": len(s["tbt"]),
    }
