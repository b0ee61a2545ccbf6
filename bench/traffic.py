"""Seeded traffic for one mix file (``bench/traffic/<mix>.json``).

The one generator every mix uses.  A mix is a closed loop of ``clients``
clients over a list of ``requests`` requests:

* the first ``clients`` requests warm the cell up: one-chunk prompts, and
  outputs spread evenly up to the mix's longest, so slots free at
  staggered times and the loop nears its steady state before the window
  opens;
* the rest draw their prompt and output lengths from the mix's
  distributions at the quantiles of a Kronecker sequence: request ``k``
  takes quantile ``frac(0.5 + k * STEP)`` for its prompt and ``frac(0.5 +
  k * STEP2)`` for its output.  Every stretch of consecutive requests then
  covers both distributions, and their pairing, almost evenly.

The sizes are the same for every seed, and so is the engine's schedule:
which chunks and decode rows each tick runs follows from the sizes alone,
so any reordering would change the window's work.  The seed draws the
prompts' token ids (and the weights), which the check then sees anew.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

DRAWS = ("loguniform",)
STEP = (math.sqrt(5) - 1) / 2            # the golden ratio's fraction
STEP2 = math.sqrt(2) - 1


def seed_bits(seed: int) -> int:
    """``seed`` as the non-negative 64-bit integer both generators take."""
    return int(seed) % 2**64


def lengths(spec: dict, u: np.ndarray) -> np.ndarray:
    """The lengths at quantiles ``u`` of ``spec``'s distribution
    (``{"min", "max", "draw"}``), as whole tokens."""
    if spec["draw"] not in DRAWS:
        raise ValueError(f"unknown draw {spec['draw']!r}; one of {DRAWS}")
    lo, hi = math.log(spec["min"]), math.log(spec["max"])
    return np.rint(np.exp(lo + u * (hi - lo))).astype(np.int64)


def requests(mix: dict, seed: int, vocab: int, warm_prompt: int
             ) -> List[Tuple[np.ndarray, int]]:
    """The mix's request list for ``seed``: ``(prompt token ids (int32),
    output tokens)`` each, the warm-up requests first.  ``warm_prompt`` is
    the length of a one-chunk prompt (the engine's chunk; the mix's longest
    prompt where that is shorter)."""
    rng = np.random.default_rng(seed_bits(seed))
    clients, n = int(mix["clients"]), int(mix["requests"])
    if n <= clients:
        raise ValueError(f"{n} requests leave none after the {clients} "
                         f"warm-up requests")
    longest = int(mix["output_tokens"]["max"])
    warm = min(int(warm_prompt), int(mix["prompt_tokens"]["max"]))
    k = np.arange(n - clients)
    plens = [warm] * clients + lengths(mix["prompt_tokens"],
                                       (0.5 + k * STEP) % 1.0).tolist()
    outs = [max(1, round(longest * (i + 1) / clients))
            for i in range(clients)] + \
        lengths(mix["output_tokens"], (0.5 + k * STEP2) % 1.0).tolist()
    if max(p + o for p, o in zip(plens, outs)) > int(mix["max_len"]):
        raise ValueError("a request outgrows the mix's max_len")
    return [(rng.integers(0, vocab, size=p, dtype=np.int64).astype(np.int32),
             int(o)) for p, o in zip(plens, outs)]
