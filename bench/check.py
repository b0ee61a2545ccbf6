"""Whether what the timed path served is right: a sample of the requests
the window's call finished, held to the plain reference.

The sample is drawn from the seed among the requests finished at or after
the window's opening (the warm-up requests left out), the one with the
most served tokens always in it.  The reference runs once over each
sampled prompt with its served tokens, in float32, and at each served
token reads the ``logit_gap``: how far that token's logit lies below the
reference's best.  The widest gap (``logit_gap``) or the mean gap
(``logit_gap_mean``) is compared with the cell's limit, as the cell's
``checks/<cell>.json`` says: each is 0 where every served token is the
reference's greedy choice, and grows where the program's arithmetic moves
a choice.  The mean stands where a few flipped expert choices, which
bf16's rounding of the hidden state makes at near-ties, set the widest
gap of sound runs as high as the control's.

The control is the same reference in float8 (``common.linear``): at each
position of the same prompts and tokens, the gap of the token it puts
first.  It only runs when asked for (``bench/calibrate.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.reference.common import linear
from bench.traffic import seed_bits

VOCAB_BLOCK = 16384


def sample(loop, prompt_lens: List[int], t_open: float, n: int, seed: int
           ) -> List[int]:
    """``n`` finished requests drawn from ``seed``, the longest first."""
    done = [i for i, t in enumerate(loop.done)
            if t is not None and t >= t_open and i >= loop.clients]
    if not done:
        raise RuntimeError("no request finished inside the window")
    longest = max(done, key=lambda i: (loop.max_new[i], prompt_lens[i], -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng(seed_bits(seed) ^ 0x5EED)
    return [longest] + sorted(int(i) for i in
                              rng.permutation(rest)[:max(0, n - 1)])


def logit_gaps(ref, weights: dict, cfg: dict, prompts: List[np.ndarray],
               served: List[List[int]], control: bool = False
               ) -> Dict[str, float]:
    """The widest ``logit_gap`` of the served tokens (``program``), their
    mean (``mean``) and how many are not the reference's first choice
    (``differ``) of the ``tokens`` compared; with ``control``, the same of
    the float8 reference's first choices (``control``, ``control_mean``,
    ``control_differ``)."""
    dev = weights["embedding"].device
    seqs = [torch.as_tensor(np.concatenate([p, np.asarray(s[:-1])]),
                            dtype=torch.long, device=dev)
            for p, s in zip(prompts, served)]

    def rows(hidden):
        return torch.cat([h[len(p) - 1:] for h, p in zip(hidden, prompts)])

    with torch.no_grad():
        h_ref = rows(ref.final_hidden(weights, cfg, seqs, "f32"))
        h_ctl = rows(ref.final_hidden(weights, cfg, seqs, "fp8")) \
            if control else None
        tok = torch.as_tensor(np.concatenate([np.asarray(s) for s in served]),
                              dtype=torch.long, device=dev)
        w = ref.head(weights, cfg)
        n = tok.numel()
        best = torch.full((n,), float("-inf"), device=dev)
        at_tok = torch.full((n,), float("nan"), device=dev)
        ctl_best = torch.full((n,), float("-inf"), device=dev)
        at_ctl = torch.full((n,), float("nan"), device=dev)
        idx = torch.arange(n, device=dev)
        for lo in range(0, w.shape[1], VOCAB_BLOCK):
            blk = w[:, lo:lo + VOCAB_BLOCK]
            lr = linear(h_ref, blk, "f32")
            best = torch.maximum(best, lr.max(1).values)
            inside = (tok >= lo) & (tok < lo + blk.shape[1])
            at_tok[inside] = lr[idx[inside], tok[inside] - lo]
            if control:
                v, a = linear(h_ctl, blk, "fp8").max(1)
                better = v > ctl_best
                ctl_best = torch.where(better, v, ctl_best)
                at_ctl = torch.where(better, lr[idx, a], at_ctl)
        gap = best - at_tok
        out = {"program": float(gap.max()), "tokens": n,
               "differ": int((gap > 0).sum()), "mean": float(gap.mean())}
        if control:
            ctl = best - at_ctl
            out.update(control=float(ctl.max()),
                       control_differ=int((ctl > 0).sum()),
                       control_mean=float(ctl.mean()))
    return out
