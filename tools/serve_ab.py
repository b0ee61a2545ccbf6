#!/usr/bin/env python3
"""Serving wall times of one source tree of the port, for comparing two
trees on one card.

    python3 tools/serve_ab.py --tree PATH [--label NAME] [--reps N]

``PATH`` is the root of a checkout (its ``chip_smoke.py`` and ``src/``);
the script imports that tree's ``chip_smoke`` and ``repro_torch``, builds
its kernels, and serves two of ``chip_smoke.py``'s traces with its own
helpers, at full width, bf16, seeded random weights:

  * llama3.2-1b paged serving (``serve_trace``, phase 4's trace: 16
    layers, 8 slots);
  * qwen2-vl-7b cohort serving (``serve_cohort``, phase 24's trace: 28
    layers, 8 requests, three cohorts).

Each is served ``N`` times (default 1; 0 serves nothing), a fresh engine
each time.  Before that it times, on the host alone, the tree's
projection blocks as one decode step calls them (``layers._qkv``,
``layers.swiglu_ffn`` and ``layers.lm_logits`` on one token of reduced
llama3.2-1b's CPU tensors: Python, dispatch and a tiny product, best of 5
means of 2,000 calls), so two trees' host cost a call can be compared
below the serving walls' spread.  It prints the card's ``nvidia-smi``
name and power limit and, as its last line, one JSON object of the host
µs a call and each trace's walls, decode rates and TTFTs (lists, one
entry a repetition).  To compare two trees, run them in one machine
alternately (A, B, A, B, ..., each in its own process) and compare within
that call only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def host_us(cfg, calls: int = 2000, tries: int = 5) -> dict:
    """Host µs a call of the projection blocks on one token (CPU tensors of
    ``cfg.reduced()``, no grad): the best of ``tries`` means."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    small = cfg.reduced()
    params = Model(small).init(0, device="cpu")
    attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    ffn = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    x = torch.randn(1, 1, small.d_model)
    blocks = {"qkv": lambda: L._qkv(attn, x, small),
              "swiglu_ffn": lambda: L.swiglu_ffn(ffn, x),
              "lm_logits": lambda: L.lm_logits(params, x, small)}
    out = {}
    with torch.no_grad():
        for name, fn in blocks.items():
            best = float("inf")
            for _ in range(tries):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                best = min(best, (time.perf_counter() - t0) / calls)
            out[name] = best * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs  # noqa: E402  (puts the tree's src/ on the path)
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.tune.cache import TUNING_ENV

    assert cs.__file__.startswith(tree), cs.__file__
    os.environ[TUNING_ENV] = os.path.join(cs.BUILD, "no_tuning_artifact.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    built_s = time.perf_counter() - t0

    host = host_us(cs.get_cfg())
    cfg = cs.get_cfg()
    llama = []
    for _ in range(args.reps):
        row, _, engine, _ = cs.serve_trace(cfg, {"paged": pa_mod}, (0, 1))
        llama.append(row)
        del engine
        torch.cuda.empty_cache()

    qcfg = cs.qwen_cfg()
    qwen = []
    for _ in range(args.reps):
        rng = np.random.default_rng(0)
        prompts = [cs.vlm_request(rng, qcfg, g, t) if g else
                   rng.integers(0, qcfg.vocab_size, t, dtype=np.int32)
                   for g, t in cs.COHORT_TRACE]
        qwen.append(cs.serve_cohort(qcfg, prompts, cs.COHORT_NEW,
                                    {"paged": pa_mod, "ssd": ssd_mod}))
        torch.cuda.empty_cache()
    keys = ("wall_s", "decode_tok_s", "ttft_p50_s", "ttft_max_s")
    print(json.dumps({
        "label": args.label, "tree": tree, "card": smi, "build_s": built_s,
        "host_us": host,
        "llama_paged": {k: [r[k] for r in llama] for k in keys},
        "qwen_cohort": {k: [r[k] for r in qwen]
                        for k in keys + ("decode_step_ms_p50",)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
