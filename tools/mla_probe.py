#!/usr/bin/env python3
"""Where the time of paged attention's mla body goes at DeepSeek-V2's
shapes.

    python3 tools/mla_probe.py        # on a machine with a CUDA card

At deepseek-v2-236b's paged MLA call -- 128 query heads over the one
576-wide latent, K = V, 96-token pages, bf16; decode: 8 rows at
``chip_smoke.DECODE_LENS``; prefill: 96 rows at 961..1056 over one table,
the inputs ``chip_smoke.py`` phase 15 times -- it prints, for each shape:

  * the device ms of the wrapper call (``chip_smoke.cuda_ms``: CUDA
    events, the card asleep while the host queues the calls) at the split
    plan's pages per split and at others;
  * the device ms of the same launches made through the C entry point
    with the output and workspace allocated once (so the wrapper's checks
    and allocations are out of the loop);
  * ``torch.profiler`` over 20 wrapper calls: every device activity by
    name, the sum of their times, and the span from the first one's start
    to the last one's end (span minus sum is time the card ran none);

with the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

SPLITS = (1, 2, 4, 8, 43)


def case(shape: str, t: int) -> dict:
    lens = cs.DECODE_LENS if shape == "decode" else \
        tuple(range((1024 // t) * t + 1, (1024 // t) * t + t + 1))
    c = cs.make_case(torch.bfloat16, lens, t, shape == "prefill",
                     cs.LAYER_COPIES, cfg=cs.deepseek_cfg())
    c["lens"] = lens
    return c


def raw_ms(c: dict, t: int, split_pages: int) -> float:
    """The mla launches through the C entry point, output and workspace
    allocated once."""
    from repro_torch.kernels import paged_attention as pa

    q, kp, table, lengths = c["q"], c["k"], c["table"], c["lengths"]
    s, h, d = q.shape
    n_pages = table.shape[1]
    splits = -(-n_pages // split_pages)
    out = torch.empty_like(q)
    ws = [None, None]
    if splits > 1:
        acc, ml = pa.split_workspace(s, 1, splits, h, d)
        ws = [torch.empty(acc, device=q.device), torch.empty(ml,
                                                             device=q.device)]
    fn = pa._kernel()[0]
    stream = torch.cuda.current_stream().cuda_stream

    def run(i):
        pool = kp[i % cs.LAYER_COPIES]
        rc = fn(q.data_ptr(), pool.data_ptr(), pool.data_ptr(),
                table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                0 if ws[0] is None else ws[0].data_ptr(),
                0 if ws[1] is None else ws[1].data_ptr(),
                s, h, 1, d, t, n_pages, pool.shape[0], 0,
                1.0 / math.sqrt(d), splits, split_pages, 1, 2,
                q.device.index, stream)
        assert rc == 0, rc

    return cs.cuda_ms(run)


def profiled(c: dict, t: int, reps: int = 20) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.paged_attention import paged_attention

    q, kp, table, lengths = c["q"], c["k"], c["table"], c["lengths"]

    def run(i):
        pool = kp[i % cs.LAYER_COPIES]
        paged_attention(q, pool, pool, table, lengths, page_tokens=t)

    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            run(i)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.time_range.elapsed_us() / reps
    busy = sum(e.time_range.elapsed_us() for e in dev) / reps
    span = ((max(e.time_range.end for e in dev)
             - min(e.time_range.start for e in dev)) / reps) if dev else 0.0
    return {"device_us_by_name": {k: round(v, 3) for k, v in
                                  by_name.items()},
            "activities": len(dev), "busy_us": round(busy, 3),
            "span_us": round(span, 3)}


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import (mla_split_plan,
                                                     paged_attention)
    from repro_torch.serve.engine import plan_decode

    cfg = cs.deepseek_cfg()
    t = plan_decode(cfg, max_len=cs.MAX_LEN, batch=cs.MAX_SLOTS,
                    dtype_bytes=2).page_plan()["page_tokens"]
    print(f"card: {cs.smi_line()}; page {t}", flush=True)
    for shape in ("decode", "prefill"):
        c = case(shape, t)
        q, kp, table, lengths = c["q"], c["k"], c["table"], c["lengths"]
        planned = mla_split_plan(q.shape[0], 1, q.shape[1], table.shape[1],
                                 t)
        row = {"planned": {"splits": planned[0], "split_pages": planned[1]}}
        for sp in sorted(set(SPLITS) | {planned[1]}):
            def run(i, sp=sp):
                pool = kp[i % cs.LAYER_COPIES]
                paged_attention(q, pool, pool, table, lengths,
                                page_tokens=t, split_pages=sp)
            row[f"wrapper_ms@{sp}"] = round(cs.cuda_ms(run), 5)
            row[f"raw_ms@{sp}"] = round(raw_ms(c, t, sp), 5)
        row["profile"] = profiled(c, t)
        print(f"{shape}: " + json.dumps(row), flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
