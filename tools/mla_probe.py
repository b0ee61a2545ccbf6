#!/usr/bin/env python3
"""Where the time of paged attention's mla body goes at DeepSeek-V2's
shapes.

    python3 tools/mla_probe.py        # on a machine with a CUDA card

At deepseek-v2-236b's paged MLA call -- 128 query heads over the one
576-wide latent, K = V, 96-token pages, bf16; decode: 8 rows at
``chip_smoke.DECODE_LENS``; prefill: 96 rows at 961..1056 over one table,
the inputs ``chip_smoke.py`` phase 15 times -- it prints, for each shape:

  * the plan (splits, cluster blocks, token tile, ring stages);
  * the device ms of the call (``chip_smoke.cuda_ms``: CUDA events, the
    card asleep while the host queues the calls) at each of ``SPLITS``
    splits of a (row, head tile), the plan's among them, cold (the calls
    cycle 16 pool copies, as layers do: the latent is not in L2) and warm
    (one pool, whose 3.66 MB stay in L2);
  * ``torch.profiler`` over 20 calls at the plan: every device activity
    by name (one kernel: the splits merge in their cluster);

and, at decode, the merge on its own: the call at each split count over
rows of one token (one tile a row, so the other splits hold no key and
the call is mostly the cluster's merge of 128 x 576 float32 partials
through distributed shared memory) beside one split, and, for the
workspace merge the body no longer runs, the float32 partials' bytes
written and read once by a device copy (``Tensor.copy_``, cold and warm):
the least that merge would move through device memory.  With the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

#: Splits of a (row, head tile) timed beside the plan's: 8 at 128 heads
#: makes clusters of 16 blocks (non-portable).
SPLITS = (1, 2, 4, 8)


def case(shape: str, t: int, lens=None) -> dict:
    lens = lens or (cs.DECODE_LENS if shape == "decode" else
                    tuple(range((1024 // t) * t + 1,
                                (1024 // t) * t + t + 1)))
    c = cs.make_case(torch.bfloat16, lens, t, shape == "prefill",
                     cs.LAYER_COPIES, cfg=cs.deepseek_cfg())
    c["lens"] = lens
    return c


def split_pages_for(n_pages: int, splits: int) -> int:
    """The wrapper's ``split_pages`` that gives ``splits`` splits."""
    return -(-n_pages // splits)


def call_ms(c: dict, t: int, split_pages, warm: bool) -> float:
    from repro_torch.kernels.paged_attention import paged_attention

    q, kp, table, lengths = c["q"], c["k"], c["table"], c["lengths"]

    def run(i):
        pool = kp[0 if warm else i % cs.LAYER_COPIES]
        paged_attention(q, pool, pool, table, lengths, page_tokens=t,
                        split_pages=split_pages)

    return cs.cuda_ms(run)


def workspace_floor_ms(rows: int, heads: int, splits: int) -> dict:
    """A device copy of the float32 partials a workspace merge would write
    and read again (rows x splits x heads x 576), cold (16 buffers) and
    warm (one)."""
    n = rows * splits * heads * 576
    src = [torch.empty(n, device="cuda") for _ in range(cs.LAYER_COPIES)]
    dst = torch.empty(n, device="cuda")
    out = {"bytes": 2 * 4 * n}
    for name, pick in (("cold", lambda i: src[i % cs.LAYER_COPIES]),
                       ("warm", lambda i: src[0])):
        out[f"{name}_ms"] = round(cs.cuda_ms(
            lambda i, pick=pick: dst.copy_(pick(i))), 5)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import (mla_split_plan,
                                                     mla_tile,
                                                     paged_attention)
    from repro_torch.serve.engine import plan_decode

    cfg = cs.deepseek_cfg()
    t = plan_decode(cfg, max_len=cs.MAX_LEN, batch=cs.MAX_SLOTS,
                    dtype_bytes=2).page_plan()["page_tokens"]
    print(f"card: {cs.smi_line()}; page {t}", flush=True)
    for shape in ("decode", "prefill"):
        c = case(shape, t)
        q, kp, table, lengths = c["q"], c["k"], c["table"], c["lengths"]
        n_pages = table.shape[1]
        splits, cluster = mla_split_plan(q.shape[0], 1, q.shape[1], n_pages,
                                         t)
        tile, stages = mla_tile(t)
        row = {"planned": {"splits": splits, "cluster": cluster,
                           "tile": tile, "stages": stages}}
        for z in sorted(set(SPLITS) | {splits}):
            sp = split_pages_for(n_pages, z)
            for warm in (False, True):
                key = f"{'warm' if warm else 'cold'}_ms@{z}"
                try:
                    row[key] = round(call_ms(c, t, sp, warm), 5)
                except (RuntimeError, ValueError) as e:   # a cluster of 16
                    row[key] = f"refused: {e}"            # may not launch
        row["profile"] = cs.kernel_us(
            lambda: paged_attention(q, kp[0], kp[0], table, lengths,
                                    page_tokens=t), reps=20)
        print(f"{shape}: " + json.dumps(row), flush=True)
    # The merge alone: one-token rows, so each (row, head tile) has one
    # tile and the other splits only merge.
    c = case("decode", t, lens=(1,) * len(cs.DECODE_LENS))
    n_pages = c["table"].shape[1]
    merge = {}
    for z in SPLITS:
        try:
            merge[f"cold_ms@{z}"] = round(
                call_ms(c, t, split_pages_for(n_pages, z), False), 5)
        except (RuntimeError, ValueError) as e:
            merge[f"cold_ms@{z}"] = f"refused: {e}"
    merge["workspace_copy"] = {
        z: workspace_floor_ms(len(cs.DECODE_LENS), 128, z) for z in SPLITS}
    print("merge: " + json.dumps(merge), flush=True)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
