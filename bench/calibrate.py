"""The readings a cell's ``logit_gap`` limit is set from, on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 15

runs the cell once a seed in one process (the same path as ``run.py``,
each with a short window at the cell's own load) and, on the same sampled
requests, the control: the reference in float8.  One JSON line a seed:
the program's widest and mean gaps, the control's, each side's verdict
under the cell's own limits (``correct``, and ``control_correct``, which
has to come out false), the tokens compared and the end-to-end metrics.
The limit goes between the largest program reading and the smallest
control reading (``checks/<cell>.json``).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from bench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        r = harness.run(args.workload, seed, args.seconds, False, t0,
                        control=True)
        g = r["_gaps"]
        loop, t_start = r["_loop"]
        ticks = [0] * int((max(t for toks in loop.tokens for t, _ in toks)
                           - t_start) // 5 + 1)
        for toks in loop.tokens:
            for t, _ in toks:
                ticks[int((t - t_start) // 5)] += 1
        firsts = [(round(s - t_start, 1), round(toks[0][0] - s, 2))
                  for s, toks in zip(loop.send, loop.tokens)
                  if s is not None and toks]
        print(json.dumps({
            "seed": seed, **g, "correct": r["correct"],
            "control_correct": r["control_correct"],
            "run_s": time.monotonic() - t0, "counts": r["counts"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "peak": r["device"]["memory_peak_bytes"],
            "tokens_per_5s": ticks, "send_ttft": firsts}), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
