"""The observability layer's command line (the port of ``repro.obs.cli``).

One subcommand:

  python -m repro_torch.obs.cli report [--arch NAME] [--band-lo F]
      [--band-hi F] [--prompts N] [--new N] [--trace out.json]
      [--device cuda|cpu]

Builds a reduced paged engine with the radix prefix cache on one card (or
the CPU with ``--device cpu``), runs a small recorded workload of prompts
sharing a prefix of more than one page through it (the first alone, the
rest hitting what it published), and prints the plan-vs-actual residual table:
one row per level of the decode ``HierarchicalPlan``, pairing the level's
predicted budget (page-table geometry, the page's working set, the HBM
prefix leftover) with the peak the metrics registry observed.  A ratio
outside ``[band-lo, band-hi]`` earns a calibration warning; a pool peak
above the plan's ``pages_total`` exits 1.

``--trace out.json`` also exports the workload's Chrome/Perfetto trace so
a residual can be chased down to the spans that produced it.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.planview import DEFAULT_BAND, format_report, \
    plan_vs_actual


def _run_workload(arch: str, prompts: int, new: int, device=None):
    """A small deterministic paged + prefix workload; returns the engine
    with its registry populated (observed peaks) for the report."""
    import numpy as np

    from repro_torch.configs import get_model_config
    from repro_torch.serve import ServeEngine, ServePolicy

    cfg = get_model_config(arch).reduced()
    engine = ServeEngine(
        cfg, ServePolicy(max_new_tokens=new, max_slots=4, max_len=128,
                         batching="paged", prefix_cache="radix"),
        device=device)
    rng = np.random.default_rng(0)
    # The shared prefix spans at least one page, so the tree holds it and
    # the HBM prefix row observes it; the first prompt is served alone so
    # the others hit the prefix it published.
    shared = rng.integers(0, 256, engine.page.page_tokens + 12,
                          dtype=np.int32)
    reqs = [np.concatenate([shared,
                            rng.integers(0, 256, 4 + i, dtype=np.int32)])
            for i in range(prompts)]
    engine.generate(reqs[:1])
    if reqs[1:]:
        engine.generate(reqs[1:])
    return engine


def cmd_report(args) -> int:
    band = (args.band_lo, args.band_hi)
    engine = _run_workload(args.arch, args.prompts, args.new, args.device)
    rows = plan_vs_actual(engine.plan, engine.obs, band=band)
    print(f"plan-vs-actual: {args.arch} (reduced) on {engine.device}, "
          f"{args.prompts} prompts x {args.new} new tokens")
    print("\n".join(format_report(rows, band=band)))
    if args.trace:
        engine.tracer.export_chrome(args.trace)
        print(f"trace: {len(engine.tracer.export_events())} events "
              f"-> {args.trace}")
    # Exit nonzero when the acceptance bound itself is violated (pool
    # peak above the plan's page_table budget) -- scriptable in CI.
    for r in rows:
        if r["metric"] == "pool_pages" and r["observed"] is not None \
                and r["predicted"] and r["observed"] > r["predicted"]:
            print("ERROR: observed pool peak exceeds the plan's "
                  "page_table budget", file=sys.stderr)
            return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.cli",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="plan-vs-actual residual table for one arch")
    rep.add_argument("--arch", default="llama3.2-1b")
    rep.add_argument("--prompts", type=int, default=3)
    rep.add_argument("--new", type=int, default=6)
    rep.add_argument("--band-lo", type=float, default=DEFAULT_BAND[0])
    rep.add_argument("--band-hi", type=float, default=DEFAULT_BAND[1])
    rep.add_argument("--trace", default="",
                     help="also export the workload's Chrome trace here")
    rep.add_argument("--device", default=None,
                     help="torch device (default: cuda; cpu runs the "
                          "kernels' plain versions)")
    rep.set_defaults(fn=cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
