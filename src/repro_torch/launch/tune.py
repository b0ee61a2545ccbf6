"""Run the port's tuning sweeps end to end (the counterpart of
``repro-tune``).

``python -m repro_torch.launch.tune [--quick] [--dry] [--kernels a,b] ...``
For each kernel the harness takes the port planner's analytic block as the
sweep centre, enumerates the aligned neighbourhood, filters it with the
planner's own working-set model (what the kernel puts in one block's
shared memory, and what it keeps in registers), times the survivors on the
card (CUDA events around warmed-up calls), and merges the winners into the
port's tuning artifact (``$REPRO_TORCH_TUNING``, else
``experiments/tuning_torch.json``) under the card's fingerprint, which the
planner then consults with precedence analytic < tuned.

``--dry`` stops after enumeration and filtering: no device, no timing, no
write; it runs on a machine without a card.  Exit code 1 when a candidate
breaks its budget.
"""

from __future__ import annotations

import argparse
import sys


def print_report(results) -> bool:
    """Print each sweep's candidates, times and winner; True when every
    candidate fits its budget."""
    all_fit = True
    for r in results:
        print(f"[tune] {r.kernel} bucket={r.bucket} center={r.center} "
              f"candidates={len(r.candidates)} rejected={r.rejected} "
              f"budget={r.budget_bytes}")
        for c in sorted(r.candidates, key=lambda c: c.label):
            all_fit &= c.est_vmem_bytes <= r.budget_bytes
            tm = f"{c.median_us:10.1f}us" if c.median_us is not None else \
                "      (dry)"
            mark = " <- analytic" if c.block == r.center else ""
            print(f"[tune]   {c.label:<40s} est={c.est_vmem_bytes:>10d} "
                  f"{tm}{mark}")
        if r.entry is not None:
            e = r.entry
            print(f"[tune]   winner {dict(e.block)} median={e.median_us}us "
                  f"analytic={e.analytic_us}us speedup={e.speedup}x")
    return all_fit


def main(argv=None) -> int:
    from repro_torch.tune.cache import hw_fingerprint, tuning_path
    from repro_torch.tune.sweep import SWEEPS, run_sweeps

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tune",
        description="neighbourhood sweep around the plan's analytic tiles")
    ap.add_argument("--kernels", default="all",
                    help=f"comma-separated subset of {','.join(SWEEPS)} "
                         f"or 'all'")
    ap.add_argument("--quick", action="store_true",
                    help="smaller stock workloads")
    ap.add_argument("--dry", action="store_true",
                    help="enumerate + filter only; no timing, no artifact "
                         "write")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="artifact path (default: the REPRO_TORCH_TUNING "
                         "env override, else experiments/tuning_torch.json)")
    ap.add_argument("--no-write", action="store_true",
                    help="time the sweep but do not persist winners")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    kernels = (None if args.kernels == "all"
               else [k.strip() for k in args.kernels.split(",") if k.strip()])
    results = run_sweeps(kernels=kernels, quick=args.quick, dry=args.dry,
                         warmup=args.warmup, iters=args.iters,
                         out_path=args.out, write=not args.no_write)

    all_fit = print_report(results)
    print(f"[tune] all_candidates_fit_smem={all_fit}")
    if args.dry:
        print("[tune] dry run: nothing timed, nothing written")
    elif args.no_write:
        print("[tune] --no-write: winners not persisted")
    else:
        print(f"[tune] wrote {args.out or tuning_path()} "
              f"(fingerprint {hw_fingerprint()})")
    return 0 if all_fit else 1


if __name__ == "__main__":
    sys.exit(main())
