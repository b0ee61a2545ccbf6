"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (``BENCHMARK.json``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, the counts the metrics rest on, and
last the ``checks`` that decided ``correct``, which also end standard
error.  Without the cards, or where the port cannot be imported, or where
JAX or the JAX package was loaded, it exits non-zero and prints no result.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level modules no run may load: JAX, its libraries and the JAX
#: package the port was made from (names compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("USE_FLAX", "0")

    from bench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_PROCESS)
    except harness.NoChip as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for key in [k for k in result if k.startswith("_")]:
        del result[key]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
