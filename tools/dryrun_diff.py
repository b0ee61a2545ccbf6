#!/usr/bin/env python3
"""Two dry runs' reports side by side, cell by cell: per-rank FLOPs,
collective bytes (the operand bytes ``collective_bytes`` books, and
``collective_result_bytes``, what each collective hands back: an
all-gather's gathered tensor), traced peak, and the all-gathers whose
operand is a shard of the mLSTM state ``C`` or of the embedding table.

    python3 tools/dryrun_diff.py OLD_DIR NEW_DIR

Each directory holds the JSON reports ``python -m repro_torch.launch.dryrun
--out DIR`` writes (one a cell); cells in both are compared.  A ``C``
shard is a 4- or 5-dim operand whose last dim is the cell's mLSTM head
dim; a table shard a 2-dim operand whose first dim is the padded vocab
over a power of two, with ``d_model`` or a power-of-two share of it
after.  All figures are host-traced counts of one rank under
``FakeTensorMode``, never a card's.
"""

from __future__ import annotations

import json
import os
import sys


def _load(d: str) -> dict:
    return {f: json.load(open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def _gathers(rep: dict, cfg) -> dict:
    """The report's all-gather operand shapes that are ``C`` or table
    shards (``collective_shapes`` holds each shape once)."""
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.xlstm import _round128

    out = {"C": [], "table": []}
    v = padded_vocab(cfg)
    dh = None
    if cfg.xlstm is not None:
        dh = _round128(cfg.xlstm.mlstm_proj_factor * cfg.d_model) \
            // cfg.n_heads
    parts = [2 ** i for i in range(10)]
    for kind, shape in rep.get("collective_shapes", []):
        if kind != "all-gather":
            continue
        if dh and len(shape) in (4, 5) and shape[-1] == dh:
            out["C"].append(shape)
        if len(shape) == 2 and any(shape[0] * p == v for p in parts) \
                and any(shape[1] * p == cfg.d_model for p in parts):
            out["table"].append(shape)
    return out


def main(argv=None) -> int:
    from repro_torch.configs import get_model_config

    old_dir, new_dir = (argv or sys.argv[1:])[:2]
    old, new = _load(old_dir), _load(new_dir)
    rows = {}
    for name in sorted(set(old) & set(new)):
        a, b = old[name], new[name]
        if a.get("status") != "ok" or b.get("status") != "ok":
            rows[name] = {"status": [a.get("status"), b.get("status")]}
            continue
        cfg = get_model_config(a["arch"])
        row = {}
        for side, rep in (("old", a), ("new", b)):
            row[side] = {
                "flops": rep["flops"],
                "collective_bytes": sum(rep["collective_bytes"].values()),
                "collective_bytes_by_kind": rep["collective_bytes"],
                "collective_result_bytes": sum(rep.get(
                    "collective_result_bytes", {}).values()) or None,
                "peak_bytes": rep["memory"]["peak_bytes"],
                "collective_s": rep["roofline"]["collective_s"],
                "gathers": _gathers(rep, cfg)}
        for k in ("flops", "collective_bytes", "collective_result_bytes",
                  "peak_bytes"):
            if row["old"][k] is not None and row["new"][k] is not None:
                row[f"{k}_change"] = row["new"][k] - row["old"][k]
        rows[name] = row
        print(name)
        for side in ("old", "new"):
            r = row[side]
            print(f"  {side}: flops={r['flops']:.6g} "
                  f"collective={r['collective_bytes']:.6g} "
                  f"result={r['collective_result_bytes'] or 0:.6g} "
                  f"peak={r['peak_bytes']} "
                  f"collective_s={r['collective_s']:.4g} "
                  f"C-gathers={r['gathers']['C']} "
                  f"table-gathers={r['gathers']['table']}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
