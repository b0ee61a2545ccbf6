"""Plan-vs-actual accounting (the port of ``repro.obs.planview``): did
the decomposition the planner predicted match what the runtime observed?

``plan_vs_actual(plan, registry)`` walks the ``HierarchicalPlan`` levels
top-down by ``kind`` and pairs each level's predicted budget with the
observed peak from the engine's metrics registry.  On the H100 hierarchy:

  NVLINK [mesh]      HBM prefix leftover ``plan.prefix_budget()`` vs the
                     radix cache's peak resident bytes
  L2     [container] the level's budget (plan-side)
  SMEM   [page]      two rows: the page_table's ``pages_total`` vs the
                     pool's peak live pages (the acceptance bound: the
                     observed peak must land inside the planned pool), and
                     the SMEM budget vs the double-buffered page working set
  REG    [leaf]      realized per-worker partition vs the register budget
                     (plan-side -- the leaf has no runtime counter)

A DCN level (a fleet plan) would add fleet width: plan ``np`` vs replicas
stood up.  Each row carries ``ratio = observed / predicted``; a ratio
outside the configurable band prints a calibration warning (the planner's
overhead terms are fitted -- a systematic residual means the fit is
stale).  The row names are the reference's (``vmem_working_set`` is the
page level's working set, SMEM here).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.core.plan import PAGE_BUFFERING

#: Default acceptance band for observed/predicted.  The lower edge is 0
#: because under-use is normal at reduced scale (a 3-request demo never
#: fills a 16 GiB HBM budget); the upper edge flags the planner
#: UNDER-predicting, which is the dangerous direction.
DEFAULT_BAND = (0.0, 1.0)

CALIBRATE_HINT = ("plan-vs-actual residual outside band -- the planner's "
                  "fitted overhead terms may be stale; re-fit them: "
                  "`python -m repro_torch.launch.dryrun --calibrate`")


def _row(level: str, kind: str, metric: str, predicted, observed,
         unit: str, src: str, band) -> Dict[str, Any]:
    ratio: Optional[float] = None
    if predicted is not None and observed is not None:
        p = float(predicted)
        o = float(observed)
        ratio = (o / p) if p else (0.0 if o == 0 else math.inf)
    within = (ratio is not None and math.isfinite(ratio)
              and band[0] <= ratio <= band[1])
    return {"level": level, "kind": kind, "metric": metric,
            "predicted": predicted, "observed": observed, "unit": unit,
            "ratio": ratio, "within_band": within, "src": src}


def plan_vs_actual(plan, registry, band=DEFAULT_BAND,
                   fleet: Optional[int] = None) -> List[Dict[str, Any]]:
    """One (or two, for the page level) residual rows per plan level.

    ``registry`` is the engine's ``Registry`` (or any object with a
    compatible ``.value(name, default)``); ``fleet`` is the observed
    replica count for cluster runs (single-engine plans have no DCN
    level, so it usually stays None)."""
    rows: List[Dict[str, Any]] = []
    val = registry.value
    pt = dict(plan.page_table() or {})
    for lp in plan.levels():
        if lp.kind == "mesh" and lp.level == "DCN":
            observed = fleet if fleet is not None \
                else val("fleet_replicas", None)
            rows.append(_row(lp.level, lp.kind, "fleet_replicas",
                             lp.np, observed, "replicas", "runtime", band))
        elif lp.kind == "mesh":
            # Mesh-level HBM leftover: what the planner set aside for
            # cached prefixes after weights + live KV.
            predicted = plan.prefix_budget() or lp.budget_bytes
            observed = val("prefix_peak_resident_bytes",
                           val("prefix_resident_bytes", 0))
            rows.append(_row(lp.level, lp.kind, "hbm_prefix_leftover",
                             predicted, observed, "B", "runtime", band))
        elif lp.kind == "page":
            # The acceptance bound: peak live pages inside the planned
            # pool.  pages_total is the physical pool the plan sized.
            predicted = pt.get("pages_total")
            observed = val("pool_peak_pages", val("peak_pages", 0))
            rows.append(_row(lp.level, lp.kind, "pool_pages",
                             predicted, observed, "pages", "runtime", band))
            # And the working set the page was sized for: the planner
            # guarantees PAGE_BUFFERING * page_bytes <= the level's budget.
            page_bytes = val("page_bytes", None)
            observed_ws = (PAGE_BUFFERING * page_bytes
                           if page_bytes else None)
            rows.append(_row(lp.level, lp.kind, "vmem_working_set",
                             lp.budget_bytes, observed_ws, "B",
                             "runtime", band))
        elif lp.kind == "leaf":
            # No runtime counter at register granularity; the residual
            # is the planner's own realized per-worker partition against
            # the register budget (<= budget whenever the level fits).
            rows.append(_row(lp.level, lp.kind, "leaf_partition",
                             lp.budget_bytes, lp.partition_bytes or 0.0,
                             "B", "plan", band))
        else:
            rows.append(_row(lp.level, lp.kind, "budget",
                             lp.budget_bytes, lp.partition_bytes or None,
                             "B", "plan", band))
    return rows


def format_report(rows: List[Dict[str, Any]],
                  band=DEFAULT_BAND) -> List[str]:
    """Printable report; appends the calibration hint when any row's
    ratio leaves the band."""
    lines = [f"{'level':<6} {'kind':<5} {'metric':<20} "
             f"{'predicted':>14} {'observed':>14} {'ratio':>8}  unit"]
    warn = False
    for r in rows:
        pred = _fmt(r["predicted"])
        obs = _fmt(r["observed"])
        ratio = "n/a" if r["ratio"] is None else f"{r['ratio']:.4f}"
        mark = ""
        if r["ratio"] is not None and not r["within_band"]:
            mark = "  <-- outside band"
            warn = True
        lines.append(f"{r['level']:<6} {r['kind']:<5} {r['metric']:<20} "
                     f"{pred:>14} {obs:>14} {ratio:>8}  {r['unit']}{mark}")
    if warn:
        lines.append(f"WARNING: {CALIBRATE_HINT} "
                     f"(band {band[0]:g}..{band[1]:g})")
    return lines


def _fmt(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.3g}"
    return str(int(v))
