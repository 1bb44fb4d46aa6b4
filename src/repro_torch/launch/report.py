"""Render a saved extraction-plan report as Markdown.

    PYTHONPATH=src python -m repro_torch.launch.report PLAN.json

``PLAN.json`` is a :class:`~repro_torch.core.cost.PlanReport` written by
:func:`~repro_torch.core.serialize.save_plan_report` (either package's:
the format is shared).  :func:`render_plan_report` gives the JAX
package's text for the same report.  The JAX package's module also
renders its dry-run and roofline tables; those wait for the port's
``launch`` cells.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

__all__ = ["fmt_bytes", "render_plan_report", "main"]


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _fmt_cfg(cfg: Dict) -> str:
    spill = f"spill(arity={cfg['merge_arity']})" if cfg["spill"] else "no-spill"
    fused = "fused" if cfg["fuse_correction"] else "unfused"
    return (
        f"{cfg['n_shards']}-shard {cfg['partition']} {spill} "
        f"pack={cfg['pack_method']} {fused}"
    )


def render_plan_report(doc: Dict) -> str:
    """Markdown for one extraction-plan report (a
    :class:`repro_torch.core.cost.PlanReport` JSON dict): the chosen knobs,
    predicted vs. available bytes and wall time, the top ranked
    alternatives, and why each pruned plan lost."""
    chosen = doc["chosen"]
    cfg, cost = chosen["config"], chosen["cost"]
    cap = doc.get("budget_bytes")
    avail = fmt_bytes(cap) if cap is not None else "unbounded"
    rows_cap = doc.get("budget_rows")
    rows_avail = str(rows_cap) if rows_cap is not None else "unbounded"
    lines = [
        "## Extraction plan",
        "",
        f"rules: {'; '.join(doc['rules'])}" if doc.get("rules") else "rules: (none)",
        f"configurations enumerated: {doc['n_enumerated']} "
        f"({len(doc['ranked'])} feasible, {len(doc['pruned'])} pruned)",
        "",
        f"**chosen:** {_fmt_cfg(cfg)}",
        "",
        f"- predicted wall time: {cost['wall_s'] * 1e3:.3f} ms",
        f"- predicted peak bytes: {fmt_bytes(cost['peak_bytes'])} "
        f"(assembly account {fmt_bytes(cost['peak_assembly_bytes'])} "
        f"vs available {avail})",
        f"- predicted peak resident rows: {cost['peak_resident_rows']} "
        f"(budget {rows_avail})",
        f"- expected condensed edges: {cost['est_edges']:.0f}",
        "",
        "### Ranked alternatives",
        "",
        "| config | predicted wall | peak bytes | vs chosen |",
        "|---|---|---|---|",
    ]
    for r in doc["ranked"][:4]:
        delta = (r["cost"]["wall_s"] - cost["wall_s"]) * 1e3
        tag = "**chosen**" if r["config"] == cfg else f"+{delta:.3f} ms"
        lines.append(
            "| {c} | {w:.3f} ms | {b} | {t} |".format(
                c=_fmt_cfg(r["config"]), w=r["cost"]["wall_s"] * 1e3,
                b=fmt_bytes(r["cost"]["peak_bytes"]), t=tag,
            )
        )
    lines += ["", "### Pruned plans", ""]
    if doc["pruned"]:
        lines += ["| config | why it lost |", "|---|---|"]
        for p in doc["pruned"][:3]:
            lines.append(f"| {_fmt_cfg(p['config'])} | {p['reason']} |")
        if len(doc["pruned"]) > 3:
            lines.append(f"| ... | {len(doc['pruned']) - 3} more |")
    else:
        lines.append("(none)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("plan", help="a plan report written by save_plan_report")
    args = ap.parse_args(argv)
    with open(args.plan) as f:
        print(render_plan_report(json.load(f)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
