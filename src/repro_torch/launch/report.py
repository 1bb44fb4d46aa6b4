"""Render a saved extraction-plan report, or the dry-run and roofline
tables of ``results/dryrun_torch``, as Markdown.

    PYTHONPATH=src python -m repro_torch.launch.report PLAN.json
    PYTHONPATH=src python -m repro_torch.launch.report --mesh single

``PLAN.json`` is a :class:`~repro_torch.core.cost.PlanReport` written by
:func:`~repro_torch.core.serialize.save_plan_report` (either package's:
the format is shared).  :func:`render_plan_report` gives the JAX
package's text for the same report.  Without a plan, the records that
:mod:`repro_torch.launch.dryrun` wrote are rendered: a summary, the
dry-run table (peak bytes, FLOPs and collective bytes per rank, both the
reference's ICI / DCI split and the H100 NVLink / network split) and the
roofline table, for one mesh.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

__all__ = ["RESULTS_DIR", "fmt_bytes", "render_plan_report", "load_all", "dryrun_table",
           "roofline_table", "summary", "render", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def load_all(results_dir: str = RESULTS_DIR) -> List[Dict]:
    out = []
    if not os.path.isdir(results_dir):
        return out
    for f in sorted(os.listdir(results_dir)):
        if f.endswith(".json"):
            with open(os.path.join(results_dir, f)) as fh:
                out.append(json.load(fh))
    return out


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


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    rows = [
        "| arch | shape | chips | peak HBM/chip | flops/chip | ICI B/chip | DCI B/chip "
        "| NVLink B/chip | network B/chip | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok") or r.get("mesh") != mesh:
            continue
        peak = r["memory_stats"]["peak_bytes_per_device"]
        rows.append(
            "| {arch} | {shape} | {chips} | {peak} | {fl:.2e} | {ici} | {dci} | {nv} | {net} "
            "| {t:.0f} |".format(
                arch=r["arch"], shape=r["shape"], chips=r["n_chips"], peak=fmt_bytes(peak),
                fl=r["flops_per_device"], ici=fmt_bytes(r["ici_bytes"]),
                dci=fmt_bytes(r["dci_bytes"]), nv=fmt_bytes(r.get("nvlink_bytes", 0.0)),
                net=fmt_bytes(r.get("network_bytes", 0.0)),
                t=r.get("lower_s", 0) + r.get("compile_s", 0),
            )
        )
    return "\n".join(rows)


def roofline_table(recs: List[Dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | MODEL_FLOPS "
        "| useful ratio |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok") or r.get("mesh") != mesh:
            continue
        rows.append(
            "| {arch} | {shape} | {c:.4f} | {m:.4f} | {k:.4f} | **{dom}** | {mf:.2e} "
            "| {ur:.3f} |".format(
                arch=r["arch"], shape=r["shape"], c=r["compute_s"], m=r["memory_s"],
                k=r["collective_s"], dom=r["dominant"], mf=r["model_flops"],
                ur=r["useful_ratio"],
            )
        )
    return "\n".join(rows)


def summary(recs: List[Dict]) -> str:
    ok = [r for r in recs if r.get("ok")]
    fail = [r for r in recs if not r.get("ok")]
    doms: Dict[str, int] = {}
    for r in ok:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    lines = [
        f"cells passed: {len(ok)}; failed: {len(fail)}",
        f"dominant-term distribution: {doms}",
    ]
    for r in fail:
        lines.append(f"  FAILED {r.get('arch')}x{r.get('shape')}x{r.get('mesh')}: "
                     f"{r.get('error', '')[:80]}")
    return "\n".join(lines)


def render(mesh: str, results_dir: str = RESULTS_DIR) -> str:
    recs = load_all(results_dir)
    return "\n".join([
        "## Summary", "", summary(recs), "",
        f"## Dry-run ({mesh} mesh)", "", dryrun_table(recs, mesh), "",
        f"## Roofline ({mesh} mesh)", "", roofline_table(recs, mesh), "",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("plan", nargs="?", help="a plan report written by save_plan_report")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "host"],
                    help="without a plan: the dry-run records of this mesh")
    ap.add_argument("--results", default=RESULTS_DIR, help="the dry-run records' directory")
    args = ap.parse_args(argv)
    if args.plan is None:
        print(render(args.mesh, args.results))
        return 0
    with open(args.plan) as f:
        print(render_plan_report(json.load(f)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
