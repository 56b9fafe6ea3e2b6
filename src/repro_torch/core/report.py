"""Markdown / CSV / JSON emitters for roofline + IRM results."""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

from repro_torch.core.roofline import RooflineTerms
from repro_torch.core.step_census import Census


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def markdown_table(rows: Sequence[Dict[str, object]],
                   columns: Sequence[str] = ()) -> str:
    if not rows:
        return "(no rows)"
    cols = list(columns) if columns else list(rows[0].keys())
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(_fmt(r.get(c, "")) for c in cols) + " |")
    return "\n".join(lines)


def csv_lines(rows: Sequence[Dict[str, object]],
              columns: Sequence[str] = ()) -> List[str]:
    if not rows:
        return []
    cols = list(columns) if columns else list(rows[0].keys())
    out = [",".join(cols)]
    for r in rows:
        out.append(",".join(_fmt(r.get(c, "")) for c in cols))
    return out


def census_summary(c: Census) -> Dict[str, object]:
    return {
        "flops": c.flops,
        "tc_flops": c.tc_flops,
        "tc_flops_f32": c.tc_flops_f32,
        "warp_flops": c.warp_flops,
        "hbm_bytes": c.hbm_bytes,
        "layout_bytes": c.layout_bytes,
        "irregular_bytes": c.irregular_bytes,
        "tc_issues": c.tc_issues,
        "tc_flops_padded": c.tc_flops_padded,
        "warp_issues": c.warp_issues,
        "scalar_ops": c.scalar_ops,
        "collective_wire_bytes": c.collective_wire_bytes,
        "collectives": {k: {"count": v.count,
                            "operand_bytes": v.operand_bytes,
                            "wire_bytes": v.wire_bytes}
                        for k, v in sorted(c.collectives.items())},
        "top_opcodes": dict(sorted(c.opcode_counts.items(),
                                   key=lambda kv: -kv[1])[:12]),
        # the GEMM mix: "op flops-of-one" -> [count, total FLOPs], largest
        # total first
        "top_tc_ops": {f"{op} {f}": [n, n * f] for (op, f), n in sorted(
            c.tc_op_flops.items(), key=lambda kv: -kv[0][1] * kv[1])[:32]},
    }


def roofline_markdown(terms: Iterable[RooflineTerms]) -> str:
    rows = []
    for t in terms:
        rows.append({
            "cell": t.name,
            "devs": t.n_devices,
            "compute_ms": t.compute_s * 1e3,
            "memory_ms": t.memory_s * 1e3,
            "collective_ms": t.collective_s * 1e3,
            "dominant": t.dominant,
            "modeled_ms": t.modeled_time_s * 1e3,
            "useful_flops": (f"{t.useful_flops_ratio:.2f}"
                             if t.useful_flops_ratio else "-"),
            "MFU": f"{t.mfu_vs_peak*100:.1f}%",
        })
    return markdown_table(rows)


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)
