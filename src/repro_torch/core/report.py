"""Markdown / CSV / JSON emitters for IRM results."""
from __future__ import annotations

import json
from typing import Dict, List, Sequence


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


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)
