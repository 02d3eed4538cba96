"""A copy of `shifu_tpu/eval/gain_chart.py`, writing through the port's
`fileio.atomic_write`. The original docstring follows.

Gain / PR-ROC chart export — self-contained HTML + CSV.

Replaces `core/eval/GainChart.java:31` + `GainChartTemplate`: the
reference emits an HTML file with embedded chart JS and a CSV of the
bucketed performance points. Here the HTML embeds the points as JSON
and draws with inline SVG — no external assets, same
open-in-a-browser experience.
"""

from __future__ import annotations

import json
import os
from typing import Dict

from shifu_tpu_torch.fileio import atomic_write


def write_csv(path: str, perf: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = ["actionRate", "recall", "weightedRecall", "liftUnit",
            "liftWeight", "binLowestScore"]
    with atomic_write(path) as f:
        f.write(",".join(cols) + "\n")
        for row in perf["gains"]:
            f.write(",".join(f"{row.get(c, 0.0):.6f}" for c in cols) + "\n")


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;margin:24px}}svg{{border:1px solid #ccc;
margin:8px}}.lbl{{font-size:12px;fill:#444}}</style></head>
<body><h2>{title}</h2>
<div id="charts"></div>
<script>
const PERF = {perf_json};
function chart(title, pts, xk, yk) {{
  const W=420,H=320,P=44;
  const xs=pts.map(p=>p[xk]), ys=pts.map(p=>p[yk]);
  const xmax=Math.max(...xs,1e-9), ymax=Math.max(...ys,1e-9);
  let path="";
  pts.forEach((p,i)=>{{
    const x=P+(W-2*P)*p[xk]/xmax, y=H-P-(H-2*P)*p[yk]/ymax;
    path+=(i? "L":"M")+x.toFixed(1)+","+y.toFixed(1);
  }});
  return `<svg width="${{W}}" height="${{H}}">
    <text x="${{W/2}}" y="16" text-anchor="middle">${{title}}</text>
    <line x1="${{P}}" y1="${{H-P}}" x2="${{W-P}}" y2="${{H-P}}" stroke="#888"/>
    <line x1="${{P}}" y1="${{P}}" x2="${{P}}" y2="${{H-P}}" stroke="#888"/>
    <text class="lbl" x="${{W-P}}" y="${{H-P+16}}" text-anchor="end">${{xk}} (max ${{xmax.toFixed(3)}})</text>
    <text class="lbl" x="${{P}}" y="${{P-6}}">${{yk}} (max ${{ymax.toFixed(3)}})</text>
    <path d="${{path}}" fill="none" stroke="#1668c9" stroke-width="2"/>
  </svg>`;
}}
document.getElementById("charts").innerHTML =
  chart("Gain chart (unit)", PERF.gains, "actionRate", "recall") +
  chart("Gain chart (weighted)", PERF.gains, "actionRate", "weightedRecall") +
  chart("ROC  AUC=" + PERF.areaUnderRoc.toFixed(4), PERF.roc, "fpr", "recall") +
  chart("PR  AUC=" + PERF.areaUnderPr.toFixed(4), PERF.pr, "recall", "precision");
</script></body></html>
"""


def write_html(path: str, perf: Dict, title: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with atomic_write(path) as f:
        f.write(_HTML.format(title=title, perf_json=json.dumps(perf)))
