"""Interactive HTML call-graph export for `--graph`
(capability parity: mythril/analysis/callgraph.py:220 — generate_graph; the
reference renders through jinja2 + vis.js from a CDN. This build inlines a
dependency-free HTML template: the graph data is embedded as JSON and drawn on
a <canvas> with a small static force layout, so the artifact opens offline).

The port's copy of mythril_tpu/analysis/callgraph.py."""

from __future__ import annotations

import html
import json

from .traceexplore import get_serializable_statespace

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>call graph — {title}</title>
<style>
 body {{ margin:0; font-family: monospace; background:#111; color:#eee; }}
 #info {{ position:fixed; top:0; right:0; width:34%; height:100%;
         overflow:auto; background:#1b1b1b; padding:8px;
         border-left:1px solid #333; white-space:pre; font-size:12px; }}
 canvas {{ display:block; }}
</style>
</head>
<body>
<canvas id="c"></canvas><div id="info">click a node…</div>
<script>
const GRAPH = {graph_json};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const W = () => canvas.width = innerWidth * 0.65;
const H = () => canvas.height = innerHeight;
W(); H();
const nodes = GRAPH.nodes.map((n, i) => Object.assign({{}}, n, {{
  x: 60 + (i % 8) * (canvas.width - 120) / 8 + Math.random() * 30,
  y: 40 + Math.floor(i / 8) * 90 + Math.random() * 20, vx: 0, vy: 0 }}));
const byId = Object.fromEntries(nodes.map(n => [n.id, n]));
const edges = GRAPH.edges.filter(e => byId[e.from] && byId[e.to]);
for (let iter = 0; iter < {physics_iters}; iter++) {{
  for (const e of edges) {{
    const a = byId[e.from], b = byId[e.to];
    const dx = b.x - a.x, dy = b.y - a.y;
    const d = Math.hypot(dx, dy) || 1, f = (d - 90) * 0.01;
    a.vx += f * dx / d; a.vy += f * dy / d;
    b.vx -= f * dx / d; b.vy -= f * dy / d;
  }}
  for (const n of nodes) {{
    n.x = Math.max(20, Math.min(canvas.width - 20, n.x + n.vx));
    n.y = Math.max(20, Math.min(canvas.height - 20, n.y + n.vy));
    n.vx *= 0.85; n.vy *= 0.85;
  }}
}}
function draw() {{
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  ctx.strokeStyle = '#555';
  for (const e of edges) {{
    const a = byId[e.from], b = byId[e.to];
    ctx.beginPath(); ctx.moveTo(a.x, a.y); ctx.lineTo(b.x, b.y); ctx.stroke();
    const ang = Math.atan2(b.y - a.y, b.x - a.x);
    ctx.beginPath();
    ctx.moveTo(b.x - 10 * Math.cos(ang - 0.4), b.y - 10 * Math.sin(ang - 0.4));
    ctx.lineTo(b.x, b.y);
    ctx.lineTo(b.x - 10 * Math.cos(ang + 0.4), b.y - 10 * Math.sin(ang + 0.4));
    ctx.stroke();
  }}
  for (const n of nodes) {{
    ctx.fillStyle = n.color || '#6c54de';
    ctx.beginPath(); ctx.arc(n.x, n.y, 8, 0, 7); ctx.fill();
    ctx.fillStyle = '#ccc';
    ctx.fillText(n.truncLabel || n.id, n.x + 10, n.y + 3);
  }}
}}
draw();
canvas.onclick = (ev) => {{
  const r = canvas.getBoundingClientRect();
  const x = ev.clientX - r.left, y = ev.clientY - r.top;
  for (const n of nodes) if (Math.hypot(n.x - x, n.y - y) < 10) {{
    document.getElementById('info').textContent =
      'node ' + n.id + '  (' + n.func + ')\\n\\n' + n.code.join('\\n');
    return;
  }}
}};
onresize = () => {{ W(); H(); draw(); }};
</script>
</body>
</html>
"""


def generate_graph(statespace, title: str = "mythril-tpu call graph",
                   physics: bool = False) -> str:
    graph = get_serializable_statespace(statespace)
    return _TEMPLATE.format(
        title=html.escape(title),
        graph_json=json.dumps(graph),
        physics_iters=300 if physics else 60,
    )
