"""Self-contained HTML bird's-eye-view trajectory artifact (host numpy
and JSON).

Port of veloslam_tpu/utils/viewer.py, byte-equal output on equal inputs
(tests/test_torch_apps.py): one HTML file with the session's trajectory,
INS prior, keyframes, loop closures, landmarks and map occupancy embedded
as JSON and rendered on a canvas, openable anywhere with no server and no
external resource.

Interaction: time scrubber (replays the drive), hover tooltip on the
nearest trajectory sample, theme toggle (light/dark from the same
validated palette), legend, and a table view of the trajectory for
accessibility.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def _traj_rows(res: Dict) -> list:
    rows = []
    t0 = int(res["times_us"][0]) if len(res["times_us"]) else 0
    for i in range(len(res["times_us"])):
        rows.append({
            "t": round((int(res["times_us"][i]) - t0) * 1e-6, 3),
            "x": round(float(res["positions"][i][0]), 3),
            "y": round(float(res["positions"][i][1]), 3),
        })
    return rows


def write_bev_html(path: str, results: Dict, *,
                   ins_xy: Optional[np.ndarray] = None,
                   ins_t_us: Optional[np.ndarray] = None,
                   landmarks_xy: Optional[np.ndarray] = None,
                   occupancy_xy: Optional[np.ndarray] = None,
                   closures: Optional[list] = None,
                   title: str = "veloslam_tpu session") -> str:
    """Write the BEV artifact; returns `path`.

    `results` is SlamPipeline.results() / StreamingOdometry.run() output
    (times_us, positions, optionally keyframe_positions).  Optional
    layers: the INS prior track, landmark posts (N, 2), map-occupancy
    cell centers (N, 2), and loop-closure index pairs.
    """
    traj = _traj_rows(results)
    kf = results.get("keyframe_positions")
    data = {
        "title": title,
        "traj": traj,
        "kf": ([[round(float(x), 3), round(float(y), 3)]
                for x, y, *_ in np.asarray(kf)] if kf is not None
               and len(kf) else []),
        "ins": ([[round(float(x), 3), round(float(y), 3)]
                 for x, y in np.asarray(ins_xy)[:, :2]]
                if ins_xy is not None and len(ins_xy) else []),
        "marks": ([[round(float(x), 3), round(float(y), 3)]
                   for x, y in np.asarray(landmarks_xy)[:, :2]]
                  if landmarks_xy is not None and len(landmarks_xy)
                  else []),
        "occ": ([[round(float(x), 2), round(float(y), 2)]
                 for x, y in np.asarray(occupancy_xy)[:, :2]]
                if occupancy_xy is not None and len(occupancy_xy)
                else []),
        "closures": closures or [],
        "stats": {
            "frames": int(results.get("n_frames", len(traj))),
            "keyframes": int(results.get("n_keyframes", 0)),
            "closures": int(results.get("n_closures", 0)),
            "registered": round(float(
                results.get("registered_fraction", 0.0)), 3),
            "map_patches": int(results.get("map_patches", 0)),
        },
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path


# Palette roles: series-1 blue = estimate, series-2 orange = INS prior,
# series-3 aqua = landmarks, series-7 violet = loop closures (distinct
# geometry: chords, not points).  Occupancy is a neutral sequential wash.
_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>veloslam_tpu BEV</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e4e2dc; --axis: #b5b3ab;
  --est: #2a78d6; --ins: #eb6834; --mark: #1baf7a; --close: #4a3aa7;
  --occ: #52514e;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #262624;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #32312e; --axis: #565550;
    --est: #3987e5; --ins: #d95926; --mark: #199e70; --close: #9085e9;
    --occ: #c3c2b7;
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --surface-1: #1a1a19; --surface-2: #262624;
  --text-primary: #ffffff; --text-secondary: #c3c2b7;
  --grid: #32312e; --axis: #565550;
  --est: #3987e5; --ins: #d95926; --mark: #199e70; --close: #9085e9;
  --occ: #c3c2b7;
}
body { margin: 0; }
.viz-root { background: var(--surface-1); color: var(--text-primary);
  font: 13px/1.45 system-ui, sans-serif; min-height: 100vh; padding: 16px; }
h1 { font-size: 15px; margin: 0 0 2px; }
.sub { color: var(--text-secondary); margin-bottom: 10px; }
.row { display: flex; gap: 16px; align-items: center; flex-wrap: wrap;
  margin-bottom: 8px; }
.legend { display: flex; gap: 14px; flex-wrap: wrap; }
.legend span { display: inline-flex; align-items: center; gap: 6px;
  color: var(--text-secondary); }
.sw { width: 14px; height: 3px; border-radius: 2px; display: inline-block; }
.dot { width: 9px; height: 9px; border-radius: 50%; display: inline-block; }
canvas { background: var(--surface-1); border: 1px solid var(--grid);
  border-radius: 6px; display: block; max-width: 100%; }
.stats { display: flex; gap: 20px; margin: 10px 0; }
.stat b { display: block; font-size: 17px; }
.stat span { color: var(--text-secondary); }
#tip { position: fixed; pointer-events: none; background: var(--surface-2);
  color: var(--text-primary); border: 1px solid var(--axis);
  border-radius: 5px; padding: 5px 8px; display: none; z-index: 3; }
button, input[type=range] { accent-color: var(--est); }
button { background: var(--surface-2); color: var(--text-primary);
  border: 1px solid var(--axis); border-radius: 5px; padding: 3px 10px;
  cursor: pointer; }
table { border-collapse: collapse; margin-top: 10px; }
td, th { border: 1px solid var(--grid); padding: 2px 9px;
  color: var(--text-secondary); text-align: right; }
th { color: var(--text-primary); }
</style></head>
<body><div class="viz-root">
<h1 id="title"></h1>
<div class="sub">bird's-eye view — estimate vs INS prior · drag the
scrubber to replay</div>
<div class="stats" id="stats"></div>
<div class="row">
  <input id="scrub" type="range" min="0" max="1000" value="1000"
         style="flex:1; min-width:200px">
  <span id="tlabel" class="sub" style="margin:0"></span>
  <button id="theme">theme</button>
  <button id="tableBtn">table</button>
</div>
<div class="row legend" id="legend"></div>
<canvas id="c" width="1100" height="700"></canvas>
<div id="tip"></div>
<div id="table" style="display:none"></div>
<script>
const D = __DATA__;
document.getElementById('title').textContent = D.title;
const S = D.stats;
document.getElementById('stats').innerHTML = [
  ['frames', S.frames], ['keyframes', S.keyframes],
  ['loop closures', S.closures],
  ['registered', (100 * S.registered).toFixed(0) + '%'],
  ['map patches', S.map_patches]
].map(([k, v]) => `<div class="stat"><b>${v}</b><span>${k}</span></div>`)
 .join('');
const css = n => getComputedStyle(document.querySelector('.viz-root'))
  .getPropertyValue(n).trim();
function legend() {
  const items = [['est', '--est', 'line', 'estimated trajectory']];
  if (D.ins.length) items.push(['ins', '--ins', 'line', 'INS prior']);
  if (D.marks.length) items.push(['mark', '--mark', 'dot', 'landmark posts']);
  if (D.closures.length) items.push(['close', '--close', 'line',
                                     'loop closures']);
  if (D.occ.length) items.push(['occ', '--occ', 'dot', 'map occupancy']);
  document.getElementById('legend').innerHTML = items.map(
    ([k, v, kind, label]) => `<span><i class="${kind === 'dot' ? 'dot' : 'sw'}"
     style="background:${css(v)}"></i>${label}</span>`).join('');
}
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const all = D.traj.concat(D.ins.map(p => ({x: p[0], y: p[1]})))
  .concat(D.occ.map(p => ({x: p[0], y: p[1]})));
let xs = all.map(p => p.x), ys = all.map(p => p.y);
if (!xs.length) { xs = [0, 1]; ys = [0, 1]; }
const pad = 30;
const x0 = Math.min(...xs) - 2, x1 = Math.max(...xs) + 2;
const y0 = Math.min(...ys) - 2, y1 = Math.max(...ys) + 2;
const sc = Math.min((cv.width - 2 * pad) / (x1 - x0),
                    (cv.height - 2 * pad) / (y1 - y0));
const X = x => pad + (x - x0) * sc;
const Y = y => cv.height - pad - (y - y0) * sc;
const tmax = D.traj.length ? D.traj[D.traj.length - 1].t : 0;
function draw(frac) {
  ctx.clearRect(0, 0, cv.width, cv.height);
  // grid every 10 m
  ctx.strokeStyle = css('--grid'); ctx.lineWidth = 1;
  ctx.fillStyle = css('--axis'); ctx.font = '10px system-ui';
  for (let gx = Math.ceil(x0 / 10) * 10; gx <= x1; gx += 10) {
    ctx.beginPath(); ctx.moveTo(X(gx), Y(y0)); ctx.lineTo(X(gx), Y(y1));
    ctx.stroke(); ctx.fillText(gx + ' m', X(gx) + 2, cv.height - 8);
  }
  for (let gy = Math.ceil(y0 / 10) * 10; gy <= y1; gy += 10) {
    ctx.beginPath(); ctx.moveTo(X(x0), Y(gy)); ctx.lineTo(X(x1), Y(gy));
    ctx.stroke(); ctx.fillText(gy + ' m', 4, Y(gy) - 3);
  }
  // occupancy wash (neutral, faint)
  ctx.globalAlpha = 0.16; ctx.fillStyle = css('--occ');
  for (const [mx, my] of D.occ)
    ctx.fillRect(X(mx) - 1.5, Y(my) - 1.5, 3, 3);
  ctx.globalAlpha = 1;
  // landmark posts
  ctx.fillStyle = css('--mark');
  for (const [mx, my] of D.marks) {
    ctx.beginPath(); ctx.arc(X(mx), Y(my), 3.2, 0, 7); ctx.fill();
  }
  const tcut = frac * tmax;
  // INS prior
  if (D.ins.length) {
    ctx.strokeStyle = css('--ins'); ctx.lineWidth = 2; ctx.beginPath();
    D.ins.forEach(([px, py], i) =>
      i ? ctx.lineTo(X(px), Y(py)) : ctx.moveTo(X(px), Y(py)));
    ctx.stroke();
  }
  // loop closures (chords between keyframes)
  ctx.strokeStyle = css('--close'); ctx.lineWidth = 1.5;
  for (const [i, j] of D.closures) {
    if (i < D.kf.length && j < D.kf.length) {
      ctx.beginPath(); ctx.moveTo(X(D.kf[i][0]), Y(D.kf[i][1]));
      ctx.lineTo(X(D.kf[j][0]), Y(D.kf[j][1])); ctx.stroke();
    }
  }
  // estimated trajectory up to the scrub time
  ctx.strokeStyle = css('--est'); ctx.lineWidth = 2; ctx.beginPath();
  let last = null;
  D.traj.forEach((p, i) => {
    if (p.t > tcut) return;
    i && last ? ctx.lineTo(X(p.x), Y(p.y)) : ctx.moveTo(X(p.x), Y(p.y));
    last = p;
  });
  ctx.stroke();
  // keyframe markers (rings, 2px surface gap)
  ctx.fillStyle = css('--est');
  ctx.strokeStyle = css('--surface-1'); ctx.lineWidth = 2;
  for (const [kx, ky] of D.kf) {
    ctx.beginPath(); ctx.arc(X(kx), Y(ky), 4.5, 0, 7);
    ctx.fill(); ctx.stroke();
  }
  // vehicle marker at the scrub time
  if (last) {
    ctx.fillStyle = css('--est');
    ctx.strokeStyle = css('--surface-1'); ctx.lineWidth = 2;
    ctx.beginPath(); ctx.arc(X(last.x), Y(last.y), 7, 0, 7);
    ctx.fill(); ctx.stroke();
  }
  document.getElementById('tlabel').textContent =
    't = ' + tcut.toFixed(2) + ' s / ' + tmax.toFixed(2) + ' s';
}
const scrub = document.getElementById('scrub');
scrub.oninput = () => draw(scrub.value / 1000);
const tip = document.getElementById('tip');
cv.onmousemove = e => {
  const r = cv.getBoundingClientRect();
  const mx = (e.clientX - r.left) * cv.width / r.width;
  const my = (e.clientY - r.top) * cv.height / r.height;
  let best = null, bd = 144;           /* 12 px hit radius */
  for (const p of D.traj) {
    const d = (X(p.x) - mx) ** 2 + (Y(p.y) - my) ** 2;
    if (d < bd) { bd = d; best = p; }
  }
  if (best) {
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.innerHTML = `t ${best.t.toFixed(2)} s<br>x ${best.x.toFixed(2)} m
      · y ${best.y.toFixed(2)} m`;
  } else tip.style.display = 'none';
};
cv.onmouseleave = () => tip.style.display = 'none';
document.getElementById('theme').onclick = () => {
  const r = document.documentElement;
  r.dataset.theme = r.dataset.theme === 'dark' ? 'light' : 'dark';
  legend(); draw(scrub.value / 1000);
};
document.getElementById('tableBtn').onclick = () => {
  const el = document.getElementById('table');
  if (el.style.display === 'none') {
    el.style.display = 'block';
    el.innerHTML = '<table><tr><th>t (s)</th><th>x (m)</th><th>y (m)</th>'
      + '</tr>' + D.traj.map(p =>
        `<tr><td>${p.t}</td><td>${p.x}</td><td>${p.y}</td></tr>`).join('')
      + '</table>';
  } else el.style.display = 'none';
};
legend(); draw(1);
</script>
</div></body></html>
"""
