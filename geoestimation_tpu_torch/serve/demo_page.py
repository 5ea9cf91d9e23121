"""Self-contained browser demo page for the port's inference server.

The port's own copy of `geoestimation_tpu/serve/demo_page.py`: one HTML page
served at `GET /` with no external assets (no CDN, no tiles, no fonts; the
serving host may have no egress). It posts the raw image to `POST /predict`
and draws the per-partitioning predictions as a table and as markers on an
inline equirectangular SVG graticule. Colors are the Okabe-Ito
colorblind-safe palette.
"""

# p_key display order/colors: hierarchy (the headline f* prediction)
# first and emphasized.
DEMO_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>GeoEstimation demo</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; max-width: 880px;
         margin: 2rem auto; padding: 0 1rem; line-height: 1.45; }
  h1 { font-size: 1.3rem; }
  #drop { border: 2px dashed #888; border-radius: 8px; padding: 2rem;
          text-align: center; cursor: pointer; }
  #drop.hover { border-color: #0072B2; background: rgba(0,114,178,.08); }
  #status { min-height: 1.4em; margin: .6rem 0; }
  .err { color: #D55E00; }
  table { border-collapse: collapse; margin: .8rem 0; }
  td, th { padding: .25rem .7rem; border-bottom: 1px solid #8884;
           text-align: left; font-variant-numeric: tabular-nums; }
  tr.hier td { font-weight: 600; }
  svg { width: 100%; height: auto; display: block; margin-top: .6rem; }
  .swatch { display: inline-block; width: .7em; height: .7em;
            border-radius: 50%; margin-right: .35em; }
  #preview { max-height: 140px; border-radius: 6px; margin-top: .6rem; }
  footer { margin-top: 1.2rem; font-size: .85rem; opacity: .7; }
</style>
</head>
<body>
<h1>GeoEstimation &mdash; photo geolocation demo</h1>
<p>Drop a photo (JPEG/PNG). The server runs the hierarchical S2-cell
classifier on its GPU and returns the predicted location per partitioning;
<b>hierarchy</b> is the combined f* prediction.</p>
<div id="drop" tabindex="0">drop an image here or click to choose
  <input id="file" type="file" accept="image/*" hidden>
  <br><img id="preview" hidden alt="">
</div>
<div id="status"></div>
<div id="out"></div>
<svg id="map" viewBox="0 0 720 360" role="img"
     aria-label="world map with predicted locations">
  <rect x="0" y="0" width="720" height="360" fill="none"
        stroke="#888" stroke-width="1"/>
  <g id="grat" stroke="#888" stroke-opacity="0.35" stroke-width="0.5">
  </g>
  <g id="marks"></g>
</svg>
<footer>equirectangular graticule, 30&deg; spacing; no map tiles are
loaded (offline-first). Server endpoints: POST /predict, GET /healthz,
GET /stats.</footer>
<script>
"use strict";
const COLORS = {hierarchy: "#0072B2", fine: "#E69F00",
                middle: "#009E73", coarse: "#CC79A7"};
const grat = document.getElementById("grat");
for (let lng = -150; lng <= 150; lng += 30) {
  const x = (lng + 180) * 2;
  grat.insertAdjacentHTML("beforeend",
    `<line x1="${x}" y1="0" x2="${x}" y2="360"/>`);
}
for (let lat = -60; lat <= 60; lat += 30) {
  const y = (90 - lat) * 2;
  const w = lat === 0 ? 1.2 : 0.5;
  grat.insertAdjacentHTML("beforeend",
    `<line x1="0" y1="${y}" x2="720" y2="${y}" stroke-width="${w}"/>`);
}
const drop = document.getElementById("drop");
const file = document.getElementById("file");
const status_ = document.getElementById("status");
const out = document.getElementById("out");
const marks = document.getElementById("marks");
const preview = document.getElementById("preview");
drop.addEventListener("click", () => file.click());
drop.addEventListener("dragover", e => {
  e.preventDefault(); drop.classList.add("hover");
});
drop.addEventListener("dragleave", () => drop.classList.remove("hover"));
drop.addEventListener("drop", e => {
  e.preventDefault(); drop.classList.remove("hover");
  if (e.dataTransfer.files.length) predict(e.dataTransfer.files[0]);
});
file.addEventListener("change", () => {
  if (file.files.length) predict(file.files[0]);
});
function order(keys) {
  const pref = ["hierarchy", "fine", "middle", "coarse"];
  return keys.sort((a, b) => {
    const ia = pref.indexOf(a), ib = pref.indexOf(b);
    return (ia < 0 ? 99 : ia) - (ib < 0 ? 99 : ib);
  });
}
async function predict(f) {
  status_.textContent = "predicting…";
  status_.className = "";
  out.innerHTML = ""; marks.innerHTML = "";
  preview.src = URL.createObjectURL(f); preview.hidden = false;
  let resp, body;
  try {
    resp = await fetch("/predict", {method: "POST", body: f});
    body = await resp.json();
  } catch (e) {
    status_.textContent = "request failed: " + e; status_.className = "err";
    return;
  }
  if (!resp.ok) {
    status_.textContent = "server error: " + (body.error || resp.status);
    status_.className = "err";
    return;
  }
  const preds = body.predictions;
  const keys = order(Object.keys(preds));
  let rows = "<table><tr><th></th><th>p_key</th><th>class</th>" +
             "<th>lat</th><th>lng</th></tr>";
  for (const k of keys) {
    const p = preds[k];
    const c = COLORS[k] || "#56B4E9";
    rows += `<tr class="${k === "hierarchy" ? "hier" : ""}">` +
      `<td><span class="swatch" style="background:${c}"></span></td>` +
      `<td>${k}</td><td>${p.class}</td>` +
      `<td>${p.lat.toFixed(4)}</td><td>${p.lng.toFixed(4)}</td></tr>`;
    const x = (p.lng + 180) * 2, y = (90 - p.lat) * 2;
    const r = k === "hierarchy" ? 6 : 4;
    marks.insertAdjacentHTML("beforeend",
      `<circle cx="${x}" cy="${y}" r="${r}" fill="${c}" ` +
      `fill-opacity="0.85" stroke="#fff" stroke-width="1">` +
      `<title>${k}: ${p.lat.toFixed(3)}, ${p.lng.toFixed(3)}</title>` +
      `</circle>`);
  }
  out.innerHTML = rows + "</table>";
  status_.textContent = "done";
}
</script>
</body>
</html>
"""
