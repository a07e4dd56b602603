"""The self-contained live dashboard served at ``GET /``.

One HTML string, zero external assets (the status endpoint must work on an
air-gapped cluster host): inline CSS, inline JS subscribing to the
``/events/stream`` Server-Sent Events feed — ``snapshot`` frames re-render
the page, ``bus`` frames append to the event log — so the page updates on
change instead of hammering the endpoint once a second.  When EventSource
is unavailable or the stream drops, it degrades to the classic
``/metrics`` + ``/events?since=`` 1 s poll.  Layout is stat tiles (the
headline numbers an operator scans first), a nodes table, a jobs table,
and the rolling event log — in the spirit of bndl's dash status panels,
minus the framework.

Design notes: values wear text ink, never a series colour; node/job state
is a coloured dot *plus* the state word (never colour alone); numbers are
tabular-figure monospace so columns don't wobble between refreshes; the
palette holds up in light and dark via ``prefers-color-scheme``.
"""

DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>cluster telemetry</title>
<style>
  :root {
    --bg: #faf9f5; --surface: #ffffff; --ink: #1f1e1d; --ink-2: #5e5d59;
    --ink-3: #8a8984; --line: #e8e6e0; --accent: #2f6cc4;
    --ok: #2e7d43; --warn: #b97d12; --bad: #c03b33;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      --bg: #16151a; --surface: #201f26; --ink: #edecea; --ink-2: #b4b2ac;
      --ink-3: #817f79; --line: #36343d; --accent: #7aa7e8;
      --ok: #6fbf85; --warn: #d9a45b; --bad: #e07a72;
    }
  }
  * { box-sizing: border-box; }
  body { margin: 0; padding: 20px; background: var(--bg); color: var(--ink);
         font: 14px/1.45 system-ui, sans-serif; }
  h1 { font-size: 16px; font-weight: 600; margin: 0 0 4px; }
  .sub { color: var(--ink-3); font-size: 12px; margin-bottom: 16px; }
  .tiles { display: flex; flex-wrap: wrap; gap: 10px; margin-bottom: 18px; }
  .tile { background: var(--surface); border: 1px solid var(--line);
          border-radius: 8px; padding: 10px 14px; min-width: 130px; }
  .tile .v { font: 600 22px/1.2 ui-monospace, monospace;
             font-variant-numeric: tabular-nums; }
  .tile .k { color: var(--ink-2); font-size: 11px; text-transform: uppercase;
             letter-spacing: .04em; margin-top: 2px; }
  h2 { font-size: 12px; font-weight: 600; color: var(--ink-2);
       text-transform: uppercase; letter-spacing: .05em; margin: 18px 0 6px; }
  table { border-collapse: collapse; width: 100%; background: var(--surface);
          border: 1px solid var(--line); border-radius: 8px; overflow: hidden; }
  th, td { text-align: left; padding: 5px 10px; border-top: 1px solid var(--line);
           font-variant-numeric: tabular-nums; }
  th { border-top: 0; color: var(--ink-3); font-size: 11px; font-weight: 600;
       text-transform: uppercase; letter-spacing: .04em; }
  td.num { font-family: ui-monospace, monospace; text-align: right; }
  th.num { text-align: right; }
  .dot { display: inline-block; width: 8px; height: 8px; border-radius: 50%;
         margin-right: 6px; vertical-align: baseline; }
  .st-loaded .dot, .st-registered .dot { background: var(--ok); }
  .st-launching .dot, .st-degraded .dot { background: var(--warn); }
  .st-dead .dot, .st-failed .dot { background: var(--bad); }
  .st-done .dot, .st-replaced .dot { background: var(--ink-3); }
  #events { font: 12px/1.5 ui-monospace, monospace; background: var(--surface);
            border: 1px solid var(--line); border-radius: 8px; padding: 8px 12px;
            max-height: 320px; overflow-y: auto; white-space: pre-wrap; }
  #events .t { color: var(--ink-3); }
  #err { color: var(--bad); font-size: 12px; min-height: 1em; }
</style>
</head>
<body>
<h1>cluster telemetry</h1>
<div class="sub" id="meta">connecting&hellip;</div>
<div id="err"></div>
<div class="tiles" id="tiles"></div>
<h2>nodes</h2>
<div id="nodes"></div>
<h2>jobs</h2>
<div id="jobs"></div>
<h2>histograms</h2>
<div id="hists"></div>
<h2>events</h2>
<div id="events"></div>
<script>
"use strict";
let cursor = 0;
const log = [];
const fmt = n => typeof n === "number"
  ? (Number.isInteger(n) ? n.toLocaleString("en-US") : n.toFixed(1)) : (n ?? "-");
const bytes = n => {
  if (typeof n !== "number") return "-";
  const u = ["B", "KB", "MB", "GB"]; let i = 0;
  while (n >= 1024 && i < u.length - 1) { n /= 1024; i++; }
  return (i ? n.toFixed(1) : n) + " " + u[i];
};
const esc = s => String(s).replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const state = s =>
  `<span class="st-${esc(s)}"><span class="dot"></span>${esc(s)}</span>`;
function tile(v, k) {
  return `<div class="tile"><div class="v">${v}</div><div class="k">${esc(k)}</div></div>`;
}
function table(headers, rows) {
  if (!rows.length) return '<table><tr><td style="color:var(--ink-3)">none</td></tr></table>';
  const h = headers.map(([t, c]) => `<th class="${c || ""}">${esc(t)}</th>`).join("");
  return `<table><tr>${h}</tr>` + rows.map(cells =>
    "<tr>" + cells.map(([v, c]) => `<td class="${c || ""}">${v}</td>`).join("") +
    "</tr>").join("") + "</table>";
}
function render(snap, how) {
  const c = snap.cluster || {};
  const g = snap.gateway;
  document.getElementById("meta").textContent =
    `up ${fmt(Math.round(snap.uptime_s))}s · ${how} ${new Date().toLocaleTimeString()}`;
  document.getElementById("tiles").innerHTML =
    tile(`${fmt(c.nodes_alive ?? 0)}/${fmt(c.nodes_total ?? 0)}`, "nodes alive") +
    tile(fmt(c.jobs_active ?? 0), "jobs active") +
    tile(fmt(c.jobs_completed ?? 0), "jobs completed") +
    tile(fmt(c.items_total ?? 0), "items collected") +
    tile(bytes((c.wire_bytes_sent ?? 0) + (c.wire_bytes_recv ?? 0)), "bytes moved") +
    tile(fmt(c.peer_forwarded ?? 0), "peer forwarded") +
    tile(bytes(c.host_relay_bytes ?? 0), "host relay bytes") +
    tile(fmt(c.redispatched ?? 0), "redispatched") +
    (g ? tile(fmt(g.queued ?? 0), "tickets queued") +
         tile(fmt(g.active ?? 0), "tickets active") +
         tile(`${fmt(c.scale_up_events ?? 0)}/${fmt(c.scale_down_events ?? 0)}`,
              "scale up/down") : "");
  const nodes = Object.entries(snap.nodes || {}).sort();
  document.getElementById("nodes").innerHTML = table(
    [["node"], ["state"], ["items", "num"], ["credits", "num"],
     ["sent", "num"], ["recv", "num"], ["peer out/in", "num"],
     ["blocks p/h", "num"], ["boot ms", "num"], ["cache h/m", "num"]],
    nodes.map(([id, n]) => {
      const w = n.wire || {}, r = n.report || {};
      return [[esc(id)], [state(n.state || "?")], [fmt(n.items), "num"],
        [fmt(n.credits), "num"], [bytes(w.bytes_sent), "num"],
        [bytes(w.bytes_recv), "num"],
        [`${bytes(r.peer_bytes_sent ?? 0)}/${bytes(r.peer_bytes_recv ?? 0)}`, "num"],
        [`${fmt(r.blocks_fetched_from_peers ?? 0)}/${fmt(r.blocks_fetched_from_host ?? 0)}`, "num"],
        [fmt(r.boot_ms), "num"],
        [`${fmt(r.cache_hits ?? 0)}/${fmt(r.cache_misses ?? 0)}`, "num"]];
    }));
  const jobs = Object.entries(snap.jobs || {}).sort((a, b) => a[0] - b[0]);
  document.getElementById("jobs").innerHTML = table(
    [["job"], ["state"], ["prio", "num"], ["pending", "num"],
     ["in flight", "num"], ["collected", "num"], ["dup drops", "num"],
     ["code ship/hit", "num"]],
    jobs.map(([id, j]) => {
      const sum = a => Array.isArray(a) ? a.reduce((x, y) => x + y, 0) : a;
      const st = j.error ? "failed" : (j.done ? "done" : "registered");
      return [[esc(id)], [state(st)], [fmt(j.priority), "num"],
        [fmt(sum(j.pending)), "num"], [fmt(sum(j.inflight)), "num"],
        [fmt(j.items_collected), "num"], [fmt(j.duplicates_dropped), "num"],
        [`${fmt(j.code_shipped ?? 0)}/${fmt(j.code_cached ?? 0)}`, "num"]];
    }));
  const hists = Object.entries(snap.histograms || {}).sort();
  document.getElementById("hists").innerHTML = table(
    [["metric"], ["count", "num"], ["mean", "num"], ["distribution (≤bound: n)"]],
    hists.map(([name, h]) => {
      const mean = h.count ? h.sum / h.count : 0;
      const dist = (h.buckets || [])
        .map(([le, n]) => `≤${le}: ${n}`).join("   ");
      return [[esc(name)], [fmt(h.count), "num"], [fmt(mean), "num"],
        [`<span style="color:var(--ink-2)">${esc(dist)}</span>`]];
    }));
}
function appendEvents(evts) {
  if (!evts.length) return;
  for (const e of evts) {
    cursor = Math.max(cursor, e.seq);
    const extra = Object.entries(e)
      .filter(([k]) => !["seq", "ts", "kind"].includes(k))
      .map(([k, v]) => `${k}=${JSON.stringify(v)}`).join(" ");
    log.push(`<span class="t">${new Date(e.ts * 1000).toLocaleTimeString()}` +
             `</span> ${esc(e.kind)} ${esc(extra)}`);
  }
  while (log.length > 200) log.shift();
  const el = document.getElementById("events");
  el.innerHTML = log.join("\\n");
  el.scrollTop = el.scrollHeight;
}
// Primary transport: the SSE feed pushes snapshots + bus events as they
// happen.  Fallback: the 1 s poll loop, for clients without EventSource
// or when the stream dies and cannot be re-opened.
let pollTimer = null;
async function poll() {
  let snap;
  try {
    snap = await (await fetch("metrics")).json();
    document.getElementById("err").textContent = "";
  } catch (e) {
    document.getElementById("err").textContent = "endpoint unreachable: " + e;
    return;
  }
  render(snap, "polled");
  try {
    const ev = await (await fetch(`events?since=${cursor}`)).json();
    appendEvents(ev.events);
  } catch (e) { /* metrics succeeded; keep the page alive */ }
}
function startPolling() {
  if (pollTimer) return;
  poll();
  pollTimer = setInterval(poll, 1000);
}
function startStream() {
  if (typeof EventSource === "undefined") { startPolling(); return; }
  const es = new EventSource(`events/stream?since=${cursor}`);
  es.addEventListener("snapshot", ev => {
    document.getElementById("err").textContent = "";
    render(JSON.parse(ev.data), "streamed");
  });
  es.addEventListener("bus", ev => appendEvents([JSON.parse(ev.data)]));
  es.onerror = () => {
    es.close();
    document.getElementById("err").textContent =
      "event stream dropped; falling back to polling";
    startPolling();
  };
}
startStream();
</script>
</body>
</html>
"""
