"""Single-page dashboard served at ``/``.

The port's copy of ``polyaxon_tpu/api/dashboard.py``: ``DASHBOARD_HTML`` is
the reference's string, byte for byte.

Parity: the reference's React dashboard (``client/``, 551 TS files — runs
tables, status chips, metric charts, log viewers, per-entity pages, the
experiment-groups sweep pages and run comparison).  This is the embedded
equivalent: one dependency-free HTML page over the REST API — tabs for
runs (with live detail: metric chart, log tail, status history,
stop/restart actions, service links, and a SWEEP panel for groups: trials
table + metric-vs-param scatter off ``/runs?group_id=``), a bookmark-based
run-compare tab (overlaid metric series + last-metric table), accelerator
inventory with packed-chip accounting, projects, saved searches, and the
audit activity feed.

Auth bootstrap is a token FORM (stored in localStorage) rather than a
``?token=`` query parameter — URLs land in browser history and access
logs, so the secret must never ride one (round-3 finding).
"""

DASHBOARD_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>polyaxon-tpu</title>
<style>
  :root { --bg:#101418; --panel:#1a2027; --text:#dde3ea; --dim:#8a949e;
          --accent:#4da3ff; --ok:#3fb950; --bad:#f85149; --warn:#d29922; }
  body { background:var(--bg); color:var(--text);
         font:14px/1.5 -apple-system, 'Segoe UI', Roboto, sans-serif;
         margin:0; padding:24px; }
  h1 { font-size:18px; margin:0 0 12px; }
  h1 span { color:var(--dim); font-weight:normal; }
  h2 { font-size:14px; margin:0 0 8px; color:var(--dim); }
  nav { margin-bottom:16px; }
  nav a { color:var(--dim); margin-right:16px; cursor:pointer;
          text-decoration:none; padding-bottom:4px; }
  nav a.active { color:var(--text); border-bottom:2px solid var(--accent); }
  table { border-collapse:collapse; width:100%; background:var(--panel);
          border-radius:8px; overflow:hidden; }
  th, td { text-align:left; padding:8px 12px; }
  th { color:var(--dim); font-weight:600; border-bottom:1px solid #2a323c; }
  tr.row:hover { background:#222a33; cursor:pointer; }
  .chip { padding:2px 8px; border-radius:10px; font-size:12px; }
  .chip.succeeded { background:#1f3d2b; color:var(--ok); }
  .chip.failed, .chip.upstream_failed { background:#442224; color:var(--bad); }
  .chip.running, .chip.starting, .chip.scheduled { background:#1d3048; color:var(--accent); }
  .chip.stopped, .chip.skipped, .chip.warning, .chip.queued { background:#3a3325; color:var(--warn); }
  .chip.created { background:#2a323c; color:var(--dim); }
  #detail { margin-top:20px; display:none; }
  .panel { background:var(--panel); border-radius:8px; padding:16px; margin-top:12px; }
  pre { margin:0; white-space:pre-wrap; color:var(--dim); max-height:280px; overflow:auto; }
  canvas { width:100%; height:160px; }
  input, select { background:var(--panel); color:var(--text); border:1px solid #2a323c;
          border-radius:6px; padding:6px 10px; margin-bottom:12px; }
  #query { width:340px; }
  button { background:#253141; color:var(--text); border:1px solid #2a323c;
           border-radius:6px; padding:4px 12px; cursor:pointer; margin-right:8px; }
  button:hover { background:#2d3c50; }
  a.svc { color:var(--accent); }
  .dim { color:var(--dim); }
  #login { display:none; margin-bottom:12px; }
  #qwrap { position:relative; display:inline-block; }
  #qsuggest { position:absolute; top:34px; left:0; z-index:10; display:none;
              background:var(--panel); border:1px solid #2a323c; border-radius:6px;
              min-width:340px; max-height:260px; overflow:auto; }
  #qsuggest div { padding:5px 12px; cursor:pointer; }
  #qsuggest div.sel, #qsuggest div:hover { background:#2d3c50; }
  #qsuggest span { color:var(--dim); float:right; margin-left:16px; }
  #logs-state { float:right; font-size:12px; }
</style>
</head>
<body>
<h1>polyaxon-tpu <span id="count"></span></h1>
<div id="login">
  <form onsubmit="saveToken(event)">
    <input id="token-input" type="password" placeholder="API token" autocomplete="off"/>
    <button type="submit">sign in</button>
    <span class="dim">unauthorized — paste a token (stored locally, never in the URL)</span>
  </form>
</div>
<nav>
  <a id="tab-runs" class="active" onclick="showTab('runs')">Runs</a>
  <a id="tab-compare" onclick="showTab('compare')">Compare</a>
  <a id="tab-devices" onclick="showTab('devices')">Devices</a>
  <a id="tab-projects" onclick="showTab('projects')">Projects</a>
  <a id="tab-searches" onclick="showTab('searches')">Searches</a>
  <a id="tab-activity" onclick="showTab('activity')">Activity</a>
  <a id="tab-archives" onclick="showTab('archives')">Archives</a>
  <a id="tab-analytics" onclick="showTab('analytics')">Analytics</a>
</nav>

<div id="view-runs">
  <span id="qwrap">
    <input id="query" placeholder='filter: status:running, metric.loss:<0.5'
           autocomplete="off" />
    <div id="qsuggest"></div>
  </span>
  <table>
    <thead><tr><th>ID</th><th>Kind</th><th>Name</th><th>Project</th>
    <th>Status</th><th>Last metric</th><th>Restarts</th><th>Service</th><th></th></tr></thead>
    <tbody id="runs"></tbody>
  </table>
  <div id="detail">
    <h1 id="detail-title"></h1>
    <div class="panel">
      <button onclick="runAction('stop')">stop</button>
      <button onclick="runAction('restart')">restart</button>
      <button onclick="runAction('resume')">resume</button>
      <button onclick="toggleBookmark()" id="bookmark-btn">bookmark</button>
      <span id="statuses" class="dim"></span>
    </div>
    <div class="panel" id="sweep-panel" style="display:none">
      <h2>Sweep trials <span id="sweep-count"></span></h2>
      <div>
        <select id="sweep-x" onchange="drawSweep()"></select>
        <select id="sweep-y" onchange="drawSweep()"></select>
      </div>
      <canvas id="sweep-chart" width="900" height="200"></canvas>
      <table><thead><tr><th>ID</th><th>Status</th><th>Params</th>
        <th>Last metric</th></tr></thead>
        <tbody id="trials"></tbody></table>
    </div>
    <div class="panel">
      <h2>Metrics
        <select id="view-select" onchange="applyView()"><option value="">(all)</option></select>
        <input id="view-name" placeholder="view name" style="width:110px"/>
        <button onclick="saveView()">save view</button>
      </h2>
      <div id="metric-picks" class="dim"></div>
      <div id="chart-legend" class="dim"></div>
      <canvas id="chart" width="900" height="160"></canvas>
    </div>
    <div class="panel">
      <h2>Logs <span id="logs-state" class="dim"></span></h2>
      <pre id="logs"></pre>
    </div>
  </div>
</div>

<div id="view-compare" style="display:none">
  <div class="panel">
    <h2>Bookmarked runs — last metrics</h2>
    <table><thead id="cmp-head"></thead><tbody id="cmp-rows"></tbody></table>
  </div>
  <div class="panel">
    <h2>Metric over steps <select id="cmp-metric" onchange="drawCompare()"></select></h2>
    <canvas id="cmp-chart" width="900" height="220"></canvas>
    <div id="cmp-legend" class="dim"></div>
  </div>
</div>

<div id="view-devices" style="display:none">
  <table>
    <thead><tr><th>ID</th><th>Name</th><th>Accelerator</th><th>Chips used</th>
    <th>Hosts</th><th>Held by</th></tr></thead>
    <tbody id="devices"></tbody>
  </table>
</div>

<div id="view-projects" style="display:none">
  <table>
    <thead><tr><th>Name</th><th>Runs</th><th>Description</th></tr></thead>
    <tbody id="projects"></tbody>
  </table>
</div>

<div id="view-searches" style="display:none">
  <table>
    <thead><tr><th>Name</th><th>Query</th><th>Owner</th><th></th></tr></thead>
    <tbody id="searches"></tbody>
  </table>
</div>

<div id="view-activity" style="display:none">
  <table>
    <thead><tr><th>When</th><th>Event</th><th>Actor</th><th>Context</th></tr></thead>
    <tbody id="activity"></tbody>
  </table>
</div>

<div id="view-archives" style="display:none">
  <table>
    <thead><tr><th>ID</th><th>Kind</th><th>Name</th><th>Project</th>
    <th>Status</th><th>Archived</th><th></th></tr></thead>
    <tbody id="archives"></tbody>
  </table>
</div>

<div id="view-analytics" style="display:none">
  <div class="panel">
    <h2>Platform summary</h2>
    <div id="analytics-summary"></div>
  </div>
  <div class="panel">
    <h2>Events per day (14d)</h2>
    <table><thead id="analytics-head"></thead><tbody id="analytics-rows"></tbody></table>
  </div>
  <div id="analytics-denied" class="dim" style="display:none">
    analytics are admin-only
  </div>
</div>

<script>
let selected = null;
let selectedKind = null;
let tab = 'runs';
let searchCache = [];
let trialCache = [];
let compareCache = [];   // [{run, series: {metric: [[step, v], ...]}}]
// Bearer token lives in localStorage only — never in the URL (history +
// access-log leak). The login form below populates it on 401.
const TOKEN = localStorage.getItem('px_token');
const HDRS = TOKEN ? {Authorization: 'Bearer ' + TOKEN} : {};
const apiFetch = (url, opts) => fetch(url, {...(opts||{}), headers: HDRS});
const esc = s => String(s ?? '').replace(/[&<>"']/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const names = {};
const fmtMetric = m => Object.entries(m||{}).filter(([k])=>!k.startsWith('sys/'))
  .map(([k,v])=>`${esc(k)}=${typeof v==='number'?v.toPrecision(4):esc(v)}`).join(' ');
const fmtTs = t => new Date(t*1000).toLocaleTimeString();
const COLORS = ['#4da3ff','#3fb950','#d29922','#f85149','#bc8cff','#56d4dd'];

function saveToken(ev) {
  ev.preventDefault();
  const v = document.getElementById('token-input').value.trim();
  if (v) { localStorage.setItem('px_token', v); location.reload(); }
}

function showTab(name) {
  tab = name;
  for (const t of ['runs','compare','devices','projects','searches',
                   'activity','archives','analytics']) {
    document.getElementById('view-'+t).style.display = t===name?'block':'none';
    document.getElementById('tab-'+t).className = t===name?'active':'';
  }
  refresh();
}

async function refresh() {
  // Capture the tab before awaiting: a mid-flight tab switch must not
  // render this payload into another tab's table.
  const t = tab;
  if (t === 'runs') return refreshRuns();
  if (t === 'compare') return refreshCompare();
  if (t === 'archives') return refreshArchives();
  if (t === 'analytics') return refreshAnalytics();
  const resp = await apiFetch('/api/v1/' + (t === 'activity' ? 'activities' : t));
  if (!resp.ok) return authNote(resp);
  if (t !== tab) return;
  const data = (await resp.json()).results;
  if (t === 'devices')
    document.getElementById('devices').innerHTML = data.map(d => `
      <tr><td>${Number(d.id)}</td><td>${esc(d.name)}</td><td>${esc(d.accelerator)}</td>
      <td>${Number(d.used_chips||0)}/${Number(d.chips)}</td><td>${Number(d.num_hosts)}</td>
      <td>${(d.holders||[]).length ? (d.holders||[]).map(h=>'#'+Number(h)).join(' ')
          : '<span class="dim">free</span>'}</td></tr>`).join('');
  if (t === 'projects')
    document.getElementById('projects').innerHTML = data.map(p => `
      <tr><td>${esc(p.name)}</td><td>${Number(p.num_runs)}</td>
      <td class="dim">${esc(p.description||'')}</td></tr>`).join('');
  if (t === 'searches') {
    // Index-addressed buttons: names are arbitrary user strings and must
    // never be interpolated into inline JS (quote-breakout XSS).
    searchCache = data;
    document.getElementById('searches').innerHTML = data.map((s, i) => `
      <tr><td>${esc(s.name)}</td><td class="dim">${esc(s.query)}</td>
      <td class="dim">${esc(s.owner||'')}</td>
      <td><button onclick="runSearchIdx(${Number(i)})">run</button></td></tr>`).join('');
  }
  if (t === 'activity')
    document.getElementById('activity').innerHTML = data.map(a => `
      <tr><td class="dim">${fmtTs(a.created_at)}</td><td>${esc(a.event_type)}</td>
      <td>${esc(a.context.actor||'')}</td>
      <td class="dim">${esc(Object.entries(a.context).filter(([k])=>k!=='actor')
        .map(([k,v])=>k+'='+v).join(' '))}</td></tr>`).join('');
}

async function refreshArchives() {
  const resp = await apiFetch('/api/v1/archives');
  if (!resp.ok) return authNote(resp);
  if (tab !== 'archives') return;
  const data = (await resp.json()).results;
  document.getElementById('archives').innerHTML = data.map(r => `
    <tr><td>${Number(r.id)}</td><td>${esc(r.kind)}</td><td>${esc(r.name||'')}</td>
    <td>${esc(r.project)}</td>
    <td><span class="chip ${esc(r.status)}">${esc(r.status)}</span></td>
    <td class="dim">${new Date(r.archived_at*1000).toLocaleString()}</td>
    <td>
      <button onclick="archiveAction(${Number(r.id)}, 'restore')">restore</button>
      <button onclick="archiveAction(${Number(r.id)}, 'delete')">delete</button>
    </td></tr>`).join('')
    || '<tr><td class="dim" colspan="7">nothing archived</td></tr>';
}

async function archiveAction(id, action) {
  let resp;
  if (action === 'delete') {
    // Deletion purges rows, outputs, and store artifacts — unrecoverable.
    if (!confirm(`Permanently delete run #${id} and all its data?`)) return;
    resp = await apiFetch(`/api/v1/runs/${id}`, {method: 'DELETE'});
  } else {
    resp = await apiFetch(`/api/v1/runs/${id}/restore`, {method: 'POST'});
  }
  if (!resp.ok) {
    const err = await resp.json().catch(() => ({}));
    alert(`${action} failed: ${err.error || resp.status}`);
  }
  refreshArchives();
}

let analyticsLast = 0;
async function refreshAnalytics() {
  // Day-granularity data polled by the global 2s loop: throttle to 30s
  // (same cadence as the query vocabulary) — and don't re-issue a 403
  // every tick for non-admins.
  if (Date.now() - analyticsLast < 30000) return;
  analyticsLast = Date.now();
  const resp = await apiFetch('/api/v1/analytics');
  const denied = document.getElementById('analytics-denied');
  if (resp.status === 403) {
    // Clear any aggregates a previously-authorized token rendered.
    document.getElementById('analytics-summary').innerHTML = '';
    document.getElementById('analytics-head').innerHTML = '';
    document.getElementById('analytics-rows').innerHTML = '';
    denied.style.display = 'block';
    return;
  }
  if (!resp.ok) return authNote(resp);
  denied.style.display = 'none';
  if (tab !== 'analytics') return;
  const d = await resp.json();
  const summary = [
    ...Object.entries(d.runs_by_kind).map(([k,v]) => `${esc(k)} runs: <b>${Number(v)}</b>`),
    `users: <b>${Number(d.num_users)}</b>`,
    `projects: <b>${Number(d.num_projects)}</b>`,
    `devices: <b>${Number(d.num_devices)}</b>`,
  ];
  document.getElementById('analytics-summary').innerHTML =
    summary.join(' &nbsp;·&nbsp; ');
  const days = Object.keys(d.events_per_day).sort();
  const types = [...new Set(days.flatMap(day => Object.keys(d.events_per_day[day])))].sort();
  document.getElementById('analytics-head').innerHTML =
    `<tr><th>Day</th>${types.map(t=>`<th>${esc(t)}</th>`).join('')}</tr>`;
  document.getElementById('analytics-rows').innerHTML = days.map(day => `
    <tr><td class="dim">${esc(day)}</td>
    ${types.map(t => `<td>${Number(d.events_per_day[day][t]||0)||''}</td>`).join('')}
    </tr>`).join('') || '<tr><td class="dim">no activity yet</td></tr>';
}

function authNote(resp) {
  if (resp.status === 401) {
    document.getElementById('count').textContent = '— unauthorized';
    document.getElementById('login').style.display = 'block';
  }
}

function runSearchIdx(i) {
  // Execute by plugging the saved query into the filter box — set it
  // BEFORE switching tabs so showTab's implicit refresh already uses it
  // (two racing fetches could otherwise show unfiltered results).
  const s = searchCache[i];
  if (!s) return;
  document.getElementById('query').value = s.query;
  showTab('runs');
}

async function refreshRuns() {
  const q = document.getElementById('query').value.trim();
  const url = '/api/v1/runs' + (q ? '?q=' + encodeURIComponent(q) : '');
  const resp = await apiFetch(url);
  if (!resp.ok) return authNote(resp);
  const data = await resp.json();
  document.getElementById('count').textContent = `— ${data.results.length} runs`;
  document.getElementById('runs').innerHTML = data.results.map(r => {
    names[r.id] = r.name || ('run ' + r.id);
    return `
    <tr class="row" onclick="select(${Number(r.id)}, '${esc(r.kind)}')">
      <td>${Number(r.id)}</td><td>${esc(r.kind)}</td><td>${esc(r.name||'')}</td>
      <td>${esc(r.project)}</td>
      <td><span class="chip ${esc(r.status)}">${esc(r.status)}</span></td>
      <td>${fmtMetric(r.last_metric)}</td><td>${Number(r.restarts)}</td>
      <td>${r.service_url ? `<a class="svc" href="${esc(r.service_url)}"
        target="_blank" onclick="event.stopPropagation()">open</a>` : ''}</td>
      <td><button onclick="event.stopPropagation(); bookmark(${Number(r.id)})">☆</button></td></tr>`;
  }).join('');
  if (selected) await refreshDetail();
}

async function select(id, kind) {
  selected = id;
  selectedKind = kind;
  document.getElementById('detail').style.display = 'block';
  document.getElementById('detail-title').textContent = `#${id} ${names[id]||''}`;
  document.getElementById('sweep-panel').style.display =
    kind === 'group' ? 'block' : 'none';
  if (kind === 'group') {
    // Groups produce no log rows of their own — don't hold a WS tail.
    if (logSocket) { logSocket.onclose = null; logSocket.close(); logSocket = null; }
    document.getElementById('logs').textContent = '';
    document.getElementById('logs-state').textContent = 'sweep (see trials)';
  } else {
    openLogStream(id);
  }
  chartSelection = null;
  document.getElementById('view-select').value = '';
  await loadChartViews();
  await refreshDetail();
}

// Live log tail over the existing WS channel (no polling). The bearer
// token rides a subprotocol — the browser WebSocket API can't set an
// Authorization header, and the token must never enter a URL.
let logSocket = null;
function openLogStream(id) {
  if (logSocket) { logSocket.onclose = null; logSocket.close(); }
  const pre = document.getElementById('logs');
  const state = document.getElementById('logs-state');
  pre.textContent = '';
  state.textContent = 'connecting…';
  const proto = location.protocol === 'https:' ? 'wss://' : 'ws://';
  const url = `${proto}${location.host}/ws/v1/runs/${id}/logs`;
  // Offer the fixed 'bearer' name alongside the token-bearing one: the
  // server selects only 'bearer', so the token never appears in the
  // handshake RESPONSE headers.
  const ws = TOKEN ? new WebSocket(url, ['bearer', 'bearer.' + TOKEN]) : new WebSocket(url);
  logSocket = ws;
  ws.onopen = () => { state.textContent = 'live'; };
  ws.onmessage = ev => {
    const row = JSON.parse(ev.data);
    if (row.event === 'done') { state.textContent = `done (${row.status})`; return; }
    if (row.event === 'deleted') { state.textContent = 'run deleted'; return; }
    if (row.event) return;  // future server frames must not render as text
    const stick = pre.scrollTop + pre.clientHeight >= pre.scrollHeight - 4;
    const prefix = row.process_id != null ? `p${row.process_id}| ` : '';
    pre.textContent += prefix + row.line + '\\n';
    if (stick) pre.scrollTop = pre.scrollHeight;
  };
  ws.onclose = () => {
    // 'connecting…' here means the handshake failed (401/404/refused).
    if (state.textContent === 'live') state.textContent = 'disconnected';
    else if (state.textContent === 'connecting…') state.textContent = 'unavailable';
  };
}

async function runAction(action) {
  if (!selected) return;
  await apiFetch(`/api/v1/runs/${selected}/${action}`, {method:'POST'});
  await refreshRuns();
}

async function bookmark(id) {
  await apiFetch(`/api/v1/runs/${id}/bookmark`, {method:'POST'});
}

async function toggleBookmark() {
  if (selected) await bookmark(selected);
}

async function refreshDetail() {
  // Logs stream over the WS channel (openLogStream); only metrics/
  // statuses/trials poll here.
  const wants = [
    apiFetch(`/api/v1/runs/${selected}/metrics`).then(r=>r.json()),
    apiFetch(`/api/v1/runs/${selected}/statuses`).then(r=>r.json())];
  if (selectedKind === 'group')
    wants.push(apiFetch(`/api/v1/runs?group_id=${selected}&limit=500`).then(r=>r.json()));
  const [metrics, statuses, trials] = await Promise.all(wants);
  document.getElementById('statuses').textContent =
    statuses.results.map(s=>s.status).join(' → ');
  drawChart(metrics.results);
  if (trials) renderSweep(trials.results);
}

function trialParams(r) {
  return (r.spec && r.spec.declarations) || {};
}

function renderSweep(trials) {
  trialCache = trials;
  document.getElementById('sweep-count').textContent = `(${trials.length})`;
  document.getElementById('trials').innerHTML = trials.map(t => `
    <tr><td>${Number(t.id)}</td>
    <td><span class="chip ${esc(t.status)}">${esc(t.status)}</span></td>
    <td class="dim">${esc(Object.entries(trialParams(t))
      .map(([k,v])=>k+'='+v).join(' '))}</td>
    <td>${fmtMetric(t.last_metric)}</td></tr>`).join('');
  // Param/metric axis choices from the union across trials.
  const params = new Set(), metrics = new Set();
  trials.forEach(t => {
    Object.entries(trialParams(t)).forEach(([k,v]) => {
      if (typeof v === 'number') params.add(k);
    });
    Object.entries(t.last_metric||{}).forEach(([k,v]) => {
      if (typeof v === 'number' && !k.startsWith('sys/')) metrics.add(k);
    });
  });
  fillSelect('sweep-x', [...params]);
  fillSelect('sweep-y', [...metrics]);
  drawSweep();
}

function fillSelect(id, options) {
  const el = document.getElementById(id);
  const keep = el.value;
  el.innerHTML = options.map(o => `<option>${esc(o)}</option>`).join('');
  if (options.includes(keep)) el.value = keep;
}

function drawSweep() {
  const xk = document.getElementById('sweep-x').value;
  const yk = document.getElementById('sweep-y').value;
  const c = document.getElementById('sweep-chart'), ctx = c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  if (!xk || !yk) return;
  const pts = trialCache
    .map(t => [trialParams(t)[xk], (t.last_metric||{})[yk], t.status])
    .filter(([x,y]) => typeof x === 'number' && typeof y === 'number');
  if (!pts.length) return;
  const xs = pts.map(p=>p[0]), ys = pts.map(p=>p[1]);
  const xmin = Math.min(...xs), xspan = (Math.max(...xs)-xmin)||1;
  const ymin = Math.min(...ys), yspan = (Math.max(...ys)-ymin)||1;
  ctx.fillStyle = '#8a949e';
  ctx.fillText(`${xk} →`, c.width-80, c.height-6);
  ctx.fillText(`↑ ${yk}`, 6, 14);
  pts.forEach(([x,y,status]) => {
    const px = 40 + (x-xmin)/xspan*(c.width-70);
    const py = c.height-24 - (y-ymin)/yspan*(c.height-44);
    ctx.fillStyle = status === 'succeeded' ? '#3fb950'
      : status === 'failed' ? '#f85149' : '#4da3ff';
    ctx.beginPath(); ctx.arc(px, py, 4, 0, 7); ctx.fill();
  });
  ctx.fillStyle = '#8a949e';
  ctx.fillText(String(ymin.toPrecision(3)), 4, c.height-24);
  ctx.fillText(String((ymin+yspan).toPrecision(3)), 4, 26);
}

async function refreshCompare() {
  const resp = await apiFetch('/api/v1/bookmarks');
  if (!resp.ok) return authNote(resp);
  const runs = (await resp.json()).results.slice(0, 6);
  compareCache = await Promise.all(runs.map(async r => {
    const m = await apiFetch(`/api/v1/runs/${r.id}/metrics`).then(x=>x.json());
    const series = {};
    m.results.forEach((row, i) => Object.entries(row.values).forEach(([k,v]) => {
      if (typeof v==='number' && !k.startsWith('sys/'))
        (series[k] = series[k]||[]).push([row.step ?? i, v]);
    }));
    return {run: r, series};
  }));
  if (tab !== 'compare') return;
  // Last-metric table: one column per metric key in the union.
  const keys = [...new Set(compareCache.flatMap(
    c => Object.keys(c.run.last_metric||{}).filter(k=>!k.startsWith('sys/'))))];
  document.getElementById('cmp-head').innerHTML =
    `<tr><th>Run</th><th>Status</th>${keys.map(k=>`<th>${esc(k)}</th>`).join('')}</tr>`;
  document.getElementById('cmp-rows').innerHTML = compareCache.map(c => `
    <tr><td>#${Number(c.run.id)} ${esc(c.run.name||'')}</td>
    <td><span class="chip ${esc(c.run.status)}">${esc(c.run.status)}</span></td>
    ${keys.map(k => {
      const v = (c.run.last_metric||{})[k];
      return `<td>${typeof v==='number'?esc(v.toPrecision(4)):''}</td>`;
    }).join('')}</tr>`).join('')
    || '<tr><td class="dim">bookmark runs (☆ in the Runs tab) to compare them</td></tr>';
  fillSelect('cmp-metric',
    [...new Set(compareCache.flatMap(c => Object.keys(c.series)))]);
  drawCompare();
}

function drawCompare() {
  const key = document.getElementById('cmp-metric').value;
  const c = document.getElementById('cmp-chart'), ctx = c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  const active = compareCache.filter(x => (x.series[key]||[]).length > 1);
  if (!active.length) return;
  const all = active.flatMap(x => x.series[key]);
  const xmin = Math.min(...all.map(p=>p[0])), xspan = (Math.max(...all.map(p=>p[0]))-xmin)||1;
  const ymin = Math.min(...all.map(p=>p[1])), yspan = (Math.max(...all.map(p=>p[1]))-ymin)||1;
  active.forEach((x, si) => {
    ctx.strokeStyle = COLORS[si%COLORS.length]; ctx.beginPath();
    x.series[key].forEach(([s,v], i) => {
      const px = 40 + (s-xmin)/xspan*(c.width-60);
      const py = c.height-20 - (v-ymin)/yspan*(c.height-40);
      i ? ctx.lineTo(px,py) : ctx.moveTo(px,py);
    });
    ctx.stroke();
  });
  document.getElementById('cmp-legend').innerHTML = active.map((x, si) =>
    `<span style="color:${COLORS[si%COLORS.length]}">■</span> #${Number(x.run.id)} ${esc(x.run.name||'')}`
  ).join(' &nbsp; ');
}

// Saved chart views (reference ChartViewModel): a named metric selection
// per run. chartSelection null = auto (first 6 series).
let chartSelection = null;
let lastChartRows = [];
let chartViews = [];

async function loadChartViews() {
  const resp = await apiFetch(`/api/v1/runs/${selected}/chart_views`);
  if (!resp.ok) { chartViews = []; return; }
  chartViews = (await resp.json()).results;
  const sel = document.getElementById('view-select');
  const keep = sel.value;
  sel.innerHTML = '<option value="">(all)</option>' + chartViews.map(v =>
    `<option value="${Number(v.id)}">${esc(v.name)}</option>`).join('');
  if ([...sel.options].some(o => o.value === keep)) sel.value = keep;
}

function applyView() {
  const id = document.getElementById('view-select').value;
  const view = chartViews.find(v => String(v.id) === id);
  chartSelection = view ? new Set(view.charts) : null;
  drawChart(lastChartRows);
}

async function saveView() {
  const name = document.getElementById('view-name').value.trim();
  if (!selected || !name) return;
  const charts = chartSelection ? [...chartSelection] : [...chartMetricNames];
  await apiFetch(`/api/v1/runs/${selected}/chart_views`, {
    method: 'POST',
    body: JSON.stringify({name, charts}),
  });
  await loadChartViews();
  document.getElementById('view-select').value =
    String((chartViews.find(v => v.name === name)||{}).id ?? '');
}

// Index-addressed (same rule as runSearchIdx): metric names are arbitrary
// user strings and must never be interpolated into inline JS.
let chartMetricNames = [];
function toggleMetricIdx(i) {
  const name = chartMetricNames[i];
  if (name === undefined) return;
  if (!chartSelection) chartSelection = new Set(chartMetricNames);
  if (chartSelection.has(name)) chartSelection.delete(name);
  else chartSelection.add(name);
  document.getElementById('view-select').value = '';
  drawChart(lastChartRows);
}

function drawChart(rows) {
  lastChartRows = rows;
  const c = document.getElementById('chart'), ctx = c.getContext('2d');
  ctx.clearRect(0,0,c.width,c.height);
  // [step, value] series keyed by metric name (step falls back to index).
  const series = {};
  rows.forEach((r, i) => Object.entries(r.values).forEach(([k,v]) => {
    if (typeof v==='number' && !k.startsWith('sys/'))
      (series[k] = series[k]||[]).push([r.step ?? i, v]);
  }));
  // Per-metric toggles (the saved-view building blocks).
  chartMetricNames = Object.keys(series);
  const picks = document.getElementById('metric-picks');
  picks.innerHTML = chartMetricNames.map((k, i) => {
    const on = !chartSelection || chartSelection.has(k);
    return `<label style="margin-right:12px"><input type="checkbox" ` +
      `${on?'checked':''} onchange="toggleMetricIdx(${Number(i)})"/> ${esc(k)}</label>`;
  }).join('');
  const entries = Object.entries(series)
    .filter(([k]) => !chartSelection || chartSelection.has(k))
    .slice(0,6)
    .filter(([,pts]) => pts.length > 1);
  const legend = document.getElementById('chart-legend');
  if (!entries.length) { legend.innerHTML = ''; return; }
  const L = 44, R = 10, Tp = 8, Bm = 22;
  // Shared x (steps); per-series y normalization — ranges live in the
  // legend so mixed scales (loss vs lr) stay readable on one canvas.
  const allx = entries.flatMap(([,pts]) => pts.map(p=>p[0]));
  const xmin = Math.min(...allx), xspan = (Math.max(...allx)-xmin)||1;
  ctx.strokeStyle = '#2a323c';
  ctx.beginPath();
  ctx.moveTo(L, Tp); ctx.lineTo(L, c.height-Bm);
  ctx.lineTo(c.width-R, c.height-Bm); ctx.stroke();
  ctx.fillStyle = '#8a949e';
  ctx.fillText(String(xmin), L, c.height-8);
  ctx.fillText(String(xmin+xspan), c.width-R-30, c.height-8);
  ctx.fillText('step →', (c.width-L)/2, c.height-8);
  entries.forEach(([name, pts], si) => {
    const ys = pts.map(p=>p[1]);
    const min = Math.min(...ys), max = Math.max(...ys), span = (max-min)||1;
    ctx.strokeStyle = COLORS[si%COLORS.length]; ctx.beginPath();
    pts.forEach(([s,v], i) => {
      const x = L + (s-xmin)/xspan*(c.width-L-R);
      const y = c.height-Bm - (v-min)/span*(c.height-Tp-Bm);
      i ? ctx.lineTo(x,y) : ctx.moveTo(x,y);
    });
    ctx.stroke();
  });
  legend.innerHTML = entries.map(([name, pts], si) => {
    const ys = pts.map(p=>p[1]);
    const last = ys[ys.length-1], min = Math.min(...ys), max = Math.max(...ys);
    return `<span style="color:${COLORS[si%COLORS.length]}">■</span> ` +
      `${esc(name)} <b>${esc(last.toPrecision(4))}</b> ` +
      `<span class="dim">[${esc(min.toPrecision(3))} … ${esc(max.toPrecision(3))}]</span>`;
  }).join(' &nbsp; ');
}

// -- query autocomplete off the backend's own grammar ------------------------
let vocab = null;
let suggestSel = -1;
async function loadVocab() {
  try {
    const resp = await apiFetch('/api/v1/query/fields');
    if (resp.ok) vocab = await resp.json();
  } catch (e) { /* autocomplete stays off without the vocabulary */ }
}
function querySuggestions(text) {
  if (!vocab) return [];
  // Complete the segment after the last comma: a bare prefix completes
  // field names; 'status:<prefix>' completes status values.
  const seg = text.slice(text.lastIndexOf(',')+1).trimStart();
  const colon = seg.indexOf(':');
  if (colon >= 0) {
    const field = seg.slice(0, colon), val = seg.slice(colon+1).replace(/^[~]/,'');
    if (field !== 'status') return [];
    return vocab.statuses.filter(s => s.startsWith(val))
      .map(s => ({text: s, hint: 'status', insert: `status:${s}`}));
  }
  const opts = [
    ...vocab.fields.map(f => ({text: f, hint: 'field'})),
    ...vocab.metric_keys.map(k => ({text: `metric.${k}`, hint: 'metric'})),
    ...vocab.param_keys.map(k => ({text: `declarations.${k}`, hint: 'param'})),
  ];
  return opts.filter(o => o.text.startsWith(seg) && o.text !== seg)
    .map(o => ({...o, insert: o.text + ':'}));
}
function renderSuggest() {
  const input = document.getElementById('query');
  const box = document.getElementById('qsuggest');
  const items = querySuggestions(input.value).slice(0, 12);
  if (!items.length) { box.style.display = 'none'; suggestSel = -1; return; }
  if (suggestSel >= items.length) suggestSel = items.length-1;
  box.innerHTML = items.map((o, i) =>
    `<div class="${i===suggestSel?'sel':''}" onmousedown="pickSuggest(${i})">` +
    `${esc(o.text)}<span>${esc(o.hint)}</span></div>`).join('');
  box.style.display = 'block';
  box.dataset.items = JSON.stringify(items);
}
function pickSuggest(i) {
  const box = document.getElementById('qsuggest');
  const items = JSON.parse(box.dataset.items || '[]');
  if (!items[i]) return;
  const input = document.getElementById('query');
  const cut = input.value.lastIndexOf(',')+1;
  const lead = input.value.slice(0, cut) + (cut ? ' ' : '');
  input.value = lead + items[i].insert;
  box.style.display = 'none'; suggestSel = -1;
  input.focus();
  if (items[i].hint === 'status') refreshRuns();
}
{
  const input = document.getElementById('query');
  input.addEventListener('input', () => { suggestSel = -1; renderSuggest(); });
  input.addEventListener('keydown', ev => {
    const box = document.getElementById('qsuggest');
    if (box.style.display !== 'block') return;
    const n = JSON.parse(box.dataset.items || '[]').length;
    if (ev.key === 'ArrowDown') { suggestSel = (suggestSel+1)%n; renderSuggest(); ev.preventDefault(); }
    else if (ev.key === 'ArrowUp') { suggestSel = (suggestSel-1+n)%n; renderSuggest(); ev.preventDefault(); }
    else if (ev.key === 'Tab' || (ev.key === 'Enter' && suggestSel >= 0)) {
      pickSuggest(suggestSel < 0 ? 0 : suggestSel); ev.preventDefault();
    }
    else if (ev.key === 'Escape') { box.style.display = 'none'; }
  });
  input.addEventListener('blur', () =>
    setTimeout(() => document.getElementById('qsuggest').style.display='none', 150));
}
document.getElementById('query').addEventListener('change', refreshRuns);
loadVocab(); setInterval(loadVocab, 30000);
refresh(); setInterval(refresh, 2000);
</script>
</body>
</html>
"""
