"""Embedded browser UI — the L10 client layer.

Reference: `web/openwebrx/openwebrx.js` + `web/kiwi/*.js` (~32k LoC
JS: spectrum/waterfall canvases, AudioWorklet playback with ADPCM,
tuning UI).  The reference compiles its UI into the server binary
(EDATA_EMBED, `web/web.cpp:49-320`); this module does the idiomatic
equivalent: one self-contained HTML document served at `/`.

The client speaks the same wire protocol (`server/packets.py`):
- `ws://host/{ts}/SND` — auth, `SET mod=... low_cut/high_cut/freq=`,
  IMA-ADPCM compressed audio by DEFAULT (`SET compression=1`, the
  reference's primary wire format `rx/rx_sound.cpp:1121-1139`) with
  an S-meter header on every packet; s16 and IQ-header packets also
  handled per the flags byte.
- `ws://host/{ts}/W/F` — `SET zoom=.. start=..`, 1024-px u8 rows,
  ADPCM-compressed at zoom>0 (flag bit 0x10000, fresh codec state +
  10-byte pad per row, `rx_waterfall.cpp:1625-1628`).

Interaction mirrors openwebrx.js: click to tune, mouse-drag pans the
waterfall, the scroll wheel zooms about the cursor (SET zoom/start
round-trip), slider zoom recenters on the tuned frequency.
"""

from __future__ import annotations

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__NAME__</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#ddd;
        margin:0; padding:12px; }
 h2 { margin:4px 0 10px; font-size:18px; }
 #bar { display:flex; gap:8px; align-items:center; flex-wrap:wrap;
        margin-bottom:8px; }
 button, input, select { background:#222; color:#ddd; border:1px solid
        #555; border-radius:4px; padding:4px 8px; font-size:13px; }
 button.on { background:#2a6; color:#fff; }
 #freq { width:110px; font-size:15px; text-align:right; }
 canvas { display:block; width:1024px; max-width:100%; }
 #smeter { width:160px; height:10px; background:#222;
           border:1px solid #555; border-radius:3px; }
 #smeter > div { height:100%; background:linear-gradient(90deg,#2a6,
           #ff0,#f33); width:0%; border-radius:3px; }
 #stat { font-size:12px; color:#888; margin-top:6px; }
 #labels { position:relative; width:1024px; height:18px;
           background:#181818; overflow:hidden; }
 #labels span { position:absolute; top:1px; font-size:11px;
           color:#0cf; cursor:pointer; white-space:nowrap;
           border-left:1px solid #0cf; padding-left:2px; }
 #labels span:hover { color:#fff; background:#333; }
</style></head><body>
<h2>__NAME__ — SDR</h2>
<div id="bar">
 <button id="audio_btn">start audio</button>
 <input id="freq" value="7100.00"> kHz
 <span id="modes"></span>
 zoom <input id="zoom" type="range" min="0" max="14" value="0"
             style="width:100px">
 <label><input type="checkbox" id="agc" checked> AGC</label>
 <label><input type="checkbox" id="nb"> NB</label>
 <label><input type="checkbox" id="nr"> NR</label>
 <label><input type="checkbox" id="deemp"> de-emp</label>
 sq <input id="sq" type="range" min="0" max="40" value="0"
           style="width:70px">
 <div id="smeter"><div id="smeter_fill"></div></div>
 <span id="smeter_db">-127 dBm</span>
 ext <select id="ext"><option value="">off</option></select>
 camp <select id="camp"><option value="">off</option></select>
 <button id="gps_btn">gps</button>
</div>
<div id="labels"></div>
<canvas id="sky" width="360" height="360"
        style="display:none;width:360px;background:#181818"></canvas>
<canvas id="spec" width="1024" height="80"></canvas>
<canvas id="wf" width="1024" height="360"></canvas>
<!-- per-extension panels (reference: web/extensions/<name>/*.js):
     image canvas (SSTV/FAX), scope canvas (IQ scatter / S-meter
     graph / audio FFT), spot table (WSPR/FT8/FT4), text console -->
<div id="panel" style="display:none">
 <div id="extctl" style="padding:2px 0"></div>
 <canvas id="extimg" width="1024" height="256"
   style="display:none;background:#000;image-rendering:pixelated">
 </canvas>
 <canvas id="extscope" width="360" height="240"
   style="display:none;background:#000;width:360px"></canvas>
 <table id="spots" style="display:none;border-spacing:8px 2px;
   font-size:13px;font-family:monospace"></table>
</div>
<pre id="extout" style="display:none; background:#000; max-height:140px;
 overflow:auto; font-size:12px; width:1008px; padding:8px"></pre>
<div id="stat">connecting…</div>
<script>
"use strict";
const MODES = ["am","sam","usb","lsb","cw","nbfm","iq"];
const PB = { am:[-4900,4900], sam:[-4900,4900], usb:[300,2700],
             lsb:[-2700,-300], cw:[300,700], nbfm:[-6000,6000],
             iq:[-5000,5000] };
const UI_SRATE = __UI_SRATE__;
const AUDIO_RATE = __AUDIO_RATE__;
const EXTENSIONS = __EXTENSIONS__;
const HZ_PER_START = UI_SRATE / (1024 * Math.pow(2, 14));
let freq_khz = 7100.0, mode = "am", zoom = 0;

// URL tuning params (reference: kiwi_util.js parses ?f=7040.00usbz8;
// also accept the explicit ?f=&mode=&z= form)
(function () {
  const q = new URLSearchParams(location.search);
  let f = q.get("f");
  if (f) {
    const m = f.match(/^([\d.]+)([a-z]*?)(?:z(\d+))?$/);
    if (m) {
      freq_khz = parseFloat(m[1]) || freq_khz;
      if (m[2] && PB[m[2]]) mode = m[2];
      if (m[3]) zoom = Math.min(14, parseInt(m[3]));
    }
  }
  if (q.get("mode") && PB[q.get("mode")]) mode = q.get("mode");
  if (q.get("z")) zoom = Math.max(0, Math.min(14, parseInt(q.get("z"))));
})();
let snd_ws = null, wf_ws = null, actx = null, playTime = 0;
let rows = 0, pkts = 0;

// ---- waterfall colormap (black->blue->green->yellow->red->white) ----
const LUT = new Uint8ClampedArray(256 * 3);
for (let i = 0; i < 256; i++) {
  const x = i / 255, s = [[0,0,0],[0,0,96],[0,64,160],[0,160,96],
        [192,192,0],[224,64,0],[255,64,64],[255,255,255]];
  const p = x * (s.length - 1), k = Math.min(Math.floor(p), s.length-2),
        f = p - k;
  for (let c = 0; c < 3; c++)
    LUT[3*i+c] = s[k][c] * (1-f) + s[k+1][c] * f;
}

function ts() { return "kiwi_" + Math.floor(Date.now() / 1000); }
const TS = ts();

// ---- IMA-ADPCM decoder (rx/csdr/ima_adpcm.cpp tables) ----
const ADPCM_STEP = [7,8,9,10,11,12,13,14,16,17,19,21,23,25,28,31,34,37,
  41,45,50,55,60,66,73,80,88,97,107,118,130,143,157,173,190,209,230,253,
  279,307,337,371,408,449,494,544,598,658,724,796,876,963,1060,1166,1282,
  1411,1552,1707,1878,2066,2272,2499,2749,3024,3327,3660,4026,4428,4871,
  5358,5894,6484,7132,7845,8630,9493,10442,11487,12635,13899,15289,16818,
  18500,20350,22385,24623,27086,29794,32767];
const ADPCM_IDX = [-1,-1,-1,-1,2,4,6,8,-1,-1,-1,-1,2,4,6,8];
function adpcmDecode(u8, st, lo, hi) {
  // low nibble first; predictor clamped to [lo, hi]
  const out = new Int32Array(u8.length * 2);
  let pred = st.pred, idx = st.idx;
  for (let i = 0; i < out.length; i++) {
    const nib = (i & 1) ? (u8[i >> 1] >> 4) : (u8[i >> 1] & 0xF);
    const step = ADPCM_STEP[idx];
    let d = step >> 3;
    if (nib & 1) d += step >> 2;
    if (nib & 2) d += step >> 1;
    if (nib & 4) d += step;
    pred = (nib & 8) ? pred - d : pred + d;
    pred = Math.max(lo, Math.min(hi, pred));
    idx = Math.max(0, Math.min(88, idx + ADPCM_IDX[nib]));
    out[i] = pred;
  }
  st.pred = pred; st.idx = idx;
  return out;
}
const sndAdpcm = { pred: 0, idx: 0 };

function setMsg(ws, s) { if (ws && ws.readyState === 1) ws.send("SET " + s); }

function retune() {
  freq_khz = parseFloat(document.getElementById("freq").value) || freq_khz;
  const pb = PB[mode];
  setMsg(snd_ws, "mod=" + mode + " low_cut=" + pb[0] +
         " high_cut=" + pb[1] + " freq=" + freq_khz.toFixed(3));
  document.getElementById("freq").value = freq_khz.toFixed(2);
  retuneWf();
}

let wfCf = null;      // waterfall view center (Hz); null = follow tune
function retuneWf() {
  const span = UI_SRATE / Math.pow(2, zoom);
  let cf = wfCf === null ? freq_khz * 1000 : wfCf;
  cf = Math.max(span / 2, Math.min(cf, UI_SRATE - span / 2));
  if (wfCf !== null) wfCf = cf;
  const start = (cf - span / 2) / HZ_PER_START;
  setMsg(wf_ws, "zoom=" + zoom + " start=" + start.toFixed(0));
  wfLeft = cf - span / 2; wfSpan = span;
  // DX labels for the new span (reference: dx.js MARKER query)
  setMsg(wf_ws, "MARKER db=0 min=" + (wfLeft/1000).toFixed(3) +
         " max=" + ((wfLeft+wfSpan)/1000).toFixed(3) +
         " zoom=" + zoom + " width=1024");
}

const MODE_BY_ID = ["am","amn","usb","lsb","cw","cwn","nbfm","iq",
                    "drm","sam","sal","sau","sas"];
function renderLabels(rows) {
  const box = document.getElementById("labels");
  box.textContent = "";
  rows.forEach((r) => {
    if (!("f" in r)) return;            // skip the type-tag element
    const x = (r.f * 1000 - wfLeft) / wfSpan * 1024;
    if (x < 0 || x >= 1024) return;
    const el = document.createElement("span");
    el.style.left = x.toFixed(0) + "px";
    el.textContent = r.i || r.f.toFixed(1);
    if (r.n) el.title = r.n;
    el.onclick = () => {
      freq_khz = r.f;
      const m = MODE_BY_ID[r.fl] || mode;
      if (m !== mode && PB[m]) {
        mode = m;
        document.querySelectorAll("#modes button").forEach(
            (b) => b.classList.toggle("on", b.id === "mode_" + m));
      }
      document.getElementById("freq").value = freq_khz.toFixed(2);
      retune();
    };
    box.appendChild(el);
  });
}
let wfLeft = 0, wfSpan = UI_SRATE;

// ---------------- SND stream ----------------
function openSnd() {
  snd_ws = new WebSocket("ws://" + location.host + "/" + TS + "/SND");
  snd_ws.binaryType = "arraybuffer";
  snd_ws.onopen = () => {
    setMsg(snd_ws, "auth t=kiwi p=");
    setMsg(snd_ws, "ident_user=webui");
    // ADPCM on: the reference's default wire format
    setMsg(snd_ws, "compression=1");
    sndAdpcm.pred = 0; sndAdpcm.idx = 0;
    retune();
  };
  snd_ws.onmessage = (e) => {
    const u8 = new Uint8Array(e.data);
    const tag = String.fromCharCode(u8[0], u8[1], u8[2]);
    if (tag === "EXT") {           // "EXT <tag> <payload>" (binary-safe)
      let sp = 4;
      while (sp < u8.length && u8[sp] !== 32) sp++;
      const etag = new TextDecoder().decode(u8.subarray(4, sp));
      extDispatch(etag, u8.subarray(sp + 1));
      return;
    }
    if (tag === "MSG") {
      const txt = new TextDecoder().decode(u8.subarray(4));
      const m = txt.match(/audio_dropped=(\d+)/);
      if (m) document.getElementById("stat").textContent =
          "audio: " + m[1] + " packets dropped (slow link)";
      return;
    }
    if (tag !== "SND") return;
    pkts++;
    const dv = new DataView(e.data);
    const flags = u8[3];
    const smeter = dv.getUint16(8, false) / 10 - 127;
    updSmeter(smeter);
    // header: 10 bytes; IQ-mode packets carry a GPS-timestamp header
    // extension (+10 bytes, packets.snd_packet_iq)
    const off = (flags & 0x08) ? 20 : 10;
    let pcm;
    if (flags & 0x10) {            // SND_FLAG_COMPRESSED
      pcm = adpcmDecode(u8.subarray(off), sndAdpcm, -32768, 32767);
    } else {
      const le = !!(flags & 0x80);
      pcm = new Int32Array((u8.length - off) / 2);
      for (let i = 0; i < pcm.length; i++)
        pcm[i] = dv.getInt16(off + 2 * i, le);
    }
    if (actx && !campMode) playPcm(pcm);  // camping mutes own chan
  };
  snd_ws.onclose = () => setTimeout(openSnd, 2000);
}

function playPcm(pcm) {
  const f32 = new Float32Array(pcm.length);
  for (let i = 0; i < pcm.length; i++) f32[i] = pcm[i] / 32768;
  const buf = actx.createBuffer(1, f32.length, AUDIO_RATE);
  buf.copyToChannel(f32, 0);
  const src = actx.createBufferSource();
  src.buffer = buf;
  src.connect(actx.destination);
  if (playTime < actx.currentTime + 0.05)
    playTime = actx.currentTime + 0.15;
  src.start(playTime);
  playTime += buf.duration;
}

// ---------------- per-extension panels ----------------
// (reference: web/extensions/<name>/*.js — image render for
// SSTV/FAX, spot tables for WSPR/FT8/FT4, IQ scatter, S-meter
// graph, audio-FFT display)
let imgLine = 0, smHist = [];
const PANEL_IDS = { img: "extimg", scope: "extscope",
                    spots: "spots" };
function panelShow(which) {        // which: img|scope|spots|null
  Object.entries(PANEL_IDS).forEach(([k, id]) => {
    document.getElementById(id).style.display =
        (k === which) ? "block" : "none";
  });
}
function extText(s) {
  const box = document.getElementById("extout");
  box.textContent = (box.textContent + s + "\n").slice(-4000);
  box.scrollTop = box.scrollHeight;
}
function spotRow(kind, text) {
  panelShow("spots");
  const tb = document.getElementById("spots");
  if (!tb.rows.length) {
    const h = tb.insertRow();
    ["UTC", "type", "message"].forEach((t) => {
      const c = document.createElement("th");
      c.textContent = t; c.style.textAlign = "left"; h.appendChild(c);
    });
  }
  const r = tb.insertRow(1);
  r.insertCell().textContent =
      new Date().toISOString().slice(11, 19);
  r.insertCell().textContent = kind;
  r.insertCell().textContent = text;
  while (tb.rows.length > 21) tb.deleteRow(-1);
}
function drawImgRow(rgba, w) {
  panelShow("img");
  const c = document.getElementById("extimg");
  const g = c.getContext("2d");
  if (imgLine >= c.height) {      // scroll up when full
    g.drawImage(c, 0, 1, w, c.height - 1, 0, 0, w, c.height - 1);
    imgLine = c.height - 1;
  }
  g.putImageData(new ImageData(rgba, w, 1), 0, imgLine);
  imgLine++;
}
function extDispatch(etag, pl) {
  if (etag === "sstv_line") {     // [line u8] + planar RGB rows
    const px = (pl.length - 1) / 3;
    const rgba = new Uint8ClampedArray(px * 4);
    for (let i = 0; i < px; i++) {
      rgba[4*i] = pl[1 + i];              // R plane
      rgba[4*i+1] = pl[1 + px + i];       // G plane
      rgba[4*i+2] = pl[1 + 2*px + i];     // B plane
      rgba[4*i+3] = 255;
    }
    if (pl[0] === 0) { imgLine = 0; }
    drawImgRow(rgba, px);
  } else if (etag === "fax_line") {       // grayscale pixels
    const px = pl.length;
    const rgba = new Uint8ClampedArray(px * 4);
    for (let i = 0; i < px; i++) {
      rgba[4*i] = rgba[4*i+1] = rgba[4*i+2] = pl[i]; rgba[4*i+3] = 255;
    }
    drawImgRow(rgba, px);
  } else if (etag === "iq") {             // f32le (re,im) pairs
    panelShow("scope");
    const g = document.getElementById("extscope").getContext("2d");
    g.fillStyle = "rgba(0,0,0,0.25)"; g.fillRect(0, 0, 360, 240);
    g.strokeStyle = "#333"; g.beginPath();
    g.moveTo(180, 0); g.lineTo(180, 240);
    g.moveTo(60, 120); g.lineTo(300, 120); g.stroke();
    const dv = new DataView(pl.buffer, pl.byteOffset, pl.byteLength);
    g.fillStyle = "#4f4";
    for (let i = 0; i + 8 <= pl.byteLength; i += 8) {
      const re = dv.getFloat32(i, true), im = dv.getFloat32(i+4, true);
      g.fillRect(180 + re * 110, 120 - im * 110, 2, 2);
    }
  } else if (etag === "smeter") {         // f32le dBm history graph
    panelShow("scope");
    const dv = new DataView(pl.buffer, pl.byteOffset, pl.byteLength);
    smHist.push(dv.getFloat32(0, true));
    if (smHist.length > 360) smHist.shift();
    const g = document.getElementById("extscope").getContext("2d");
    g.fillStyle = "#000"; g.fillRect(0, 0, 360, 240);
    g.strokeStyle = "#444";
    for (let db = -120; db <= -20; db += 20) {
      const y = 240 - (db + 127) / 107 * 240;
      g.beginPath(); g.moveTo(0, y); g.lineTo(360, y); g.stroke();
      g.fillStyle = "#666"; g.fillText(db + "", 2, y - 2);
    }
    g.strokeStyle = "#4f4"; g.beginPath();
    smHist.forEach((db, i) => {
      const y = 240 - Math.max(0, Math.min(240, (db + 127) / 107 * 240));
      if (i === 0) g.moveTo(i, y); else g.lineTo(i, y);
    });
    g.stroke();
  } else if (etag === "fft") {            // f32le dB spectrum
    panelShow("scope");
    const dv = new DataView(pl.buffer, pl.byteOffset, pl.byteLength);
    const n = pl.byteLength / 4;
    const g = document.getElementById("extscope").getContext("2d");
    g.fillStyle = "#000"; g.fillRect(0, 0, 360, 240);
    g.strokeStyle = "#4cf"; g.beginPath();
    for (let i = 0; i < n; i++) {
      const db = dv.getFloat32(4 * i, true);
      const y = 240 - Math.max(0, Math.min(240, (db + 120) / 120 * 240));
      const x = i / n * 360;
      if (i === 0) g.moveTo(x, y); else g.lineTo(x, y);
    }
    g.stroke();
  } else if (etag === "colormap_list") {
    panelShow("spots");
    const tb = document.getElementById("spots");
    tb.textContent = "";
    JSON.parse(new TextDecoder().decode(pl)).forEach((name) => {
      const r = tb.insertRow();
      const b = document.createElement("button");
      b.textContent = name;
      b.onclick = () => setMsg(snd_ws, "get=" + name);
      r.insertCell().appendChild(b);
    });
  } else if (etag === "colormap") {
    // rebuild the waterfall LUT from server-supplied control stops
    const doc = JSON.parse(new TextDecoder().decode(pl));
    const st = doc.stops;
    for (let i = 0; i < 256; i++) {
      const p = i / 255 * (st.length - 1),
            k = Math.min(Math.floor(p), st.length - 2), f = p - k;
      for (let c = 0; c < 3; c++)
        LUT[3*i+c] = st[k][c] * (1-f) + st[k+1][c] * f;
    }
    extText("colormap: " + doc.name);
  } else if (etag.endsWith("_decode") || etag === "ale_word" ||
             etag === "hfdl_mpdu") {      // spot-table rows
    const s = new TextDecoder("utf-8", {fatal:false}).decode(pl);
    spotRow(etag.replace("_decode", "").replace("_mpdu", ""), s);
    extText(etag + " " + s);
  } else {                                // status/chars/etc: console
    const s = new TextDecoder("utf-8", {fatal:false}).decode(pl);
    extText(etag + " " + s);
  }
}

function updSmeter(dbm) {
  const pct = Math.max(0, Math.min(100, (dbm + 127) / 127 * 100));
  document.getElementById("smeter_fill").style.width = pct + "%";
  document.getElementById("smeter_db").textContent =
      dbm.toFixed(0) + " dBm";
}

// ---------------- W/F stream ----------------
function openWf() {
  wf_ws = new WebSocket("ws://" + location.host + "/" + TS + "/W/F");
  wf_ws.binaryType = "arraybuffer";
  wf_ws.onopen = () => {
    setMsg(wf_ws, "auth t=kiwi p=");
    setMsg(wf_ws, "wf_comp=1");
    setMsg(wf_ws, "wf speed=3");
    retuneWf();
  };
  wf_ws.onmessage = (e) => {
    const u8 = new Uint8Array(e.data);
    const tag = String.fromCharCode(u8[0], u8[1], u8[2]);
    if (tag === "MSG") {
      const s = new TextDecoder().decode(u8.subarray(4));
      if (s.startsWith("mkr=")) {
        try { renderLabels(JSON.parse(s.slice(4))); } catch (x) {}
      }
      return;
    }
    if (String.fromCharCode(u8[0], u8[1], u8[2], u8[3]) !== "W/F ")
      return;
    const dv = new DataView(e.data);
    const wflags = dv.getUint32(8, true);
    if (wflags & 0x10000) {        // ADPCM row: fresh state, 10-pad
      const st = { pred: 0, idx: 0 };
      const dec = adpcmDecode(u8.subarray(16), st, 0, 255);
      drawRow(dec.subarray(10, 10 + 1024));
    } else {
      drawRow(u8.subarray(16, 16 + 1024));
    }
  };
  wf_ws.onclose = () => setTimeout(openWf, 2000);
}

const wfc = document.getElementById("wf").getContext("2d");
const spc = document.getElementById("spec").getContext("2d");
function drawRow(row) {
  rows++;
  // scroll down one line
  wfc.drawImage(wfc.canvas, 0, 0, 1024, 359, 0, 1, 1024, 359);
  const img = wfc.createImageData(1024, 1);
  for (let i = 0; i < 1024; i++) {
    // wire: u8 = 255 + dB (dB <= 0); display window [-110, -30] dB
    const db = row[i] - 255;
    let v = Math.round((db + 110) / 80 * 255);
    v = Math.max(0, Math.min(255, v));
    img.data[4*i] = LUT[3*v]; img.data[4*i+1] = LUT[3*v+1];
    img.data[4*i+2] = LUT[3*v+2]; img.data[4*i+3] = 255;
  }
  wfc.putImageData(img, 0, 0);
  // spectrum line
  spc.fillStyle = "#000"; spc.fillRect(0, 0, 1024, 80);
  spc.strokeStyle = "#4f4"; spc.beginPath();
  for (let i = 0; i < 1024; i++) {
    const db = row[i] - 255;
    const y = 80 - Math.max(0, Math.min(80, (db + 110) / 80 * 80));
    if (i === 0) spc.moveTo(i, y); else spc.lineTo(i, y);
  }
  spc.stroke();
  // tuning cursor
  const x = (freq_khz * 1000 - wfLeft) / wfSpan * 1024;
  if (x >= 0 && x < 1024) {
    spc.strokeStyle = "#ff0"; spc.beginPath();
    spc.moveTo(x, 0); spc.lineTo(x, 80); spc.stroke();
  }
  document.getElementById("stat").textContent =
    "rows " + rows + " · snd pkts " + pkts + " · mode " + mode +
    " · zoom " + zoom + " · span " + (wfSpan/1e6).toFixed(3) + " MHz";
}

// ---------------- controls ----------------
// click = tune; drag = pan the waterfall; wheel = zoom about cursor
// (openwebrx.js canvas interaction semantics)
let dragX = null, dragged = false;
const wfEl = document.getElementById("wf");
wfEl.addEventListener("pointerdown", (e) => {
  dragX = e.clientX; dragged = false;
  wfEl.setPointerCapture(e.pointerId);
});
wfEl.addEventListener("pointermove", (e) => {
  if (dragX === null) return;
  const dx = e.clientX - dragX;
  if (Math.abs(dx) < 3 && !dragged) return;
  dragged = true;
  dragX = e.clientX;
  const r = wfEl.getBoundingClientRect();
  wfCf = (wfCf === null ? wfLeft + wfSpan / 2 : wfCf) -
         dx / r.width * wfSpan;
  retuneWf();
});
wfEl.addEventListener("pointerup", (e) => {
  wfEl.releasePointerCapture(e.pointerId);
  const wasDrag = dragged;
  dragX = null; dragged = false;
  if (wasDrag) return;
  const r = wfEl.getBoundingClientRect();
  const fx = (e.clientX - r.left) / r.width;
  freq_khz = (wfLeft + fx * wfSpan) / 1000;
  document.getElementById("freq").value = freq_khz.toFixed(2);
  retune();
});
function wheelZoom(e) {
  e.preventDefault();
  const r = wfEl.getBoundingClientRect();
  const fx = (e.clientX - r.left) / r.width;
  const fcur = wfLeft + fx * wfSpan;
  const nz = Math.max(0, Math.min(14, zoom + (e.deltaY < 0 ? 1 : -1)));
  if (nz === zoom) return;
  zoom = nz;
  const nspan = UI_SRATE / Math.pow(2, zoom);
  wfCf = fcur + (0.5 - fx) * nspan;
  document.getElementById("zoom").value = zoom;
  retuneWf();
}
wfEl.addEventListener("wheel", wheelZoom, { passive: false });
document.getElementById("spec").addEventListener(
    "wheel", wheelZoom, { passive: false });
document.getElementById("freq").addEventListener("change", retune);
document.getElementById("zoom").addEventListener("input", (e) => {
  zoom = parseInt(e.target.value);
  wfCf = null;                  // slider zoom recenters on the tune
  retuneWf();
});
document.getElementById("agc").addEventListener("change", (e) => {
  setMsg(snd_ws, "agc=" + (e.target.checked ? 1 : 0) + " manGain=50");
});
document.getElementById("sq").addEventListener("input", (e) => {
  setMsg(snd_ws, "squelch sq=" + e.target.value);
});
// noise blanker / reduction / de-emphasis (rx_sound_cmd.cpp SETs)
document.getElementById("nb").addEventListener("change", (e) => {
  setMsg(snd_ws, "nb algo=1 on=" + (e.target.checked ? 1 : 0));
});
document.getElementById("nr").addEventListener("change", (e) => {
  setMsg(snd_ws, "nr algo=3");               // NR_SPECTRAL
  setMsg(snd_ws, "nr type=0 en=" + (e.target.checked ? 1 : 0));
});
document.getElementById("deemp").addEventListener("change", (e) => {
  setMsg(snd_ws, "de_emp=" + (e.target.checked ? 1 : 0));
});
const modesEl = document.getElementById("modes");
MODES.forEach((m) => {
  const b = document.createElement("button");
  b.textContent = m; b.id = "mode_" + m;
  if (m === mode) b.classList.add("on");
  b.onclick = () => {
    mode = m;
    modesEl.querySelectorAll("button").forEach(
        (x) => x.classList.toggle("on", x === b));
    retune();
  };
  modesEl.appendChild(b);
});
const extSel = document.getElementById("ext");
EXTENSIONS.forEach((n) => {
  const o = document.createElement("option");
  o.value = n; o.textContent = n;
  extSel.appendChild(o);
});
// ---------------- per-extension CONTROLS ----------------
// (reference: each web/extensions/<name>/<name>.js control strip —
// WSPR/FT8 band select tunes the VFO; FAX gets LPM/shift/re-phase;
// SSTV gets mode force/restart.  Commands ride the same "SET" path
// and land in the extension's command() handler.)
const EXT_BANDS = {
  wspr: { "160m": 1836.6, "80m": 3568.6, "40m": 7038.6,
          "30m": 10138.7, "20m": 14095.6, "15m": 21094.6,
          "10m": 28124.6 },
  FT8:  { "80m": 3573, "40m": 7074, "30m": 10136, "20m": 14074,
          "15m": 21074, "10m": 28074 },
  FT4:  { "40m": 7047.5, "20m": 14080, "15m": 21140 },
};
function buildExtCtl(name) {
  const ctl = document.getElementById("extctl");
  ctl.textContent = "";
  const mk = (tag, txt) => {
    const el = document.createElement(tag);
    if (txt !== undefined) el.textContent = txt;
    ctl.appendChild(el);
    return el;
  };
  if (EXT_BANDS[name]) {
    mk("span", "band ");
    const sel = mk("select");
    Object.entries(EXT_BANDS[name]).forEach(([b, khz]) => {
      const o = document.createElement("option");
      o.value = khz; o.textContent = b + " (" + khz + ")";
      sel.appendChild(o);
    });
    sel.onchange = () => {
      freq_khz = parseFloat(sel.value); mode = "usb"; retune();
    };
  } else if (name === "FAX") {
    mk("span", "lpm ");
    const sel = mk("select");
    [60, 90, 120, 240].forEach((l) => {
      const o = document.createElement("option");
      o.value = l; o.textContent = l;
      if (l === 120) o.selected = true;
      sel.appendChild(o);
    });
    sel.onchange = () => setMsg(snd_ws, "lpm=" + sel.value);
    mk("button", "◀").onclick = () => setMsg(snd_ws, "shift=-4");
    mk("button", "▶").onclick = () => setMsg(snd_ws, "shift=4");
    mk("button", "re-phase").onclick =
        () => setMsg(snd_ws, "rephase=1");
  } else if (name === "SSTV") {
    mk("span", "mode ");
    const sel = mk("select");
    ["auto", "MartinM1", "ScottieS1"].forEach((m) => {
      const o = document.createElement("option");
      o.value = m.toLowerCase(); o.textContent = m;
      sel.appendChild(o);
    });
    sel.onchange = () => setMsg(snd_ws, "mode=" + sel.value);
    mk("button", "restart").onclick =
        () => setMsg(snd_ws, "restart=1");
  }
}
extSel.onchange = () => {
  const box = document.getElementById("extout");
  const panel = document.getElementById("panel");
  imgLine = 0; smHist = [];
  document.getElementById("spots").textContent = "";
  const ic = document.getElementById("extimg");
  ic.getContext("2d").clearRect(0, 0, ic.width, ic.height);
  panelShow(null);
  if (extSel.value) {
    setMsg(snd_ws, "ext_switch_to_client=" + extSel.value);
    buildExtCtl(extSel.value);
    panel.style.display = "block";
    box.style.display = "block";
    box.textContent = "";
  } else {
    setMsg(snd_ws, "ext_blur");
    panel.style.display = "none";
    box.style.display = "none";
  }
};
// ---------------- camping (MON stream) ----------------
// listen-only share of another user's channel
// (reference: rx/rx_monitor.cpp c2s_mon + the camp UI)
let camp_ws = null, campAdpcm = null, campMode = false;
const campSel = document.getElementById("camp");
campSel.onmousedown = async () => {
  let users = [];
  try { users = await (await fetch("/users")).json(); } catch (x) {}
  campSel.textContent = "";
  const off = document.createElement("option");
  off.value = ""; off.textContent = "off";
  campSel.appendChild(off);
  users.forEach((u) => {
    const o = document.createElement("option");
    o.value = u.i;
    o.textContent = "ch" + u.i + " " + (u.n || "?") + " " +
        u.f.toFixed(1) + " " + u.m;
    campSel.appendChild(o);
  });
};
campSel.onchange = () => {
  if (camp_ws) { camp_ws.close(); camp_ws = null; }
  campMode = false;
  if (campSel.value === "") return;
  campAdpcm = { pred: 0, idx: 0 };
  camp_ws = new WebSocket("ws://" + location.host + "/" + TS +
                          "camp/MON");
  camp_ws.binaryType = "arraybuffer";
  camp_ws.onopen = () => {
    setMsg(camp_ws, "auth t=kiwi p=");
    setMsg(camp_ws, "compression=1");
    setMsg(camp_ws, "camp=" + campSel.value);
    campMode = true;
  };
  camp_ws.onmessage = (e) => {
    const u8 = new Uint8Array(e.data);
    if (String.fromCharCode(u8[0], u8[1], u8[2]) !== "SND") return;
    const flags = u8[3];
    const off = (flags & 0x08) ? 20 : 10;
    let pcm;
    if (flags & 0x10) {
      pcm = adpcmDecode(u8.subarray(off), campAdpcm, -32768, 32767);
    } else {
      const dv = new DataView(e.data);
      pcm = new Int32Array((u8.length - off) / 2);
      for (let i = 0; i < pcm.length; i++)
        pcm[i] = dv.getInt16(off + 2 * i, !!(flags & 0x80));
    }
    if (actx) playPcm(pcm);
  };
};
document.getElementById("audio_btn").onclick = () => {
  if (!actx) {
    actx = new (window.AudioContext || window.webkitAudioContext)(
        { sampleRate: AUDIO_RATE });
    document.getElementById("audio_btn").classList.add("on");
    document.getElementById("audio_btn").textContent = "audio on";
  }
  actx.resume();
};
// ---------------- GPS sky map ----------------
// polar az/el plot fed from /gps (reference: the admin GPS tab,
// gps/stat.cpp + kiwi/admin.js sky map)
let gpsTimer = null;
const skyEl = document.getElementById("sky");
document.getElementById("gps_btn").onclick = () => {
  const show = skyEl.style.display === "none";
  skyEl.style.display = show ? "block" : "none";
  document.getElementById("gps_btn").classList.toggle("on", show);
  if (show) { drawSky(); gpsTimer = setInterval(drawSky, 5000); }
  else clearInterval(gpsTimer);
};
async function drawSky() {
  let st;
  try { st = await (await fetch("/gps")).json(); } catch (x) { return; }
  const g = skyEl.getContext("2d");
  const cx = 180, cy = 180, R = 160;
  g.fillStyle = "#181818"; g.fillRect(0, 0, 360, 360);
  g.strokeStyle = "#444"; g.fillStyle = "#888"; g.font = "11px sans-serif";
  [0, 30, 60].forEach((el) => {
    const r = R * (90 - el) / 90;
    g.beginPath(); g.arc(cx, cy, r, 0, 2 * Math.PI); g.stroke();
    g.fillText(el + "°", cx + 2, cy - r + 11);
  });
  g.beginPath(); g.moveTo(cx - R, cy); g.lineTo(cx + R, cy);
  g.moveTo(cx, cy - R); g.lineTo(cx, cy + R); g.stroke();
  g.fillText("N", cx - 4, 12);
  if (!st.enabled) { g.fillText("gps disabled", 8, 350); return; }
  (st.sats || st.channels || []).forEach((s) => {
    if (s.el === undefined || s.el === null) return;
    const r = R * (90 - s.el) / 90;
    const a = (s.az - 90) * Math.PI / 180;
    const x = cx + r * Math.cos(a), y = cy + r * Math.sin(a);
    const snr = s.snr || s.power_db || 30;
    const hot = Math.max(0, Math.min(1, (snr - 20) / 30));
    const gal = (s.sys === "galileo") || s.prn >= 210;
    g.fillStyle = gal ?
        "rgb(" + (80+120*hot) + ",80,255)" :
        "rgb(0," + (120 + 135 * hot) + ",80)";
    g.beginPath(); g.arc(x, y, 6, 0, 2 * Math.PI); g.fill();
    g.fillStyle = "#ddd";
    g.fillText(gal ? "E" + (s.prn - 210) : s.prn, x + 7, y + 4);
  });
  g.fillStyle = "#8a8";
  const fix = st.last_fix || st.fix;
  g.fillText("tracked " + (st.tracking || 0) + " · fixes " +
      (st.fixes || 0) + (fix ? " · " + fix[0].toFixed(4) + ", " +
      fix[1].toFixed(4) : ""), 8, 350);
}

// apply URL tuning to the controls before connecting
document.getElementById("freq").value = freq_khz.toFixed(2);
document.getElementById("zoom").value = zoom;

setInterval(() => { setMsg(snd_ws, "keepalive"); }, 5000);
openSnd();
openWf();
</script></body></html>
"""


def render(name: str, ui_srate: float, audio_rate: int) -> str:
    import json as _json
    from .. import extensions as _ext
    return (PAGE.replace("__NAME__", name)
            .replace("__UI_SRATE__", str(float(ui_srate)))
            .replace("__AUDIO_RATE__", str(int(audio_rate)))
            .replace("__EXTENSIONS__", _json.dumps(_ext.ext_list())))


ADMIN_PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>admin</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#ddd;
        margin:0; padding:16px; }
 input, button, textarea { background:#222; color:#ddd;
        border:1px solid #555; border-radius:4px; padding:4px 8px; }
 textarea { width:90%; height:280px; font-family:monospace;
        font-size:12px; }
 pre { background:#000; padding:8px; max-height:300px; overflow:auto;
        font-size:12px; }
 .tab { margin-right:6px; } .tab.on { background:#2a6; color:#fff; }
 section { display:none; margin-top:12px; } section.on { display:block; }
</style></head><body>
<h2>admin — flydog_sdr_gps_tpu_torch</h2>
<div id="login">password <input id="pw" type="password">
 <button id="go">connect</button> <span id="lmsg"></span></div>
<div id="main" style="display:none">
 <button class="tab on" data-t="status">status</button>
 <button class="tab" data-t="setup">setup</button>
 <button class="tab" data-t="users">users</button>
 <button class="tab" data-t="dx">dx</button>
 <button class="tab" data-t="gpstab">gps</button>
 <button class="tab" data-t="update">update</button>
 <button class="tab" data-t="network">network</button>
 <button class="tab" data-t="webpage">webpage</button>
 <button class="tab" data-t="public">public</button>
 <button class="tab" data-t="config">config</button>
 <button class="tab" data-t="log">log</button>
 <section id="status" class="on"><pre id="stats"></pre>
   <button id="refresh">refresh</button></section>
 <section id="users">
  <table id="utab" style="border-spacing:8px 2px;font-size:13px;
    font-family:monospace"></table>
  <button id="uref">refresh</button>
  <button id="ukickall">kick all</button>
 </section>
 <section id="dx">
  <div style="max-height:260px;overflow:auto">
   <table id="dxtab" style="border-spacing:8px 1px;font-size:12px;
     font-family:monospace"></table></div>
  gid <input id="dxg" size="5" value="-1">
  kHz <input id="dxf" size="9"> mode <input id="dxm" size="5"
    value="am"> ident <input id="dxi" size="16">
  notes <input id="dxn" size="16">
  <button id="dxadd">add/update</button>
  <button id="dxdel">delete gid</button>
  <button id="dxref">refresh</button> <span id="dxmsg"></span>
 </section>
 <section id="gpstab"><pre id="gpsbox"></pre>
  <button id="gpsref">refresh</button></section>
 <section id="update"><pre id="updbox"></pre>
  <button id="updstat">status</button>
  <button id="updcheck">check now</button>
  <button id="updbuild">build now</button>
  <hr><b>backup / restore</b><br>
  <button id="bakget">download backup</button>
  <input type="file" id="bakfile" accept=".json">
  <button id="bakput">restore from file</button>
  <span id="bakmsg"></span></section>
 <section id="setup">
  <table id="forms" style="border-spacing:6px">
   <tr><td>server name</td><td><input id="f_name" size="28"></td></tr>
   <tr><td>location</td><td><input id="f_loc" size="28"></td></tr>
   <tr><td>admin email</td><td><input id="f_email" size="28"></td></tr>
   <tr><td>user password</td><td><input id="f_upw" size="20">
     <small>(empty = open access)</small></td></tr>
   <tr><td>admin password</td><td><input id="f_apw" size="20">
     <small>(stored salted-hashed)</small></td></tr>
   <tr><td>keepalive (s)</td><td><input id="f_ka" size="6"></td></tr>
   <tr><td>inactivity timeout (min)</td>
       <td><input id="f_inact" size="6"></td></tr>
   <tr><td>per-IP time limit (min)</td>
       <td><input id="f_tlimit" size="6"></td></tr>
   <tr><td>max connections per IP</td>
       <td><input id="f_maxip" size="6"></td></tr>
  </table>
  <button id="fapply">apply</button> <button id="fsave">save</button>
  <span id="fmsg"></span>
 </section>
 <section id="network">
  <table style="border-spacing:6px">
   <tr><td>DDNS hostname</td><td><input id="n_ddnsh" size="28"></td></tr>
   <tr><td>DDNS update URL</td><td><input id="n_ddnsu" size="36"></td></tr>
   <tr><td>DDNS auth (user:pass)</td><td><input id="n_ddnsa" size="24"></td></tr>
   <tr><td>registry URL</td><td><input id="n_reg" size="36"></td></tr>
   <tr><td>gateway IP (NAT)</td><td><input id="n_gw" size="16"></td></tr>
   <tr><td>allow egress</td><td><input id="n_egress" size="4">
     <small>(1 = registry/DDNS/NAT services may reach the network)</small></td></tr>
  </table>
  <button id="napply">apply</button> <span id="nmsg"></span>
  <hr><b>background services</b> <button id="svcref">refresh</button>
  <pre id="svcbox"></pre>
 </section>
 <section id="webpage">
  <table style="border-spacing:6px">
   <tr><td>receiver name</td><td><input id="w_rxname" size="28"></td></tr>
   <tr><td>status message</td><td><input id="w_status" size="40"></td></tr>
  </table>
  <button id="wapply">apply</button> <span id="wmsg"></span>
  <hr><b>listing photo</b> (shown on the public listing; PNG/JPEG)<br>
  <input type="file" id="photofile" accept="image/*">
  <button id="photoput">upload</button> <span id="photomsg"></span><br>
  <img id="photoprev" src="/photo" style="max-width:320px;margin-top:6px"
       onerror="this.style.display='none'">
 </section>
 <section id="public">
  <table style="border-spacing:6px">
   <tr><td>list on public registry</td><td><input id="p_list" size="4">
     <small>(1 = check in with the registry service)</small></td></tr>
   <tr><td>grid square</td><td><input id="p_grid" size="8"></td></tr>
   <tr><td>antenna</td><td><input id="p_ant" size="28"></td></tr>
   <tr><td>transverter offset (kHz)</td><td><input id="p_off" size="10"></td></tr>
  </table>
  <button id="papply">apply</button> <span id="pmsg"></span>
 </section>
 <section id="config"><textarea id="cfg"></textarea><br>
   key <input id="ckey"> value <input id="cval">
   <button id="cset">set</button> <button id="csave">save</button>
   <span id="cmsg"></span></section>
 <section id="log"><pre id="logbox"></pre>
   <button id="logref">refresh</button></section>
</div>
<script>
"use strict";
let ws = null;
function send(s) { if (ws && ws.readyState === 1) ws.send("SET " + s); }
document.getElementById("go").onclick = () => {
  ws = new WebSocket("ws://" + location.host + "/admin_" +
                     Math.floor(Date.now()/1000) + "/ADMIN");
  ws.binaryType = "arraybuffer";
  ws.onopen = () => send("auth p=" +
      encodeURIComponent(document.getElementById("pw").value));
  ws.onmessage = (e) => {
    const s = typeof e.data === "string" ? e.data :
        new TextDecoder().decode(e.data);
    if (s.startsWith("MSG ")) {
      const kv = {};
      s.slice(4).split(" ").forEach((t) => {
        const i = t.indexOf("="); if (i > 0) kv[t.slice(0,i)] = t.slice(i+1);
      });
      if ("badp" in kv) {
        if (kv.badp === "0") {
          document.getElementById("login").style.display = "none";
          document.getElementById("main").style.display = "block";
          send("stats"); send("get_config"); send("log n=100");
        } else {
          document.getElementById("lmsg").textContent = "wrong password";
        }
      }
      if ("blocks" in kv)
        document.getElementById("stats").textContent =
            JSON.stringify(kv, null, 1);
      if ("cfg_seq" in kv || "saved" in kv) {
        document.getElementById("cmsg").textContent =
            "saved" in kv ? "saved" : "seq " + kv.cfg_seq;
        send("get_config");
      }
      if ("authkey_cb" in kv && photoPending) {
        const f = photoPending; photoPending = null;
        const fd = new FormData();
        fd.append("photo", f, f.name);
        fetch("/PIX?" + kv.authkey_cb, { method: "POST", body: fd })
          .then((r) => r.text()).then((rc) => {
            document.getElementById("photomsg").textContent =
                rc === "0" ? "uploaded" : "failed rc=" + rc;
            if (rc === "0") {
              const img = document.getElementById("photoprev");
              img.style.display = ""; img.src = "/photo?" + Date.now();
            }
          });
      }
      if ("restored" in kv)
        document.getElementById("bakmsg").textContent =
            kv.restored === "1" ? "restored" : "restore failed";
    } else if (s.startsWith("CFG ")) {
      const doc = JSON.parse(s.slice(4));
      document.getElementById("cfg").value =
          JSON.stringify(doc, null, 1);
      fillForms(doc);
    } else if (s.startsWith("LOG ")) {
      document.getElementById("logbox").textContent = s.slice(4);
    } else if (s.startsWith("USERS ")) {
      renderUsers(JSON.parse(s.slice(6)));
    } else if (s.startsWith("DXL ")) {
      renderDx(JSON.parse(s.slice(4)));
    } else if (s.startsWith("GPS ")) {
      document.getElementById("gpsbox").textContent =
          JSON.stringify(JSON.parse(s.slice(4)), null, 1);
    } else if (s.startsWith("BAK ")) {
      const blob = new Blob([s.slice(4)], {type: "application/json"});
      const a = document.createElement("a");
      a.href = URL.createObjectURL(blob);
      a.download = "kiwi_tpu_backup.json";
      a.click();
      document.getElementById("bakmsg").textContent = "downloaded";
    } else if (s.startsWith("SVC ")) {
      const rows = JSON.parse(s.slice(4));
      document.getElementById("svcbox").textContent = rows.map((r) =>
        r.name.padEnd(18) + (r.enabled ? "on " : "off") +
        "  runs=" + r.runs + "  ok=" + r.ok +
        (r.error ? "  err=" + r.error : "")).join("\n") ||
        "(no services registered)";
    } else if (s.startsWith("UPD ")) {
      const u = JSON.parse(s.slice(4));
      document.getElementById("updbox").textContent =
          "installed v" + u.v1 + "." + u.v2 +
          (u.p1 || u.p2 ? "  pending v" + u.p1 + "." + u.p2 : "") +
          "  fail_reason=" + u.f + " pending=" + u.p +
          "\n\n--- build log ---\n" + (u.log || []).join("\n");
    }
  };
};
// ---- connection inspector ----
function renderUsers(rows) {
  const tb = document.getElementById("utab");
  tb.textContent = "";
  const h = tb.insertRow();
  ["ch","ident","ip","geo","freq","mode","conn s","drops",""]
    .forEach((t) => {
      const c = document.createElement("th");
      c.textContent = t; c.style.textAlign = "left"; h.appendChild(c);
    });
  rows.forEach((r) => {
    const tr = tb.insertRow();
    [r.ch, r.n, r.ip, r.geo, r.f, r.m, r.t, r.drops].forEach((v) => {
      tr.insertCell().textContent = v === null ? "-" : v;
    });
    const b = document.createElement("button");
    b.textContent = "kick";
    b.onclick = () => { send("kick ts=" + r.ts); send("users"); };
    tr.insertCell().appendChild(b);
  });
}
// ---- DX label editor ----
function renderDx(rows) {
  const tb = document.getElementById("dxtab");
  tb.textContent = "";
  const h = tb.insertRow();
  ["gid","kHz","mode","ident","notes"].forEach((t) => {
    const c = document.createElement("th");
    c.textContent = t; c.style.textAlign = "left"; h.appendChild(c);
  });
  rows.slice(0, 400).forEach((r) => {
    const tr = tb.insertRow();
    [r[0], r[1], r[2], r[3], r[4]].forEach((v) => {
      tr.insertCell().textContent = v;
    });
    tr.onclick = () => {
      document.getElementById("dxg").value = r[0];
      document.getElementById("dxf").value = r[1];
      document.getElementById("dxm").value = r[2];
      document.getElementById("dxi").value = r[3];
      document.getElementById("dxn").value = r[4];
    };
  });
  document.getElementById("dxmsg").textContent =
      rows.length + " labels" + (rows.length > 400 ?
      " (showing first 400)" : "");
}
document.getElementById("uref").onclick = () => send("users");
document.getElementById("ukickall").onclick = () => {
  send("kick_all"); send("users");
};
document.getElementById("dxref").onclick = () => send("dx_list");
document.getElementById("dxadd").onclick = () => send(
  "dx_upd g=" + document.getElementById("dxg").value +
  " f=" + document.getElementById("dxf").value +
  " m=" + document.getElementById("dxm").value +
  " i=" + encodeURIComponent(document.getElementById("dxi").value) +
  " n=" + encodeURIComponent(document.getElementById("dxn").value));
document.getElementById("dxdel").onclick = () => send(
  "dx_upd g=" + document.getElementById("dxg").value + " f=-1");
document.getElementById("gpsref").onclick = () => send("gps");
document.getElementById("updstat").onclick = () => send("update_status");
document.getElementById("updcheck").onclick = () => send("update_check");
document.getElementById("updbuild").onclick = () => send("update_build");
document.getElementById("bakget").onclick = () => send("backup");
document.getElementById("bakput").onclick = () => {
  const f = document.getElementById("bakfile").files[0];
  if (!f) return;
  f.text().then((t) => send("restore data=" + encodeURIComponent(t)));
};
// ---- setup forms: structured fields writing cfg keys ----
const FORM_KEYS = [
  ["f_name", "server_name"], ["f_loc", "location"],
  ["f_email", "admin_email"], ["f_upw", "user_password"],
  ["f_ka", "keepalive_sec"], ["f_inact", "inactivity_timeout_mins"],
  ["f_tlimit", "ip_limit_mins"], ["f_maxip", "max_conns_per_ip"],
  // network tab (net/services.cpp cfg keys)
  ["n_ddnsh", "ddns_hostname"], ["n_ddnsu", "ddns_url"],
  ["n_ddnsa", "ddns_auth"], ["n_reg", "registry_url"],
  ["n_gw", "gateway_ip"], ["n_egress", "egress"],
  // webpage tab
  ["w_rxname", "rx_name"], ["w_status", "status_msg"],
  // public tab
  ["p_list", "public_listing"], ["p_grid", "grid"],
  ["p_ant", "antenna"], ["p_off", "freq_offset"]];
const TAB_KEYS = { napply: ["n_"], wapply: ["w_"], papply: ["p_"] };
function fillForms(doc) {
  FORM_KEYS.forEach(([id, key]) => {
    const el = document.getElementById(id);
    if (el && doc[key] !== undefined) el.value = doc[key];
  });
}
document.getElementById("fapply").onclick = () => {
  FORM_KEYS.forEach(([id, key]) => {
    const v = document.getElementById(id).value;
    if (v !== "") send("set_config key=" + key + " value=" +
                       encodeURIComponent(v));
  });
  const apw = document.getElementById("f_apw").value;
  if (apw !== "")
    send("set_admin_password p=" + encodeURIComponent(apw));
  document.getElementById("fmsg").textContent = "applied";
};
document.getElementById("fsave").onclick = () => send("save_config");
["napply", "wapply", "papply"].forEach((bid) => {
  document.getElementById(bid).onclick = () => {
    FORM_KEYS.forEach(([id, key]) => {
      if (!TAB_KEYS[bid].some((p) => id.startsWith(p))) return;
      const v = document.getElementById(id).value;
      if (v !== "") send("set_config key=" + key + " value=" +
                         encodeURIComponent(v));
    });
    send("save_config");
    document.getElementById(bid[0] + "msg").textContent = "applied";
  };
});
document.getElementById("svcref").onclick = () => send("services");
let photoPending = null;
document.getElementById("photoput").onclick = () => {
  const f = document.getElementById("photofile").files[0];
  if (!f) return;
  photoPending = f;
  send("get_authkey");       // single-use key for /PIX
};
document.querySelectorAll(".tab").forEach((b) => {
  b.onclick = () => {
    document.querySelectorAll(".tab").forEach(
        (x) => x.classList.toggle("on", x === b));
    document.querySelectorAll("section").forEach(
        (x) => x.classList.toggle("on", x.id === b.dataset.t));
    const refresh = { users: "users", dx: "dx_list", gpstab: "gps",
                      update: "update_status", log: "log n=100",
                      status: "stats", network: "services" };
    if (refresh[b.dataset.t]) send(refresh[b.dataset.t]);
  };
});
document.getElementById("refresh").onclick = () => send("stats");
document.getElementById("logref").onclick = () => send("log n=100");
document.getElementById("cset").onclick = () => send(
    "set_config key=" + document.getElementById("ckey").value +
    " value=" + document.getElementById("cval").value);
document.getElementById("csave").onclick = () => send("save_config");
</script></body></html>
"""
