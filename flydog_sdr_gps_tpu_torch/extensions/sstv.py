"""SSTV extension — slow-scan TV image decode (Martin / Scottie).

Reference: `extensions/SSTV/` (slowrx-derived): VIS header detection
(1900 Hz leader, 1200 Hz start/stop, 7-bit mode code in 1100/1300 Hz
FSK at 30 ms/bit), then per-line sync at 1200 Hz and three color
scans with luminance mapped 1500 Hz (black) .. 2300 Hz (white).

Implemented modes (the two most common on HF):

=========  ====  ======  ===========  ==========
mode       VIS   lines   scan ms      color order
Martin M1  44    256     146.432      G B R
Scottie S1 60    256     138.240      G B R (sync before R)
=========  ====  ======  ===========  ==========

The demodulator is the same quadrature frequency tracker as FAX;
line slicing is driven by nominal timing after VIS lock (crystal
accuracy is plenty over a 2-minute frame at audio rates).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import Extension, ext_register
from .taps import host_column

F_BLACK, F_WHITE = 1500.0, 2300.0
F_SYNC, F_LEADER = 1200.0, 1900.0
F_BIT1, F_BIT0 = 1100.0, 1300.0


@dataclasses.dataclass(frozen=True)
class SstvMode:
    name: str
    vis: int
    lines: int
    scan_ms: float
    sync_ms: float
    sep_ms: float
    sync_first: bool          # sync at line start (Martin) or pre-R


MODES = {
    44: SstvMode("Martin M1", 44, 256, 146.432, 4.862, 0.572, True),
    60: SstvMode("Scottie S1", 60, 256, 138.240, 9.0, 1.5, False),
}


@ext_register
class SstvExt(Extension):
    name = "SSTV"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.px = int(params.get("px", 320))
        self._carry = np.zeros(0, np.float64)
        self._last = 0.0 + 0.0j
        self._freqs = np.zeros(0, np.float64)
        self.mode: SstvMode | None = None
        self._line = 0
        self._pos = 0.0          # sample cursor into _freqs
        self.lines_out = 0

    def command(self, cmd: dict) -> list:
        """SSTV panel controls (reference
        `web/extensions/SSTV/SSTV.js`): force a mode (skip VIS) or
        return to auto, restart the frame."""
        out = []
        if "mode" in cmd:
            want = str(cmd["mode"]).lower()
            if want in ("auto", ""):
                self.mode = None
                out.append(("sstv_mode", b"auto"))
            else:
                for m in MODES.values():
                    if want in m.name.lower().replace(" ", ""):
                        self.mode = m
                        self._line = 0
                        self._pos = 0.0
                        self._freqs = np.zeros(0, np.float64)
                        out.append(("sstv_mode",
                                    f"forced {m.name}".encode()))
                        break
        if "restart" in cmd:
            self._line = 0
            self._pos = 0.0
            self.mode = None
            self._freqs = np.zeros(0, np.float64)
            out.append(("sstv_mode", b"restarted"))
        return out

    # -- shared freq tracker (see fax.py) --------------------------------
    def _freq_track(self, audio: np.ndarray) -> np.ndarray:
        t = np.arange(len(audio)) / self.fs
        f_mid = 1700.0
        z = audio * np.exp(-2j * np.pi * f_mid * t)
        k = max(2, int(self.fs / f_mid))
        z = np.convolve(z, np.ones(k) / k, mode="same")
        zp = np.concatenate([[self._last], z[:-1]])
        self._last = z[-1]
        d = z * np.conj(zp)
        return np.angle(d) * self.fs / (2 * np.pi) + f_mid

    def process_block(self, taps) -> list:
        audio = np.concatenate([
            self._carry,
            host_column(taps.audio, self.rx_chan, np.float64)])
        self._carry = np.zeros(0, np.float64)
        self._freqs = np.concatenate([self._freqs,
                                      self._freq_track(audio)])
        out = []
        if self.mode is None:
            vis = self._detect_vis()
            if vis is not None and vis in MODES:
                self.mode = MODES[vis]
                self._line = 0
                out.append(("sstv_mode", self.mode.name.encode()))
        if self.mode is not None:
            out.extend(self._drain_lines())
        # bound the buffer when idle
        if self.mode is None and len(self._freqs) > int(3 * self.fs):
            self._freqs = self._freqs[-int(1.5 * self.fs):]
        return out

    # -- VIS ---------------------------------------------------------------
    def _detect_vis(self) -> int | None:
        """Find leader(1900) + start(1200) + 7 bits + parity + stop."""
        ms = self.fs / 1000.0
        bit = int(30 * ms)
        need = int(300 * ms) + 10 * bit
        f = self._freqs
        if len(f) < need:
            return None
        # locate a 1200 Hz start bit following a 1900 Hz leader
        win = int(15 * ms)
        i = int(250 * ms)
        while i + 10 * bit < len(f):
            seg = f[i:i + win]
            lead = f[i - int(100 * ms):i - int(5 * ms)]
            if (np.median(seg) < 1280 and len(lead) and
                    abs(np.median(lead) - F_LEADER) < 80):
                bits = []
                for b in range(8):          # 7 data + parity
                    c = f[i + bit * (b + 1) + bit // 4:
                          i + bit * (b + 2) - bit // 4]
                    bits.append(1 if np.median(c) < 1200 else 0)
                vis = 0
                for b in range(7):
                    vis |= bits[b] << b
                if sum(bits) % 2 == 0:      # even parity
                    self._freqs = f[i + 10 * bit:]
                    self._pos = 0.0
                    return vis
            i += win // 2
        return None

    # -- lines ---------------------------------------------------------------
    def _drain_lines(self) -> list:
        m = self.mode
        ms = self.fs / 1000.0
        out = []
        if m.sync_first:
            line_samps = (m.sync_ms + 3 * (m.scan_ms + m.sep_ms)) * ms
        else:
            line_samps = (m.sync_ms + m.sep_ms
                          + 3 * (m.scan_ms + m.sep_ms)) * ms
        while self._pos + line_samps <= len(self._freqs) and \
                self._line < m.lines:
            base = self._pos
            rgb = np.zeros((3, self.px), np.uint8)
            order = (1, 2, 0)               # scans G,B,R -> rgb indices
            if m.sync_first:
                off = m.sync_ms * ms
            else:
                off = 0.0
            for scan_i in range(3):
                if not m.sync_first and scan_i == 2:
                    off += (m.sync_ms + m.sep_ms) * ms  # Scottie pre-R sync
                a = int(base + off)
                b = int(base + off + m.scan_ms * ms)
                seg = self._freqs[a:b]
                n = (len(seg) // self.px) * self.px
                row = seg[:n].reshape(self.px, -1).mean(axis=1)
                lum = np.clip((row - F_BLACK) / (F_WHITE - F_BLACK),
                              0, 1)
                rgb[order[scan_i]] = (lum * 255).astype(np.uint8)
                off += (m.scan_ms + m.sep_ms) * ms
            out.append(("sstv_line",
                        bytes([self._line & 0xFF]) + rgb.tobytes()))
            self._line += 1
            self.lines_out += 1
            self._pos = base + line_samps
        if self._line >= m.lines:
            out.append(("sstv_done", str(self._line).encode()))
            self.mode = None
            self._freqs = self._freqs[int(self._pos):]
            self._pos = 0.0
        return out
