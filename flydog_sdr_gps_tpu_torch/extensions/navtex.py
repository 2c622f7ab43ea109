"""NAVTEX extension — SITOR-B (CCIR 476) FEC broadcast decode.

Reference: `extensions/NAVTEX/` + the shared CCIR 476 framing tables
(`web/extensions/FSK/CCIR476.js:52-91`) — 518 kHz maritime safety
broadcasts: 100 baud FSK with 170 Hz shift, 7-bit constant-ratio
codes (every valid code has exactly four 1-bits, "4/7 framing"),
error detection by code weight and time-diversity repetition.

The code tables below are the CCIR Rec. 476 standard assignments.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column

# CCIR 476 control codes
ALF = 0x0F      # phasing signal 1 (alpha)
BET = 0x33      # phasing signal 2 (beta)
FGS = 0x36      # figure shift
LTR = 0x5A      # letter shift
REP = 0x66      # repetition phasing
C32 = 0x6A      # SIA / code32

CODE_LTRS = {
    0x17: "J", 0x1B: "F", 0x1D: "C", 0x1E: "K", 0x27: "W", 0x2B: "Y",
    0x2D: "P", 0x2E: "Q", 0x35: "G", 0x39: "M", 0x3A: "X", 0x3C: "V",
    0x47: "A", 0x4B: "S", 0x4D: "I", 0x4E: "U", 0x53: "D", 0x55: "R",
    0x56: "E", 0x59: "N", 0x5C: " ", 0x63: "Z", 0x65: "L", 0x69: "H",
    0x6C: "\n", 0x71: "O", 0x72: "B", 0x74: "T", 0x78: "\r",
}
CODE_FIGS = {
    0x17: "'", 0x1B: "!", 0x1D: ":", 0x1E: "(", 0x27: "2", 0x2B: "6",
    0x2D: "0", 0x2E: "1", 0x35: "&", 0x39: ".", 0x3A: "/", 0x3C: ";",
    0x47: "-", 0x4B: "\x07", 0x4D: "8", 0x4E: "7", 0x53: "$",
    0x55: "4", 0x56: "3", 0x59: ",", 0x5C: " ", 0x63: '"', 0x65: ")",
    0x69: "#", 0x6C: "\n", 0x71: "9", 0x72: "?", 0x74: "5",
    0x78: "\r",
}
LTRS_CODE = {v: k for k, v in CODE_LTRS.items()}
FIGS_CODE = {v: k for k, v in CODE_FIGS.items()}


def weight(v: int) -> int:
    return bin(v & 0x7F).count("1")


def encode_chars(text: str) -> list[int]:
    """Text -> CCIR476 character codes (shift codes inserted)."""
    out = [LTR]
    figs = False
    for ch in text.upper():
        if ch in LTRS_CODE:
            if figs:
                out.append(LTR)
                figs = False
            out.append(LTRS_CODE[ch])
        elif ch in FIGS_CODE:
            if not figs:
                out.append(FGS)
                figs = True
            out.append(FIGS_CODE[ch])
    return out


def encode_text(text: str, phasing: int = 8) -> list[int]:
    """Text -> the TRUE SITOR-B transmission stream (ITU-R M.476
    mode B): alternating REP/ALPHA phasing pairs, then alternating
    DX/RX slots — the DX (rep-phase) character repeats in the RX
    (alpha-phase) slot two pairs (280 ms) later, the time diversity
    the FEC votes across (`web/extensions/FSK/CCIR476.js:149-221`).

    The pre-oracle encoder emitted each character once with no
    phase structure — the loopback mirror bug the spec-built vector
    test caught (the old decoder printed every character twice on a
    true stream)."""
    chars = encode_chars(text)
    out = []
    for _ in range(phasing):
        out += [REP, ALF]
    n = len(chars)
    for k in range(n + 2):
        out.append(chars[k] if k < n else REP)            # DX slot
        out.append(chars[k - 2] if k >= 2 else ALF)       # RX slot
    return out


@ext_register
class NavtexExt(Extension):
    name = "NAVTEX"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.center = float(params.get("center", 1000.0))
        self.shift = float(params.get("shift", 170.0))
        self.baud = float(params.get("baud", 100.0))
        self.sps = self.fs / self.baud
        self._bits: list[int] = []
        self._figs = False
        self._synced = False
        self._carry = np.zeros(0, np.float64)
        self.text = ""
        # SITOR-B rep/alpha FEC state (CCIR476.js:149-221): 3-deep
        # DX fifo; the alpha-slot copy votes against the rep copy
        self._alpha_phase = False
        self._fifo = [ALF, ALF, ALF]
        self._bad_run = 0

    def process_block(self, taps) -> list:
        audio = np.concatenate([
            self._carry,
            host_column(taps.audio, self.rx_chan, np.float64)])
        seg = max(4, int(round(self.sps)))
        n = (len(audio) // seg) * seg
        self._carry = audio[n:]
        t = np.arange(len(audio)) / self.fs
        half = self.shift / 2
        mark = np.abs((audio * np.exp(-2j * np.pi * (self.center + half)
                                      * t))[:n].reshape(-1, seg).sum(1))
        space = np.abs((audio * np.exp(-2j * np.pi * (self.center - half)
                                       * t))[:n].reshape(-1, seg).sum(1))
        for m, s in zip(mark, space):
            self._bits.append(1 if m > s else 0)
        self._drain()
        out = []
        if self.text:
            out.append(("chars", self.text.encode()))
            self.text = ""
        return out

    # -- bit-level framing ----------------------------------------------
    SYNC_CODES = 6     # consecutive weight-4 codes to declare sync

    def _drain(self) -> None:
        need = 7 * self.SYNC_CODES + 7
        while len(self._bits) >= (7 if self._synced else need):
            if not self._synced:
                ok = False
                for off in range(min(7, len(self._bits) - need)):
                    if all(weight(self._code_at(off + 7 * k)) == 4
                           for k in range(self.SYNC_CODES)):
                        del self._bits[:off]
                        self._synced = True
                        ok = True
                        break
                if not ok:
                    del self._bits[:1]
                    continue
            code = self._code_at(0)
            del self._bits[:7]
            self._char(code)

    def _code_at(self, off: int) -> int:
        v = 0
        for i in range(7):
            v = (v << 1) | self._bits[off + i]
        return v

    def _char(self, code: int) -> None:
        """Phase-tracked SITOR-B FEC: rep-slot characters enter the
        DX fifo; each alpha-slot character votes against its DX copy
        from two pairs earlier, and exactly ONE character is emitted
        per DX/RX pair (`CCIR476.js` process_char)."""
        ok = weight(code) == 4
        # the phasing characters force slot alignment
        if code == REP:
            self._alpha_phase = False
        elif code == ALF:
            self._alpha_phase = True
        if not self._alpha_phase:
            self._fifo = [self._fifo[1], self._fifo[2], code]
        else:
            c1 = self._fifo[0]
            chr_code = (code if ok
                        else (c1 if weight(c1) == 4 else None))
            if chr_code is None:
                self._bad_run += 1
                if self._bad_run >= 4:
                    self._synced = False    # slipped: re-phase
                    self._bad_run = 0
                self.text += "*"
            else:
                self._bad_run = 0
                self._emit(chr_code)
        self._alpha_phase = not self._alpha_phase

    def _emit(self, code: int) -> None:
        if code in (ALF, BET, REP, C32):
            return
        if code == LTR:
            self._figs = False
        elif code == FGS:
            self._figs = True
        elif self._figs and code in CODE_FIGS:
            self.text += CODE_FIGS[code]
        elif code in CODE_LTRS:
            self.text += CODE_LTRS[code]
