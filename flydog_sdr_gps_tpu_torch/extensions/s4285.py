"""s4285 extension — STANAG 4285 HF serial-tone modem (tx + rx).

Reference: `extensions/s4285/` (~4.4k LoC: transmit, demodulate,
Kalman equalizer, convolutional FEC, interleaver).  STANAG 4285 is a
single-tone PSK modem: 1800 Hz carrier, 2400 symbols/s, 256-symbol
frames = 80-symbol sync preamble + 4 x (32 data + 12 probe) symbols.
Data and probe symbols are scrambled by a PN tribit sequence; user
rates map to the data-symbol modulation:

  2400 bps  8PSK  rate-2/3 (rate-1/2 K=7 punctured [1,1,0,1])
  1200 bps  QPSK  rate-1/2
   600 bps  BPSK  rate-1/2
   300 bps  BPSK  rate-1/2 + x2 repetition

FEC is the K=7 (171,133) code shared with the Galileo I/NAV path
(`models/gps/galileo.py`); a block interleaver spans each frame's
coded bits.  The receiver: mix 1800 Hz to baseband, RRC matched
filter, preamble correlation for frame/timing sync, frequency from
preamble-to-preamble phase drift, then an LMS feed-forward equalizer
(the reference uses Kalman) trained on the preamble and re-adapted on
every probe block, soft PSK demap -> deinterleave -> depuncture ->
Viterbi.

All of this runs at audio rate (12 kHz) on the channel taps; the
wideband front end is the shared channelizer.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column
from ..models.gps.galileo import conv_encode_k7, viterbi_decode_k7

FS = 12000.0
BAUD = 2400.0
SPS = int(FS / BAUD)                    # 5 samples/symbol, exact
FC = 1800.0
FRAME = 256                             # symbols
PREAMBLE_LEN = 80
BLOCKS = 4                              # (32 data + 12 probe) x 4
DATA_PER_FRAME = 32 * BLOCKS            # 128 data symbols

RATES = {2400: ("8psk", 3, (1, 1, 0, 1), 1),
         1200: ("qpsk", 2, None, 1),
         600: ("bpsk", 1, None, 1),
         300: ("bpsk", 1, None, 2)}


def _lfsr_tribits(n: int, seed: int = 0x1FF) -> np.ndarray:
    """PN scrambler: x^9 + x^4 + 1 LFSR, 3 output bits per tribit."""
    reg = seed & 0x1FF
    out = np.zeros(n, np.int64)
    for i in range(n):
        v = 0
        for _ in range(3):
            bit = ((reg >> 8) ^ (reg >> 3)) & 1
            reg = ((reg << 1) | bit) & 0x1FF
            v = (v << 1) | bit
        out[i] = v
    return out


PREAMBLE = _lfsr_tribits(PREAMBLE_LEN, seed=0x0B3)      # known 8PSK syms
SCRAMBLE = _lfsr_tribits(FRAME - PREAMBLE_LEN)          # per-frame PN


def rrc_taps(alpha: float = 0.35, span: int = 8,
             sps: int = SPS) -> np.ndarray:
    """Root-raised-cosine, unit energy."""
    n = span * sps
    t = (np.arange(-n, n + 1)) / sps
    h = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            h[i] = ((np.sin(np.pi * ti * (1 - alpha))
                     + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
                    / (np.pi * ti * (1 - (4 * alpha * ti) ** 2)))
    return h / np.sqrt(np.sum(h ** 2))


_RRC = rrc_taps()


def _psk8(tribits: np.ndarray) -> np.ndarray:
    return np.exp(1j * (np.pi / 4) * tribits)


# ---------------------------------------------------------------------------
# Interleaver: coded bits of one frame written row-wise into an 8-row
# matrix, read column-wise (reference uses a convolutional interleaver
# over larger spans; same burst-spreading role).
# ---------------------------------------------------------------------------

def interleave(bits: np.ndarray, rows: int = 8) -> np.ndarray:
    """Frame bit counts (128/256/384) are multiples of ``rows``."""
    return bits.reshape(rows, -1).T.reshape(-1)


def deinterleave(bits: np.ndarray, rows: int = 8) -> np.ndarray:
    return bits.reshape(-1, rows).T.reshape(-1)


# ---------------------------------------------------------------------------
# Transmit
# ---------------------------------------------------------------------------

def modulate(bits: np.ndarray, rate: int = 1200,
             amp: float = 0.5) -> np.ndarray:
    """User bits -> STANAG 4285 passband audio at 12 kHz.

    Pads with zeros to fill whole frames; prepends/appends silence.
    """
    mod, bps, punct, rep = RATES[rate]
    bits = np.asarray(bits, np.uint8)

    coded = conv_encode_k7(np.concatenate([bits, np.zeros(6, np.uint8)]))
    if punct:
        keep = np.tile(np.asarray(punct, bool), -(-len(coded) // 4))
        coded = coded[keep[:len(coded)]]
    coded = np.repeat(coded, rep)

    # chop into frames' worth of channel bits
    cbits_frame = DATA_PER_FRAME * bps
    pad = (-len(coded)) % cbits_frame
    coded = np.concatenate([coded, np.zeros(pad, np.uint8)])
    nframes = len(coded) // cbits_frame

    syms = []
    for f in range(nframes):
        fb = interleave(coded[f * cbits_frame:(f + 1) * cbits_frame])
        if mod == "8psk":
            tri = fb.reshape(-1, 3)
            d = tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]
        elif mod == "qpsk":
            di = fb.reshape(-1, 2)
            d = (di[:, 0] * 2 + di[:, 1]) * 2        # {0,2,4,6}
        else:
            d = fb * 4                                # {0,4}
        frame = np.concatenate([PREAMBLE] + [
            np.concatenate([d[b * 32:(b + 1) * 32],
                            np.zeros(12, np.int64)])
            for b in range(BLOCKS)])
        frame[PREAMBLE_LEN:] = (frame[PREAMBLE_LEN:] + SCRAMBLE) % 8
        syms.append(frame)
    symbols = np.concatenate(syms) if syms else np.zeros(0, np.int64)

    iq = _psk8(symbols)
    up = np.zeros(len(iq) * SPS, np.complex128)
    up[::SPS] = iq
    bb = np.convolve(up, _RRC)
    t = np.arange(len(bb))
    pb = np.real(bb * np.exp(2j * np.pi * FC * t / FS))
    sil = np.zeros(int(0.05 * FS))
    return (amp * np.concatenate([sil, pb, sil])).astype(np.float32)


# ---------------------------------------------------------------------------
# Receive
# ---------------------------------------------------------------------------

def _preamble_wave() -> np.ndarray:
    iq = _psk8(PREAMBLE)
    up = np.zeros(len(iq) * SPS, np.complex128)
    up[::SPS] = iq
    return np.convolve(up, _RRC)[:PREAMBLE_LEN * SPS]


class S4285Rx:
    """Streaming receiver.  feed(audio) -> list of decoded bit arrays
    (one per contiguous transmission)."""

    def __init__(self, rate: int = 1200, eq_taps: int = 7,
                 mu: float = 0.05):
        self.rate = rate
        self.eq_taps = eq_taps
        self.mu = mu
        self._audio = np.zeros(0, np.float32)
        self._n0 = 0                     # absolute index of _audio[0]
        self._pre = np.conj(_preamble_wave()[::-1])
        self._soft: list[np.ndarray] = []
        self._done: list[np.ndarray] = []
        self._last_hit = None

    def feed(self, audio: np.ndarray) -> list[np.ndarray]:
        self._audio = np.concatenate([self._audio,
                                      np.asarray(audio, np.float32)])
        out = []
        frame_samps = FRAME * SPS
        # need one frame + preamble margin to process
        while len(self._audio) >= 2 * frame_samps + len(self._pre):
            seg = self._audio[:2 * frame_samps + len(self._pre)]
            t = np.arange(self._n0, self._n0 + len(seg))
            bb = seg * np.exp(-2j * np.pi * FC * t / FS)
            bb = np.convolve(bb, _RRC)[len(_RRC) // 2:
                                       len(_RRC) // 2 + len(seg)]
            corr = np.abs(np.convolve(bb[:frame_samps + len(self._pre)],
                                      self._pre, mode="valid"))
            thresh = 4.0 * np.median(corr) + 1e-12
            above = np.nonzero(corr > thresh)[0]
            if len(above) == 0:
                self._flush(out)
                self._advance(frame_samps)
                continue
            # earliest preamble above threshold (the window can contain
            # two frames' preambles; argmax alone may skip a frame)
            i0 = int(above[0])
            w = corr[i0:i0 + 2 * SPS + 1]
            pk = i0 + int(np.argmax(w))
            delay = len(_RRC) // 2       # tx-filter group delay
            if pk + frame_samps + delay + 2 > len(bb):
                self._advance(max(pk - PREAMBLE_LEN * SPS, 1))
                continue
            # timing: the correlation peak can land +-1..2 samples off;
            # the probe check arbitrates between candidate alignments
            soft, start = None, pk
            for cand in (pk, pk - 1, pk + 1, pk - 2, pk + 2):
                if cand < 0:
                    continue
                fr = bb[cand:cand + frame_samps + delay]
                soft = self._demod_frame(fr)
                if soft is not None:
                    start = cand
                    break
            if soft is None:
                self._flush(out)
                self._advance(frame_samps)
            else:
                self._soft.append(soft)
                self._advance(start + frame_samps)
        self._done.extend(out)
        res, self._done = self._done, []
        return res

    def _advance(self, n: int) -> None:
        n = max(n, 1)
        self._audio = self._audio[n:]
        self._n0 += n

    def _flush(self, out: list) -> None:
        if self._soft:
            out.append(self._decode(np.concatenate(self._soft)))
            self._soft = []

    # -- per-frame demod with LMS equalizer ------------------------------
    def _demod_frame(self, fr: np.ndarray) -> np.ndarray | None:
        sym = fr[len(_RRC) // 2::SPS][:FRAME]    # skip tx group delay
        known = np.full(FRAME, -1, np.int64)
        known[:PREAMBLE_LEN] = PREAMBLE
        scr = (SCRAMBLE).copy()
        for b in range(BLOCKS):
            p0 = PREAMBLE_LEN + b * 44 + 32
            known[p0:p0 + 12] = scr[b * 44 + 32:b * 44 + 44]
        ref = _psk8(known)

        # coarse carrier-offset estimate from the preamble: phase slope
        # between its two halves (wipes the known symbols first)
        half = PREAMBLE_LEN // 2
        wiped = sym[:PREAMBLE_LEN] * np.conj(ref[:PREAMBLE_LEN])
        r0, r1 = np.sum(wiped[:half]), np.sum(wiped[half:])
        if abs(r0) > 1e-9 and abs(r1) > 1e-9:
            dphi = np.angle(r1 * np.conj(r0)) / half   # rad/symbol
            sym = sym * np.exp(-1j * dphi * np.arange(FRAME))

        nt = self.eq_taps
        w = np.zeros(nt, np.complex128)
        w[nt // 2] = 1.0
        # normalize input power
        sym = sym / (np.sqrt(np.mean(np.abs(sym) ** 2)) + 1e-12)
        padded = np.concatenate([np.zeros(nt // 2, np.complex128), sym,
                                 np.zeros(nt // 2, np.complex128)])
        eq = np.zeros(FRAME, np.complex128)
        # two passes over the preamble to converge, then track
        for _pass in range(2):
            for i in range(PREAMBLE_LEN):
                x = padded[i:i + nt][::-1]
                y = w @ x
                e = ref[i] - y
                w += self.mu * e * np.conj(x)
        perr = []
        for i in range(FRAME):
            x = padded[i:i + nt][::-1]
            y = w @ x
            eq[i] = y
            if known[i] >= 0:
                e = ref[i] - y
                w += self.mu * e * np.conj(x)
                perr.append(abs(e) ** 2)
        if np.mean(perr) > 0.7:
            return None                  # lost: probes unrecognizable
        # residual carrier drift: anchor the phase on the preamble tail
        # and each probe block, linearly interpolate across data symbols
        anchors_i, anchors_p = [], []
        regions = [(PREAMBLE_LEN - 16, PREAMBLE_LEN)]
        regions += [(PREAMBLE_LEN + b * 44 + 32, PREAMBLE_LEN + b * 44 + 44)
                    for b in range(BLOCKS)]
        for lo, hi in regions:
            r = np.mean(ref[lo:hi] * np.conj(eq[lo:hi]))
            if abs(r) > 1e-6:
                anchors_i.append((lo + hi) / 2)
                anchors_p.append(np.angle(r))
        if len(anchors_p) >= 2:
            ph = np.interp(np.arange(FRAME), anchors_i,
                           np.unwrap(anchors_p))
            eq = eq * np.exp(1j * ph)
        # descramble data symbols, soft demap
        mod, bps, punct, rep = RATES[self.rate]
        data = []
        for b in range(BLOCKS):
            d0 = PREAMBLE_LEN + b * 44
            rot = eq[d0:d0 + 32] * np.conj(
                _psk8(scr[b * 44:b * 44 + 32]))
            data.append(rot)
        d = np.concatenate(data)
        if mod == "8psk":
            ang = np.angle(d) / (np.pi / 4)
            tri = np.round(ang).astype(np.int64) % 8
            conf = np.abs(d)
            soft = np.zeros(len(d) * 3)
            soft[0::3] = np.where((tri >> 2) & 1, 1.0, -1.0) * conf
            soft[1::3] = np.where((tri >> 1) & 1, 1.0, -1.0) * conf
            soft[2::3] = np.where(tri & 1, 1.0, -1.0) * conf
        elif mod == "qpsk":
            # QPSK symbols are (2b0+b1)*90deg
            q = np.round((np.angle(d) % (2 * np.pi))
                         / (np.pi / 2)).astype(np.int64) % 4
            conf = np.abs(d)
            soft = np.zeros(len(d) * 2)
            soft[0::2] = np.where((q >> 1) & 1, 1.0, -1.0) * conf
            soft[1::2] = np.where(q & 1, 1.0, -1.0) * conf
        else:
            soft = -np.real(d)           # bit 1 -> 180deg
        return deinterleave(soft)

    def _decode(self, soft: np.ndarray) -> np.ndarray:
        mod, bps, punct, rep = RATES[self.rate]
        if rep > 1:
            n = (len(soft) // rep) * rep
            soft = soft[:n].reshape(-1, rep).mean(axis=1)
        if punct:
            full = np.zeros(-(-len(soft) * 4 // 3) + 4)
            keep = np.tile(np.asarray(punct, bool), len(full) // 4 + 1)
            pos = np.nonzero(keep[:len(full)])[0][:len(soft)]
            full[pos] = soft
            soft = full
        n = len(soft) - (len(soft) % 2)
        bits = viterbi_decode_k7(soft[:n], tail=False)
        return bits[:len(bits) - 6] if len(bits) > 6 else bits


@ext_register
class S4285Ext(Extension):
    name = "s4285"

    def start(self, **params):
        self.rx = S4285Rx(rate=int(params.get("rate", 1200)))

    def command(self, cmd: dict) -> list:
        if "rate" in cmd:
            self.rx = S4285Rx(rate=int(cmd["rate"]))
        return []

    def process_block(self, taps) -> list:
        audio = host_column(taps.audio, self.rx_chan, np.float32)
        out = []
        for bits in self.rx.feed(audio):
            out.append(("s4285_bits", np.packbits(bits).tobytes()))
        return out
