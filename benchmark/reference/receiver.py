"""Plain reference of one receiver block for a few channels.

The DDC (stage-1 filter bank, the exact 48-bit rotator, stage-2
decimation) runs in torch on any device, the audio back half (passband
FastFIR, S-meter, AGC, AM/SSB/SAM demodulation, the LMS notch and
denoiser, spectral NR, the squelches) in numpy on the host, each sample
loop written out.  ``prec="ref"`` computes in float64; ``prec="tf32"``
in float32 with every matrix product in TF32 (the control: the step
below the configuration's float32).

State is a flat dict keyed by the program's field paths (``"ddc.y_tail"``,
``"agc.env_db"``, ...), each a numpy array whose last axis is the
channel: a step follows the program from its own state entering a block
(:func:`step`), and :func:`init_state` is where a stream starts.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from scipy import signal as sp_signal

from . import design as dz

_MASK24 = (1 << 24) - 1


def _ft(prec):
    return np.float64 if prec == "ref" else np.float32


def _ct(prec):
    return np.complex128 if prec == "ref" else np.complex64


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits, nearest
    even): what a TF32 product does to its operands."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b``: float64, or TF32 (both operands rounded to TF32, the
    products summed in float32: what a TF32 product does on a card's
    tensor cores, here on any device and for any shape)."""
    if prec == "ref":
        return a.double() @ b.double()
    return tf32_round(a.float()) @ tf32_round(b.float())


def ramp_words(phi0: np.ndarray, dphi: np.ndarray, n: int,
               device) -> torch.Tensor:
    """Exact (phi0 + m*dphi) mod 2**48 for m in [0, n): (n, lanes) int64
    (the product split at 24 bits, so that nothing overflows)."""
    m = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    d = torch.as_tensor(np.asarray(dphi, np.int64), device=device)[None]
    p = torch.as_tensor(np.asarray(phi0, np.int64), device=device)[None]
    lo, hi = d & _MASK24, d >> 24
    return (p + m * lo + (((m * hi) & _MASK24) << 24)) & dz.MASK48


def rotator(words: torch.Tensor, prec: str) -> torch.Tensor:
    ang = (-2.0 * np.pi / 2.0 ** 48) * words.double()
    rot = torch.polar(torch.ones_like(ang), ang)
    return rot if prec == "ref" else rot.to(torch.complex64)


def _cplx_mm(frames: torch.Tensor, taps: torch.Tensor, prec: str):
    """Real frames (rows, taps) times complex taps (taps, lanes)."""
    re = matmul(frames, taps.real, prec)
    im = matmul(frames, taps.imag, prec)
    return torch.complex(re, im)


class Lanes:
    """The channels a run listens to, as the tuning the listeners' SET
    commands ask for: frequency, mode, passband, the NR switches.  The
    tuning words (and the stage-1 bank they mix by) are those of
    ``clock``, the nominal ADC clock unless a clock correction retuned
    the engine (:meth:`at`)."""

    def __init__(self, p: dz.Plan, lanes: list[dict],
                 clock: float | None = None):
        self.p = p
        self.freqs = [ln["freq_hz"] for ln in lanes]
        self.mode_id = np.array([dz.MODES.get(ln["mode"], dz.MODES["usb"])
                                 for ln in lanes])
        self.coef = np.stack([dz.passband_coef(p, *ln["passband"])
                              for ln in lanes], -1)
        self.notch = np.array([ln.get("nr_notch", False) for ln in lanes])
        self.den = np.array([ln.get("nr_den", False) for ln in lanes])
        self.spectral = np.array([ln.get("nr_spectral", False)
                                  for ln in lanes])
        if (self.mode_id >= dz.MODES["sal"]).any() or \
                (self.mode_id == dz.MODES["nbfm"]).any():
            raise NotImplementedError("the reference has no SAM sideband "
                                      "or NBFM lane")
        self._tune(p.adc_clock if clock is None else float(clock))
        self._at = {self.clock: self}

    def _tune(self, clock: float) -> None:
        self.clock = clock
        words = [dz.fcw(f, clock) for f in self.freqs]
        self.dphi = np.array([(w * self.p.d1) & dz.MASK48 for w in words],
                             np.int64)
        self.bank = np.stack([dz.bank_column(self.p, w) for w in words], -1)

    def at(self, clock: float) -> "Lanes":
        """The same lanes under the tuning words of ``clock``: what a
        clock correction's retune changes (the decimation plan, the
        passbands and the switches stay)."""
        got = self._at.get(clock)
        if got is None:
            got = copy.copy(self)           # shares ``_at``
            got._tune(clock)
            self._at[clock] = got
        return got


class Clocks:
    """The clock whose tuning words each block of the stream ran under:
    ``nominal`` until the first switch, then each switch's clock from
    its first block on.  ``switches``: (first block, clock), in the order
    of their first blocks."""

    def __init__(self, nominal: float, switches=()):
        self.nominal = nominal
        self.switches = list(switches)

    def of(self, n: int) -> float:
        """The clock of block ``n``."""
        clock = self.nominal
        for first, c in self.switches:
            if first > n:
                break
            clock = c
        return clock

    def runs(self, n: int) -> list[tuple[int, float]]:
        """(blocks, clock) of blocks 0 to n - 1, in order."""
        out, start, clock = [], 0, self.nominal
        for first, c in self.switches:
            if first >= n:
                break
            if first > start:
                out.append((first - start, clock))
                start = first
            clock = c
        if n > start:
            out.append((n - start, clock))
        return out


def phase_entering(lanes: Lanes, clocks: Clocks, n: int) -> np.ndarray:
    """Each lane's 48-bit rotator word entering block ``n``: the sum,
    over the blocks before it, of each block's own ``k1 * dphi``, modulo
    2**48 (exact Python integers)."""
    acc = [0] * len(lanes.dphi)
    for count, clock in clocks.runs(n):
        step = [count * lanes.p.k1 * int(d) for d in lanes.at(clock).dphi]
        acc = [(a + s) & dz.MASK48 for a, s in zip(acc, step)]
    return np.array(acc, np.int64)


def init_state(p: dz.Plan, n: int) -> dict:
    """Where a stream starts (the program's initial values)."""
    f, c = np.float64, np.complex128
    hb = dz.NR["fft"] // 2 + 1
    return {
        "ddc.x_tail": np.zeros(p.tail1, f),
        "ddc.y_tail": np.zeros((p.tail2, n), c),
        "ddc.phi1": np.zeros(n, np.int64),
        "fir_tail": np.zeros((p.ntaps - 1, n), c),
        "agc.delay": np.zeros((dz.AGC["delay"], n), c),
        "agc.env_db": np.full(n, -160.0),
        "agc.hang": np.zeros(n, np.int64),
        "dc": np.zeros((2, n), f),
        "sam.phase": np.zeros(n, f), "sam.freq": np.zeros(n, f),
        "sam.dc": np.zeros((2, n), f),
        "fm_last": np.ones(n, c),
        "squelch.noise": np.ones(n, f),
        "squelch.open_": np.zeros(n, bool),
        "squelch.tail": np.zeros(n, np.int64),
        "rssi_sq.ring": np.zeros((dz.N_RSSI, n), f),
        "rssi_sq.count": np.zeros((), np.int64),
        "rssi_sq.open_": np.zeros(n, bool),
        "rssi_sq.tail": np.zeros(n, np.int64),
        "nb_mavg": np.full(n, 1e-3),
        "nr.in_tail": np.zeros((dz.NR["hop"], n), f),
        "nr.out_tail": np.zeros((dz.NR["hop"], n), f),
        "nr.psd_smooth": np.full((hb, n), 1e3),
        "nr.min_ring": np.full((dz.NR["min_window"], hb, n), 1e3),
        "nr.xhat2": np.zeros((hb, n), f),
        "lms_notch.weights": np.zeros((dz.LMS["taps"], n), f),
        "lms_notch.line": np.zeros((dz.LMS["taps"] + dz.LMS["delay"], n), f),
        "lms_den.weights": np.zeros((dz.LMS["taps"], n), f),
        "lms_den.line": np.zeros((dz.LMS["taps"] + dz.LMS["delay"], n), f),
        "sb_tail": np.zeros((p.ntaps - 1, n), c),
        "smeter": np.zeros(n, f),
        "deemph": np.zeros(n, f),
    }


# ---------------------------------------------------------------------------
# the DDC
# ---------------------------------------------------------------------------

def ddc(lanes: Lanes, st: dict, x: torch.Tensor, prec: str
        ) -> tuple[np.ndarray, dict]:
    """Stage 1 (the bank product), the exact rotator and stage 2.  ``x``
    is the block (float32, on the device the work runs on).  Returns the
    (audio_block, lanes) baseband and the new DDC carries; the stage-1
    carry stays unrotated (the phase of its first row is phi1 less
    tail2 increments)."""
    p, dev = lanes.p, x.device
    real = torch.float64 if prec == "ref" else torch.float32
    x_ext = torch.cat([torch.as_tensor(st["ddc.x_tail"], device=dev)
                       .to(real), x.to(real)])
    frames = x_ext.unfold(0, p.l1, p.d1)                       # (k1, L1)
    bank = torch.as_tensor(lanes.bank, device=dev)
    if prec != "ref":
        bank = bank.to(torch.complex64)
    y = _cplx_mm(frames, bank, prec)                           # (k1, n)
    del frames
    y_tail = torch.as_tensor(st["ddc.y_tail"], device=dev).to(y.dtype)
    y_ext = torch.cat([y_tail, y])
    phi1 = st["ddc.phi1"].astype(np.int64)
    # The carry rows were made in the block before and are rotated here,
    # back from phi1, by THIS block's word.  So after a retune the first
    # stage-2 span reads them under the new word, not under the word
    # they were made with, which the plain arithmetic would use.  The
    # program's fused stage 2 does the same (models/rx_channel.py,
    # ``_ddc``'s "fused" branch, as the JAX package's fused path does),
    # and this reference models it: benchmark/tests/test_bench_retune.py
    # shows the two differ in that span alone.
    phi0 = [(int(a) - p.tail2 * int(d)) & dz.MASK48
            for a, d in zip(phi1, lanes.dphi)]
    yr = y_ext * rotator(ramp_words(np.array(phi0, np.int64), lanes.dphi,
                                    y_ext.shape[0], dev), prec)
    h2 = torch.as_tensor(p.h2, device=dev).to(real)
    fr = yr.unfold(0, p.l2, p.d2)                              # (k2, n, L2)
    k2, n = fr.shape[0], fr.shape[1]
    fr = fr.reshape(k2 * n, p.l2)
    out = torch.complex(matmul(fr.real, h2[:, None], prec),
                        matmul(fr.imag, h2[:, None], prec)).reshape(k2, n)
    new = {
        "ddc.x_tail": x[-p.tail1:].double().cpu().numpy(),
        "ddc.y_tail": y_ext[-p.tail2:].cpu().numpy(),
        "ddc.phi1": np.array([(int(a) + p.k1 * int(d)) & dz.MASK48
                              for a, d in zip(phi1, lanes.dphi)], np.int64),
    }
    return out.cpu().numpy().astype(_ct(prec)), new


def stream_carries(lanes: Lanes, block_of, n: int, device,
                   clocks: Clocks | None = None) -> dict:
    """The carries entering block ``n`` that the stream alone fixes: the
    ADC tail, the stage-1 carry, the rotator words (each block before
    ``n`` advancing them by its own ``k1`` increments from zero:
    :func:`phase_entering`) and the passband FIR's input tail.  Their
    memory is finite, so the DDC run over the few blocks before ``n``
    from where a stream starts, each block under its own clock's words
    (``clocks``; by default ``lanes``' clock throughout), gives them
    exactly (float64), with nothing of the program.  ``block_of(m)``:
    the samples of block m."""
    p = lanes.p
    clocks = clocks or Clocks(lanes.clock)
    fir_blocks = -(-(p.ntaps - 1) // p.hop)
    m0 = max(0, n - fir_blocks - 1)
    st = init_state(p, len(lanes.dphi))
    if m0 > 0:
        st["ddc.x_tail"] = np.asarray(block_of(m0 - 1)[-p.tail1:],
                                      np.float64)
    st["ddc.phi1"] = phase_entering(lanes, clocks, m0)
    fir = st["fir_tail"]
    for m in range(m0, n):
        x = torch.as_tensor(block_of(m), device=device)
        iq, new = ddc(lanes.at(clocks.of(m)), st, x, "ref")
        st.update(new)
        fir = np.concatenate([fir, iq])[p.hop:]
    return {"ddc.x_tail": st["ddc.x_tail"], "ddc.y_tail": st["ddc.y_tail"],
            "ddc.phi1": st["ddc.phi1"], "fir_tail": fir}


# ---------------------------------------------------------------------------
# the audio back half
# ---------------------------------------------------------------------------

def _one_pole(x, a, y0):
    """y[n] = (1 - a) y[n-1] + a x[n]."""
    y, _ = sp_signal.lfilter([a], [1.0, -(1.0 - a)], x, axis=0,
                             zi=((1.0 - a) * y0)[None])
    return y.astype(x.dtype)


def _dc_block(x, st):
    """y[n] = x[n] - x[n-1] + r y[n-1]; st = [x[-1], y[-1]]."""
    u = x - np.concatenate([st[0:1], x[:-1]])
    y, _ = sp_signal.lfilter([1.0], [1.0, -dz.DC_R], u, axis=0,
                             zi=(dz.DC_R * st[1])[None])
    y = y.astype(x.dtype)
    return y, np.stack([x[-1], y[-1]])


def _agc(p, z, st, ft):
    fs = p.fs_out
    atk = ft(1.0 - np.exp(-1.0 / (fs * dz.AGC["attack_ms"] * 1e-3)))
    dec = ft(1.0 - np.exp(-1.0 / (fs * dz.AGC["decay_ms"] * 1e-3)))
    mag_db = (20.0 * np.log10(np.abs(z) + 1e-12)).astype(ft)
    env = st["agc.env_db"].astype(ft)
    hang = st["agc.hang"].astype(np.int64)
    env_seq = np.empty_like(mag_db)
    for n in range(mag_db.shape[0]):
        m = mag_db[n]
        rising = m > env
        env = np.where(rising, env + atk * (m - env),
                       np.where(hang > 0, env, env + dec * (m - env)))
        hang = np.where(rising, 0, np.maximum(hang - 1, 0))
        env_seq[n] = env
    knee, slope = dz.AGC["threshold_db"], dz.AGC["slope_db"]
    target = 20.0 * np.log10(dz.AGC["out_target"])
    gain_db = np.where(env_seq >= knee,
                       target - env_seq + slope * (env_seq - knee) / 100.0,
                       target - knee)
    gain = 10.0 ** (np.minimum(gain_db, dz.AGC["max_gain_db"]) / 20.0)
    buf = np.concatenate([st["agc.delay"].astype(z.dtype), z])
    n = z.shape[0]
    return (buf[:n] * gain).astype(z.dtype), {
        "agc.delay": buf[n:], "agc.env_db": env, "agc.hang": hang}


def _sam(p, z, st, ft):
    wn = 2 * np.pi * dz.SAM["bandwidth_hz"]
    g1 = ft(2 * dz.SAM["zeta"] * wn / p.fs_out)
    g2 = ft(wn * wn / (p.fs_out * p.fs_out))
    fmax = ft(2 * np.pi * dz.SAM["fmax_hz"] / p.fs_out)
    pi, two_pi = ft(np.pi), ft(2 * np.pi)
    phase = st["sam.phase"].astype(ft)
    freq = st["sam.freq"].astype(ft)
    zr, zi = z.real, z.imag
    v = np.empty_like(z)
    for n in range(z.shape[0]):
        c, s = np.cos(phase), -np.sin(phase)
        vr = zr[n] * c - zi[n] * s
        vi = zr[n] * s + zi[n] * c
        err = np.arctan2(vi, vr)
        freq = np.clip(freq + g2 * err, -fmax, fmax)
        p2 = phase + freq + g1 * err
        phase = np.where(p2 > pi, p2 - two_pi,
                         np.where(p2 < -pi, p2 + two_pi, p2))
        v[n] = vr + 1j * vi
    audio, dc = _dc_block(v.real, st["sam.dc"].astype(ft))
    return audio, {"sam.phase": phase, "sam.freq": freq, "sam.dc": dc}


def _lms_chain(x, st, en_notch, en_den, ft):
    taps, mu, decay = dz.LMS["taps"], ft(dz.LMS["mu"]), ft(dz.LMS["decay"])
    wn, ln = st["lms_notch.weights"].astype(ft), st["lms_notch.line"].astype(ft)
    wd, ld = st["lms_den.weights"].astype(ft), st["lms_den.line"].astype(ft)

    def stage(w, line, xn, en, notch):
        ref = line[:taps]
        pred = np.sum(w * ref, axis=0)
        err = xn - pred
        norm = np.sum(ref * ref, axis=0) + ft(1e-3)
        w2 = decay * w + (mu / norm) * err[None] * ref
        w = np.where(en[None], w2, w)
        line = np.concatenate([line[1:], xn[None]])
        return w, line, np.where(en, err if notch else pred, xn)

    y = np.empty_like(x)
    for n in range(x.shape[0]):
        wn, ln, y1 = stage(wn, ln, x[n], en_notch, True)
        wd, ld, y[n] = stage(wd, ld, y1, en_den, False)
    return y, {"lms_notch.weights": wn, "lms_notch.line": ln,
               "lms_den.weights": wd, "lms_den.line": ld}


def _spectral_nr(x, st, ft):
    hop, fft = dz.NR["hop"], dz.NR["fft"]
    n = x.shape[0]
    xin = np.concatenate([st["nr.in_tail"].astype(ft), x])
    nfr = n // hop
    idx = np.arange(nfr)[:, None] * hop + np.arange(fft)[None]
    frames = xin[idx]                                   # (nfr, fft, lanes)
    win = np.hanning(fft + 1)[:fft].astype(ft)
    spec = np.fft.fft(frames * win[None, :, None], axis=1)[:, :fft // 2 + 1]
    psd = (spec.real ** 2 + spec.imag ** 2).astype(ft)
    sm = st["nr.psd_smooth"].astype(ft)
    sm_seq = []
    for i in range(nfr):
        sm = sm + ft(dz.NR["smooth_alpha"]) * (psd[i] - sm)
        sm_seq.append(sm)
    sm_seq = np.stack(sm_seq)
    ring = np.concatenate([st["nr.min_ring"].astype(ft)[1:],
                           sm_seq.min(axis=0)[None]])
    est = ft(dz.NR["floor_bias"]) * ring.min(axis=0)
    gain = np.maximum(1.0 - dz.NR["over_subtract"] * est[None]
                      / np.maximum(sm_seq, 1e-12), dz.NR["gain_floor"] ** 2)
    shaped = spec * np.sqrt(gain)
    out_frames = np.fft.irfft(shaped, n=fft, axis=1) * win[None, :, None]
    y = np.zeros(((nfr + 1) * hop, x.shape[1]), ft)
    y[:nfr * hop] += out_frames[:, :hop].reshape(nfr * hop, -1)
    y[hop:] += out_frames[:, hop:].reshape(nfr * hop, -1)
    y = y / ft(1.5)
    out = y[:n].copy()
    out[:hop] += st["nr.out_tail"].astype(ft)
    return out.astype(ft), {
        "nr.in_tail": xin[-hop:], "nr.out_tail": y[n:],
        "nr.psd_smooth": sm, "nr.min_ring": ring,
        "nr.xhat2": st["nr.xhat2"]}


def back_half(lanes: Lanes, st: dict, iq: np.ndarray, prec: str
              ) -> tuple[dict, dict]:
    """Blanker statistics, passband FIR, S-meter, AGC, demodulation, NR,
    squelches and the overload mute, as the block program orders them.
    Returns (taps, new state)."""
    p, ft, ct = lanes.p, _ft(prec), _ct(prec)
    new = {}
    mag = np.abs(iq)
    a = dz.NB["alpha"]
    new["nb_mavg"] = ((1.0 - a) * st["nb_mavg"] + a * mag.mean(axis=0)
                      ).astype(ft)

    buf = np.concatenate([st["fir_tail"].astype(ct), iq])
    coef = lanes.coef.astype(ct)
    z = np.fft.ifft(np.fft.fft(buf, axis=0) * coef, axis=0)[p.ntaps - 1:]
    z = z.astype(ct)
    new["fir_tail"] = buf[p.hop:]

    pw = (z.real ** 2 + z.imag ** 2).astype(ft)
    filt = _one_pole(pw, ft(dz.SMETER_ATTACK), st["smeter"].astype(ft))
    dbm = 10.0 * np.log10(filt + 1e-30) + dz.SMETER_CAL_DBM
    peak = dbm.max(axis=0).astype(ft)
    new["smeter"] = filt[-1]

    zg, agc_new = _agc(p, z, st, ft)
    new.update(agc_new)
    am, new["dc"] = _dc_block(np.abs(zg).astype(ft), st["dc"].astype(ft))
    ssb = zg.real.astype(ft)
    new["fm_last"] = zg[-1]
    sam, sam_new = _sam(p, zg, st, ft)
    new.update(sam_new)
    new["sb_tail"] = st["sb_tail"]

    mode = lanes.mode_id[None]
    is_am = (mode == dz.MODES["am"]) | (mode == dz.MODES["amn"])
    audio = np.where(is_am, am,
                     np.where(mode >= dz.MODES["sam"], sam, ssb)).astype(ft)
    if (lanes.notch | lanes.den).any():
        audio, lms_new = _lms_chain(audio, st, lanes.notch, lanes.den, ft)
        new.update(lms_new)
    else:
        new.update({k: st[k] for k in st if k.startswith("lms_")})
    if lanes.spectral.any():
        nr_audio, nr_new = _spectral_nr(audio, st, ft)
        audio = np.where(lanes.spectral[None], nr_audio, audio)
        new.update(nr_new)
    else:
        new.update({k: st[k] for k in st if k.startswith("nr.")})

    # FM noise squelch, open (threshold 0): its statistic still advances
    hf = audio[1:] - audio[:-1]
    new["squelch.noise"] = (0.8 * st["squelch.noise"]
                            + 0.2 * np.mean(hf * hf, axis=0)).astype(ft)
    lanes_n = audio.shape[1]
    new["squelch.tail"] = np.full(lanes_n, dz.SQUELCH_TAIL, np.int64)
    new["squelch.open_"] = np.ones(lanes_n, bool)
    # RSSI squelch, inactive (threshold 0): its ring still fills
    count = int(st["rssi_sq.count"])
    ring = st["rssi_sq.ring"].astype(ft).copy()
    ring[count % dz.N_RSSI] = peak
    med = np.sort(ring, axis=0)[dz.N_RSSI // 2]
    green = peak >= med - np.where(st["rssi_sq.open_"], 6.0, 0.0)
    new["rssi_sq.ring"] = ring
    new["rssi_sq.count"] = np.array(count + 1, np.int64)
    new["rssi_sq.tail"] = np.where(
        green, dz.SQUELCH_TAIL,
        np.maximum(st["rssi_sq.tail"].astype(np.int64) - 1, 0))
    new["rssi_sq.open_"] = np.zeros(lanes_n, bool)
    new["deemph"] = st["deemph"]
    audio = np.where((peak > dz.MUTE_OVER_DBM)[None], 0.0, audio).astype(ft)
    taps = {"audio": audio, "iq": zg, "smeter_dbm": peak}
    return taps, new


def step(lanes: Lanes, st: dict, x: torch.Tensor, prec: str = "ref"
         ) -> tuple[dict, dict]:
    """One block from state ``st``: (taps, new state)."""
    iq, new = ddc(lanes, st, x, prec)
    taps, rest = back_half(lanes, st, iq, prec)
    new.update(rest)
    return taps, new
