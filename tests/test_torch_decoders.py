"""The port's host-only decoders against the reference's, on the CPU, and
the tap reader that every extension of the port reads through.

- Every test of ``tests/test_decoders2.py`` but the four DRM ones (they
  are in ``test_torch_drm.py``) has a counterpart here.  Its seeded
  inputs go through the reference's module and through the port's.  The
  messages and return values must be equal bit for bit (``==``; arrays
  of one dtype, bytes equal), and the reference test's own assertions
  must hold of the port's.  The reference's extensions are fed its own
  ``RxTaps`` of jax arrays, as its test builds them; the port's are fed
  the port's ``RxTaps`` of torch tensors.
- Constants and tables are equal: every module-level constant of the
  copied modules (the ITA2 letters and figures, the CCIR 476 code tables,
  the ALE Golay code book among them), and the DCF77 and WWVB frame
  codecs over many dates and damaged frames.
- The synthesizers that ``chip_smoke.py`` phase 8 copies out of the
  reference's tests give the same samples as the originals, and the
  reference's decoders decode them (the scenarios below run both).
- The tap reader (``extensions/taps.py``): each registered extension of
  the port gives the reference's messages on the port's CPU ``RxTaps``
  (torch tensors, complex64 IQ) and on the port's ``HostTaps``.  The
  reference gets its own two kinds of taps.  The FFT and waterfall rows
  are float spectra from two FFT libraries; they are held within 1e-5 of
  the row's peak power, as ``test_torch_extensions.py`` holds them.
  Everything else is ``==``.
"""

import dataclasses
import importlib
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flydog_sdr_gps_tpu import extensions as jext
from flydog_sdr_gps_tpu.models.rx_channel import RxTaps as JRxTaps
from flydog_sdr_gps_tpu.ops.cplx import Cplx
from flydog_sdr_gps_tpu.server import kiwi_server as jks
from flydog_sdr_gps_tpu_torch import extensions as text
from flydog_sdr_gps_tpu_torch.extensions import taps as ttaps
from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks

sys.path.insert(0, os.path.dirname(__file__))
import test_decoders2 as ref_tests  # noqa: E402

FS = 12000.0
BOUND = 1e-5            # FFT rows: of the row's peak power

COPIED = ("fsk", "misc_ui", "noise_ui", "sig_gen", "tdoa", "navtex",
          "timecode", "ibp_scan", "fax", "sstv", "loran_c", "ale_2g",
          "s4285", "hfdl", "drm_tables", "drm_mlc", "drm", "drm_audio")


class FakeEngine:
    """The reference tests' stub engine."""
    class params:
        fs_out = FS

    source = None


def ref_taps(audio: np.ndarray) -> JRxTaps:
    """The reference tests' ``make_taps``: one channel of jax arrays."""
    a = jnp.asarray(audio[:, None].astype(np.float32))
    z = Cplx(a, jnp.zeros_like(a))
    return JRxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                   smeter_dbm=jnp.asarray([-50.0], jnp.float32))


def port_taps(audio: np.ndarray) -> RxTaps:
    """The same, as the port's engine makes taps: torch tensors."""
    a = torch.from_numpy(audio[:, None].astype(np.float32))
    z = torch.complex(a, torch.zeros_like(a))
    return RxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                  smeter_dbm=torch.tensor([-50.0]))


class Pkg:
    """One package as a scenario sees it: its extension registry, its
    modules, and the taps its engine makes."""

    def __init__(self, root, ext, taps):
        self.root, self.ext, self.taps = root, ext, taps

    def mod(self, name):
        return importlib.import_module(f"{self.root}.extensions.{name}")


REF = Pkg("flydog_sdr_gps_tpu", jext, ref_taps)
PORT = Pkg("flydog_sdr_gps_tpu_torch", text, port_taps)


def same(a, b) -> bool:
    """``==`` through dicts, lists, tuples, numpy arrays (same dtype) and
    dataclasses (each package's compared field by field)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (type(a).__name__ == type(b).__name__
                and same(dataclasses.astuple(a), dataclasses.astuple(b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(map(same, a, b)))
    return type(a) is type(b) and a == b


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on the reference and on the port; the
    results must be equal.  Returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert same(got, want), (got, want)
    return got


def feed(P, e, audio, block=512):
    """The reference tests' loop: whole 512-sample blocks, the tail
    dropped."""
    out = []
    for i in range(0, len(audio) - block + 1, block):
        out += e.process_block(P.taps(audio[i:i + block]))
    return out


def run_ext(P, name, audio, **params):
    e = P.ext.ext_create(name, FakeEngine(), 0)
    e.start(**params)
    return "".join(p.decode() for t, p in feed(P, e, audio)
                   if t in ("chars", "time"))


# -- constants, tables, codecs ------------------------------------------------

CONST_TYPES = (int, float, str, bytes, tuple, list, dict, frozenset,
               np.ndarray, np.generic)


def module_constants(mod):
    """Every module-level value that is data (public and private)."""
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and isinstance(v, CONST_TYPES)}


@pytest.mark.parametrize("name", COPIED)
def test_module_constants_equal(name):
    jm, tm = REF.mod(name), PORT.mod(name)
    a, b = module_constants(jm), module_constants(tm)
    assert a.keys() == b.keys()
    for k in a:
        assert same(b[k], a[k]), (name, k)


def test_code_tables_equal():
    jf, tf = REF.mod("fsk"), PORT.mod("fsk")
    assert (tf.ITA2_LTRS, tf.ITA2_FIGS, tf.FIGS, tf.LTRS) == \
        (jf.ITA2_LTRS, jf.ITA2_FIGS, jf.FIGS, jf.LTRS)
    assert len(tf.ITA2_LTRS) == len(tf.ITA2_FIGS) == 32
    jn, tn = REF.mod("navtex"), PORT.mod("navtex")
    for k in ("CODE_LTRS", "CODE_FIGS", "LTRS_CODE", "FIGS_CODE"):
        assert getattr(tn, k) == getattr(jn, k), k
    # every CCIR 476 character code has four 1-bits of seven
    assert all(tn.weight(c) == 4 for c in tn.CODE_LTRS)
    assert [tn.encode_text(s) for s in ("NAV WARNING 42", "TEST 1/2?")] \
        == [jn.encode_text(s) for s in ("NAV WARNING 42", "TEST 1/2?")]
    ja, ta = REF.mod("ale_2g"), PORT.mod("ale_2g")
    assert same(ta._CODEBOOK, ja._CODEBOOK) and ta._CODEBOOK.shape == (4096,)
    assert same(ta._POPCNT, ja._POPCNT)
    assert [ta.golay_encode(d) for d in range(4096)] == \
        [ja.golay_encode(d) for d in range(4096)]


def test_time_codecs_equal():
    jt, tt = REF.mod("timecode"), PORT.mod("timecode")
    rng = np.random.default_rng(4)
    for _ in range(200):
        kw = dict(minute=int(rng.integers(0, 60)),
                  hour=int(rng.integers(0, 24)),
                  day=int(rng.integers(1, 29)),
                  month=int(rng.integers(1, 13)),
                  year=int(rng.integers(0, 100)))
        bits = tt.encode_dcf77_frame(tt.DecodedTime(**kw))
        assert bits == jt.encode_dcf77_frame(jt.DecodedTime(**kw))
        assert str(tt.decode_dcf77_frame(bits)) == \
            str(jt.decode_dcf77_frame(bits)) == str(tt.DecodedTime(**kw))
        bad = list(bits)
        bad[int(rng.integers(21, 59))] ^= 1
        assert same(tt.decode_dcf77_frame(bad), jt.decode_dcf77_frame(bad))
        syms = [int(v) for v in rng.integers(0, 3, 60)]
        for i in (0, 9, 19, 29, 39, 49, 59):
            syms[i] = 2
        assert same(tt.decode_wwvb_frame(syms), jt.decode_wwvb_frame(syms))


def test_phase8_synthesizers_equal_the_reference_tests():
    inv = {c: i for i, c in enumerate(PORT.mod("fsk").ITA2_LTRS)}
    codes = [PORT.mod("fsk").LTRS] + [inv[c] for c in "RYRY CQ"]
    for args in ((45.45, 1000.0, 170.0), (50.0, 1500.0, 450.0)):
        a = chip_smoke.rtty_audio(codes, *args)
        b = ref_tests.fsk_audio(codes, *args)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for gri, secs in ((6731, 6.0), (8000, 5.0)):
        a, b = chip_smoke.loran_audio(gri, secs), ref_tests.loran_audio(gri,
                                                                      secs)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


# -- test_decoders2.py, case by case -----------------------------------------

def _rtty(P):
    fsk = P.mod("fsk")
    inv = {c: i for i, c in enumerate(fsk.ITA2_LTRS)}
    codes = [fsk.LTRS] + [inv[c] for c in "CQ DX"]
    audio = chip_smoke.rtty_audio(codes, 45.45, 1000.0, 170.0)
    return run_ext(P, "FSK", audio, center=1000.0, shift=170.0, baud=45.45)


def test_rtty_decodes_text():
    got = both(_rtty)
    assert "CQ DX" in got, repr(got)


def _navtex(P):
    codes = P.mod("navtex").encode_text("NAV WARNING 42")
    audio = chip_smoke.navtex_audio(codes)
    return codes, run_ext(P, "NAVTEX", audio, center=1000.0)


def test_navtex_decodes_text():
    _codes, got = both(_navtex)
    assert "NAV WARNING 42" in got, repr(got)


def _dcf77(P):
    tc = P.mod("timecode")
    t0 = tc.DecodedTime(minute=37, hour=14, day=17, month=8, year=26)
    bits = tc.encode_dcf77_frame(t0)
    bad = list(bits)
    bad[22] ^= 1
    return bits, tc.decode_dcf77_frame(bits), tc.decode_dcf77_frame(bad)


def test_dcf77_frame_round_trip():
    _bits, t1, bad = both(_dcf77)
    assert t1 is not None and str(t1) == "2026-08-17 14:37"
    assert bad is None


def _timecode_am(P):
    tc = P.mod("timecode")
    bits = tc.encode_dcf77_frame(
        tc.DecodedTime(minute=5, hour=9, day=2, month=3, year=24))
    return run_ext(P, "timecode", chip_smoke.dcf77_audio(bits))


def test_timecode_ext_decodes_am_seconds():
    got = both(_timecode_am)
    assert "2024-03-02 09:05" in got, repr(got)


def _fax(P):
    e = P.mod("fax").FaxExt(FakeEngine(), 0)
    e.start(lpm=120.0, px=256)
    audio = chip_smoke.fax_audio(e.line_samples)
    return [np.frombuffer(p, np.uint8) for t, p in feed(P, e, audio)
            if t == "fax_line"]


def test_fax_decodes_line_pattern():
    rows = both(_fax)
    assert len(rows) >= 3
    row = rows[2].astype(np.float64) / 255.0
    assert row[96:120].mean() > 0.7
    assert row[140:185].mean() < 0.3


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_003.5)


def _ibp(P):
    class Eng:
        class params:
            fs_out = FS
        source = None

        def set_channel(self, ch, **kw):
            self.last = kw
    eng = Eng()
    e = P.mod("ibp_scan").IbpScanExt(eng, 0)
    e.start(band=2)
    out = e.process_block(P.taps(np.zeros(512, np.float32)))
    return eng.last, out, e.readings


def test_ibp_scan_reports(fixed_clock):
    last, out, readings = both(_ibp)
    assert last["freq_hz"] == 21150.0e3
    assert out and out[0][0] == "ibp"
    assert len(readings) == 1


def _sstv(P):
    audio = chip_smoke.sstv_audio(P.mod("sstv"))
    e = P.ext.ext_create("SSTV", FakeEngine(), 0)
    e.start(px=64)
    msgs = feed(P, e, audio)
    return ([p.decode() for t, p in msgs if t == "sstv_mode"],
            [np.frombuffer(p[1:], np.uint8).reshape(3, 64)
             for t, p in msgs if t == "sstv_line"])


def test_sstv_martin_m1_round_trip():
    mode_msgs, lines = both(_sstv)
    assert mode_msgs == ["Martin M1"], mode_msgs
    assert len(lines) >= 6, len(lines)
    r, g, b = lines[3].astype(np.float64) / 255.0
    assert g[8:24].mean() > 0.7 and g[40:56].mean() < 0.3
    assert r[8:24].mean() < 0.3 and r[40:56].mean() > 0.7
    assert b.mean() < 0.2


def _loran_fold(P):
    lc = P.mod("loran_c")
    gri = 6731
    audio = chip_smoke.loran_audio(gri, 6.0)
    best, score = lc.search_gri(np.abs(audio.astype(np.float64)), FS)
    e = P.ext.ext_create("Loran_C", FakeEngine(), 0)
    e.start(gri0=gri, gri1=8000)
    rows = {t: np.frombuffer(p, np.uint8) for t, p in feed(P, e, audio)}
    e.command({"avg_algo0": "cma"})
    return best, score, rows, e.chains[0].navgs


def test_loran_c_fold_and_search():
    best, score, rows, navgs = both(_loran_fold)
    assert best == 6731, (best, score)
    assert score > 3.0, score
    assert "scope0" in rows and "scope1" in rows
    s0, s1 = rows["scope0"].astype(float), rows["scope1"].astype(float)
    assert s0.max() == 255 and np.median(s0) < 60
    contrast0 = s0.max() / max(np.median(s0), 1)
    contrast1 = s1.max() / max(np.median(s1), 1)
    assert contrast0 > 2.5 * contrast1, (contrast0, contrast1)
    assert navgs == 0


def _ale_golay(P):
    ale = P.mod("ale_2g")
    rng = np.random.default_rng(3)
    out = []
    for _ in range(50):
        d = int(rng.integers(0, 4096))
        cw = ale.golay_encode(d)
        for nerr in (0, 1, 2, 3):
            bad = cw
            for pos in rng.choice(24, nerr, replace=False):
                bad ^= 1 << int(pos)
            out.append((d, nerr, ale.golay_decode(bad)))
    return out


def test_ale_golay():
    for d, nerr, (dd, e) in both(_ale_golay):
        assert dd == d and e == nerr


def _ale_word(P):
    ale = P.mod("ale_2g")
    w = ale.word_pack("TIS", "SAM")
    syms = ale.word_symbols(w)
    f = ale.frame_bits(w)
    stream = np.concatenate([f, 1 - f[:10], f[10:], f])
    votes = stream[:49].astype(int) + stream[49:98] + stream[98:147]
    return (w, ale.word_unpack(w), syms,
            ale.frame_decode((votes >= 2).astype(np.uint8)))


def test_ale_word_roundtrip():
    w, unpacked, syms, (word24, nerr) = both(_ale_word)
    assert unpacked == ("TIS", "SAM")
    assert syms.shape == (49,) and syms.max() <= 7
    assert word24 == w and nerr == 0


def _ale_e2e(P):
    ale = P.mod("ale_2g")
    rng = np.random.default_rng(11)
    audio = ale.modulate([("TO", "HQ@"), ("TO", "HQ@"), ("TIS", "SAM")],
                         fs=FS)
    audio = audio + 0.15 * rng.standard_normal(len(audio)).astype(
        np.float32)
    e = P.ext.ext_create("ALE_2G", FakeEngine(), 0)
    e.start()
    return [p.decode() for t, p in feed(P, e, audio) if t == "ale_word"]


def test_ale_end_to_end():
    words = both(_ale_e2e)
    got = [w.split(" (")[0] for w in words]
    assert "[TO] HQ@" in got and "[TIS] SAM" in got, words
    assert len(got) >= 3, words


def _doppler(audio, dopp_hz):
    """The reference tests' analytic-signal frequency shift."""
    z = np.fft.ifft(np.fft.fft(audio) *
                    (np.arange(len(audio)) < len(audio) // 2) * 2)
    t = np.arange(len(z))
    return np.real(z * np.exp(2j * np.pi * dopp_hz * t / FS))


def _s4285_loopback(P, rate, dopp_hz=0.0, seed=2, nbits=200, noise=0.05):
    s = P.mod("s4285")
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    audio = s.modulate(bits, rate=rate).astype(np.float64)
    if dopp_hz:
        audio = _doppler(audio, dopp_hz)
    audio = (audio + noise * rng.standard_normal(len(audio))).astype(
        np.float32)
    rx = s.S4285Rx(rate=rate)
    out = []
    for i in range(0, len(audio) - 511, 512):
        out.extend(rx.feed(audio[i:i + 512]))
    out.extend(rx.feed(np.zeros(20000, np.float32)))
    dec = np.concatenate(out) if out else np.zeros(0, np.uint8)
    n = min(len(dec), nbits)
    return dec, n, float(np.mean(dec[:n] != bits[:n])) if n else 1.0


@pytest.mark.parametrize("rate", [2400, 1200, 600, 300])
def test_s4285_rates(rate):
    _dec, n, ber = both(_s4285_loopback, rate)
    assert n == 200 and ber == 0.0, (rate, n, ber)


def test_s4285_doppler():
    _dec, n, ber = both(lambda P: _s4285_loopback(P, 1200, dopp_hz=3.0,
                                                  seed=9))
    assert n == 200 and ber == 0.0, (n, ber)
    _dec, n, ber = both(lambda P: _s4285_loopback(P, 2400, dopp_hz=2.0,
                                                  seed=13))
    assert n == 200 and ber == 0.0, (n, ber)


def _s4285_ext(P):
    s = P.mod("s4285")
    bits = np.random.default_rng(21).integers(0, 2, 100).astype(np.uint8)
    audio = np.concatenate([s.modulate(bits, rate=1200),
                            np.zeros(20000, np.float32)])
    e = P.ext.ext_create("s4285", FakeEngine(), 0)
    e.start(rate=1200)
    return bits, feed(P, e, audio)


def test_s4285_via_extension():
    bits, msgs = both(_s4285_ext)
    assert all(t == "s4285_bits" for t, _ in msgs)
    dec = np.unpackbits(np.frombuffer(b"".join(p for _, p in msgs),
                                      np.uint8))
    assert len(dec) >= 100
    assert np.array_equal(dec[:100], bits)


def _hfdl_loopback(P, rate, dopp_hz=0.0, noise=0.04, nbytes=20):
    h = P.mod("hfdl")
    rng = np.random.default_rng(rate + int(dopp_hz * 10))
    payload = bytes(rng.integers(0, 256, nbytes, dtype=np.uint8).tolist())
    audio = h.modulate(h.make_mpdu(payload), rate=rate).astype(np.float64)
    if dopp_hz:
        audio = _doppler(audio, dopp_hz)
    audio = (audio + noise * rng.standard_normal(len(audio))).astype(
        np.float32)
    rx = h.HfdlRx()
    got = []
    for i in range(0, len(audio) - 511, 512):
        got.extend(rx.feed(audio[i:i + 512]))
    got.extend(rx.feed(np.zeros(60000, np.float32)))
    return payload, got


@pytest.mark.parametrize("rate", [1800, 1200, 600, 300])
def test_hfdl_rates(rate):
    payload, got = both(_hfdl_loopback, rate)
    assert any(p == payload and r == rate for r, p in got), got


def test_hfdl_doppler():
    payload, got = both(lambda P: _hfdl_loopback(P, 1800, dopp_hz=2.0))
    assert any(p == payload for r, p in got), got


def _hfdl_crc(P):
    h = P.mod("hfdl")
    bits = h.make_mpdu(b"hello hfdl")
    bad = bits.copy()
    bad[40] ^= 1
    return bits, h.parse_mpdu(bits), h.parse_mpdu(bad)


def test_hfdl_crc_rejects_garbage():
    _bits, ok, bad = both(_hfdl_crc)
    assert ok == b"hello hfdl"
    assert bad is None


def _hfdl_ext(P):
    h = P.mod("hfdl")
    audio = np.concatenate([h.modulate(h.make_mpdu(b"SQUITTER 01"),
                                       rate=1200),
                            np.zeros(60000, np.float32)])
    e = P.ext.ext_create("HFDL", FakeEngine(), 0)
    e.start()
    return feed(P, e, audio)


def test_hfdl_via_extension():
    msgs = both(_hfdl_ext)
    assert all(t == "hfdl_mpdu" for t, _ in msgs)
    assert any(p.decode() == "1200|" + b"SQUITTER 01".hex()
               for _, p in msgs), msgs


def _loran_search(P):
    audio = chip_smoke.loran_audio(8000, 5.0)
    e = P.ext.ext_create("Loran_C", FakeEngine(), 0)
    e.start(gri0=6731, gri1=5030)
    e.command({"search": True})
    return [p.decode() for t, p in feed(P, e, audio) if t == "gri_found"]


def test_loran_c_search_command():
    found = both(_loran_search)
    assert found and found[0].split()[0] == "8000", found


def _wwvb_syms():
    """The published NIST example frame (2008-07-08 07:30 UTC), as
    ``test_wwvb_published_frame`` writes it."""
    M = 2
    syms = [0] * 60
    for i in (0, 9, 19, 29, 39, 49, 59):
        syms[i] = M
    syms[2] = syms[3] = 1
    syms[16] = syms[17] = syms[18] = 1
    syms[23] = syms[25] = syms[28] = 1
    syms[50] = 1
    syms[55] = 1
    return syms


def _wwvb_frame(P):
    tc = P.mod("timecode")
    bad = _wwvb_syms()
    bad[29] = 0
    return tc.decode_wwvb_frame(_wwvb_syms()), tc.decode_wwvb_frame(bad)


def test_wwvb_published_frame():
    t, bad = both(_wwvb_frame)
    assert t is not None and str(t) == "2008-07-08 07:30", t
    assert bad is None


def _wwvb_audio(P):
    spb = int(FS)
    dur = {0: 0.2, 1: 0.5, 2: 0.8}
    tone = np.sin(2 * np.pi * 1000.0 * np.arange(spb) / FS)
    chunks = []
    for s in _wwvb_syms() + [2, 0, 0]:
        env = np.ones(spb)
        env[:int(dur[s] * FS)] = 0.1
        chunks.append((tone * env).astype(np.float32))
    return run_ext(P, "timecode", np.concatenate(chunks), station="WWVB")


def test_wwvb_audio_end_to_end():
    got = both(_wwvb_audio)
    assert "2008-07-08 07:30" in got, repr(got)


class _AudioTaps:
    """``test_wefax_ioc576_spec_timing``'s taps: an ``audio`` attribute
    only (a (B, 1) numpy array for the reference, a tensor for the port)."""

    def __init__(self, seg):
        self.audio = seg


def _wefax(P):
    nline = int(FS * 60 / 120.0)
    f_b, f_w = 1500.0, 2300.0
    t = np.arange(int(2 * FS))
    start = np.where((t * 600.0 / FS).astype(int) % 2 == 0, f_w, f_b)
    pw = int(0.05 * nline)
    phline = np.full(nline, f_b)
    phline[:pw // 2] = f_w
    phline[-pw // 2:] = f_w
    img = np.full(nline, f_b)
    img[int(.25 * nline):int(.35 * nline)] = f_w
    img[int(.60 * nline):int(.70 * nline)] = f_w
    audio = ref_tests._wefax_fm(np.concatenate(
        [start, np.tile(phline, 4), np.tile(img, 6)])).reshape(-1, 1)

    class Eng:
        class params:
            fs_out = FS
            audio_block = 1024
    e = P.mod("fax").FaxExt(Eng(), 0)
    e.start(lpm=120, px=512)
    msgs = []
    for i in range(0, len(audio) - 1023, 1024):
        seg = audio[i:i + 1024]
        msgs.extend(e.process_block(_AudioTaps(
            seg if P is REF else torch.from_numpy(seg))))
    return msgs


def test_wefax_ioc576_spec_timing():
    msgs = both(_wefax)
    status = [p for t_, p in msgs if t_ == "fax_status"]
    assert any(b"start_tone ioc=576" in s for s in status), status
    rows = [np.frombuffer(p, np.uint8) for t_, p in msgs if t_ == "fax_line"]
    assert len(rows) >= 6
    for r in rows[-3:]:
        assert r[int(.28 * 512):int(.32 * 512)].mean() > 180
        assert r[int(.63 * 512):int(.67 * 512)].mean() > 180
        assert r[int(.45 * 512):int(.55 * 512)].mean() < 60
        assert r[int(.80 * 512):int(.90 * 512)].mean() < 60


def _loran_spec(P):
    lc = P.mod("loran_c")
    gri, n = 9960, int(6.0 * FS)
    audio = 0.02 * np.random.default_rng(11).standard_normal(n)
    tp = np.arange(0.0, 300e-6, 1.0 / FS)
    env = (tp / 65e-6) ** 2 * np.exp(2 * (1 - tp / 65e-6))
    period = FS * gri / 1e5
    t0 = 0.0
    while t0 < n:
        for o in [k * 1e-3 for k in range(8)] + [7e-3 + 2e-3]:
            lo = int(t0 + o * FS)
            if lo + len(env) < n:
                audio[lo:lo + len(env)] += env
        t0 += period
    audio = audio.astype(np.float32)
    best, score = lc.search_gri(np.abs(audio.astype(np.float64)), FS)
    e = P.ext.ext_create("Loran_C", FakeEngine(), 0)
    e.start(gri0=gri, gri1=5030)
    rows = {t: np.frombuffer(p, np.uint8) for t, p in feed(P, e, audio)}
    return best, score, rows


def test_loran_c_spec_pulse_group():
    best, score, rows = both(_loran_spec)
    assert best == 9960, (best, score)
    s0 = rows["scope0"].astype(float)
    assert s0.max() == 255 and np.median(s0) < 60
    hot = s0 > 128
    groups = np.sum(np.diff(hot.astype(int)) == 1) + int(hot[0])
    assert groups >= 8, groups


# -- the tap reader -----------------------------------------------------------

B, C, CH = 512, 3, 2            # a block; channels; the extension's channel
CHMAP = {CH: 0, 0: 1}           # HostTaps: the subscribed channels' rows

# start parameters and commands of each registered name
TAP_CASES = {
    "S_meter": ({}, []),
    "IQ_display": ({"points": "16"}, []),
    "FFT": ({}, []),
    "CW_decoder": ({}, []),
    "sig_gen": ({}, [{"freq": "7000000", "amp": "0.3"}]),
    "wspr": ({}, []),
    "FT8": ({}, []),
    "FT4": ({}, []),
    "TDoA": ({}, []),
    "noise_blank": ({}, [{"enable": "1"}]),
    "noise_filter": ({}, [{"enable": "0"}]),
    "FSK": ({}, []),
    "NAVTEX": ({}, []),
    "timecode": ({}, []),
    "IBP_scan": ({"band": "2"}, []),
    "FAX": ({}, []),
    "colormap": ({}, [{"list": "1"}, {"get": "grey"}]),
    "iframe": ({}, [{"get": "1"}]),
    "prefs": ({}, [{"set": "1", "key": "tap-reader", "value": "v"},
                   {"get": "1", "key": "tap-reader"}]),
    "example": ({}, [{"ping": "1"}]),
    "devl": ({}, []),
    "waterfall": ({"avg": "1"}, []),
    "digi_modes": ({}, [{"preset": "rtty45"}]),
    "SSTV": ({}, []),
    "Loran_C": ({}, []),
    "ALE_2G": ({}, []),
    "s4285": ({}, []),
    "HFDL": ({}, []),
    "DRM": ({}, []),
}


class StubEngine:
    """What an extension may ask of an engine: the output rate, retuning,
    the GPS timestamp, the source, the configuration, the device."""
    class params:
        fs_out = FS
        audio_block = B

    device = "cpu"
    cfg = None

    def __init__(self):
        self.calls = []
        self.source = types.SimpleNamespace(tones=[])

    def set_channel(self, ch, **kw):
        self.calls.append((ch, sorted(kw.items())))

    def gps_timestamp(self):
        return 0x123456789ABC, 1_700_000_000.25


def _tap_blocks():
    """Three seeded blocks: audio (B, C) (a 1 kHz tone in noise), IQ (B, C)
    complex, S-meter (C,)."""
    rng = np.random.default_rng(17)
    t = np.arange(3 * B) / FS
    out = []
    for k in range(3):
        tone = np.sin(2 * np.pi * 1000.0 * t[k * B:(k + 1) * B])
        audio = (0.5 * tone[:, None]
                 + 0.1 * rng.standard_normal((B, C))).astype(np.float32)
        iq = (rng.standard_normal((B, C))
              + 1j * rng.standard_normal((B, C))).astype(np.complex64)
        smeter = rng.uniform(-120.0, -20.0, C).astype(np.float32)
        out.append((audio, iq, smeter))
    return out


def _host_rows(x):
    rows = np.empty((len(CHMAP), x.shape[0]), x.dtype)
    for ch, i in CHMAP.items():
        rows[i] = x[:, ch]
    return rows


def make_taps(pkg: str, kind: str, audio, iq, smeter):
    if kind == "host":
        ks = jks if pkg == "ref" else tks
        a = _host_rows(audio)
        return ks.HostTaps(a, a[:, ::-1].copy(), _host_rows(iq.real.copy()),
                           _host_rows(iq.imag.copy()), smeter, dict(CHMAP))
    if pkg == "ref":
        a = jnp.asarray(audio)
        z = Cplx(jnp.asarray(iq.real.copy()), jnp.asarray(iq.imag.copy()))
        return JRxTaps(audio=a, audio2=a[::-1], iq_pre_fir=z, iq_post_agc=z,
                       smeter_dbm=jnp.asarray(smeter))
    a = torch.from_numpy(audio)
    z = torch.from_numpy(iq)
    return RxTaps(audio=a, audio2=a.flip(0), iq_pre_fir=z, iq_post_agc=z,
                  smeter_dbm=torch.from_numpy(smeter))


def _tap_run(pkg: str, kind: str, name: str):
    params, cmds = TAP_CASES[name]
    reg = jext if pkg == "ref" else text
    eng = StubEngine()
    e = reg.ext_create(name, eng, CH)
    e.start(**params)
    msgs = [e.command(c) for c in cmds]
    for audio, iq, smeter in _tap_blocks():
        msgs.append(e.process_block(make_taps(pkg, kind, audio, iq, smeter)))
    e.stop()
    return msgs, eng.calls, eng.source.tones


def _fft_rows_close(got, want):
    """FFT/waterfall messages: tags equal, rows within ``BOUND`` of the
    row's peak power."""
    assert [[t for t, _ in m] for m in got] == \
        [[t for t, _ in m] for m in want]
    rows = 0
    for mg, mw in zip(got, want):
        for (_, pg), (_, pw) in zip(mg, mw):
            g = 10.0 ** (np.frombuffer(pg, "<f4").astype(np.float64) / 10.0)
            w = 10.0 ** (np.frombuffer(pw, "<f4").astype(np.float64) / 10.0)
            assert np.abs(g - w).max() <= BOUND * w.max()
            rows += 1
    assert rows


def test_tap_cases_cover_the_registry():
    assert list(TAP_CASES) == list(text._registry) == list(jext._registry)


@pytest.mark.parametrize("name", list(TAP_CASES))
def test_extension_reads_both_kinds_of_taps(name, fixed_clock):
    runs = {(pkg, kind): _tap_run(pkg, kind, name)
            for pkg in ("ref", "port") for kind in ("engine", "host")}
    for kind in ("engine", "host"):
        (pm, pcalls, ptones), (rm, rcalls, rtones) = \
            runs["port", kind], runs["ref", kind]
        assert pcalls == rcalls and ptones == rtones
        if name in ("FFT", "waterfall"):
            _fft_rows_close(pm, rm)
        else:
            assert pm == rm, (kind, pm, rm)
    # the two kinds carry the same samples: the port's messages agree
    assert runs["port", "engine"][0] == runs["port", "host"][0]


@pytest.mark.parametrize("kind", ["engine", "host"])
def test_tap_reader_columns(kind):
    audio, iq, smeter = _tap_blocks()[0]
    taps = make_taps("port", kind, audio, iq, smeter)
    col = ttaps.host_column(taps.audio, CH, np.float64)
    assert col.dtype == np.float64 and np.array_equal(col, audio[:, CH])
    col2 = ttaps.host_column(taps.audio2, CH)
    assert col2.dtype == np.float32 and np.array_equal(
        col2, audio[::-1, CH])
    re, im = ttaps.host_iq(taps.iq_post_agc, CH)
    assert re.dtype == im.dtype == np.float32
    assert np.array_equal(re, iq[:, CH].real)
    assert np.array_equal(im, iq[:, CH].imag)
    assert ttaps.host_smeter(taps.smeter_dbm, CH) == float(smeter[CH])
    # a copy, never a view of the tap
    want_a, want_re = audio[:, CH].copy(), iq[:, CH].real.copy()
    col2[:] = 0
    re[:] = 0
    assert np.array_equal(ttaps.host_column(taps.audio2, CH),
                          want_a[::-1])
    assert np.array_equal(ttaps.host_iq(taps.iq_post_agc, CH)[0], want_re)
