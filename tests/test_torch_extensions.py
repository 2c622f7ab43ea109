"""The decoder extensions of the port against the reference's, on the CPU.

- The device front ends (WSPR's mix / decimate / symbol spectra and its
  375 Hz baseband, the FT8 and FT4 spectrograms, the FFT extension's
  row) on the same audio through both packages, within 1e-5 of the
  plane's max (observed ~7e-7: float32 sums of 256 to 2048 terms in
  another order, the reference's DFT being a matmul).  The WSPR case
  runs a whole 114 s capture, so the mixer's float32 phase is held
  where it is ~1.07e6 rad; the test also shows that an exact phase
  parts from the reference there by more than 100x the bound.
- The decode scenarios of ``test_wspr_decode.py``, ``test_wspr_offair.py``,
  ``test_ft8_decode.py``, ``test_ft4.py`` and ``test_extensions.py`` on
  the port: the port's extension, fed block by block, sends the same
  decode messages as the reference's fed the same capture (the
  reference concatenates its blocks, so it is given the capture as one
  block), and the scenario's own assertions hold.
- Both kinds of taps: the engine's (tensors) and the server's
  ``HostTaps`` (host rows) give the same messages.
- A capture keeps no reference to a tap: a dropped tap tensor is freed.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fsk_audio
from flydog_sdr_gps_tpu import extensions as jext
from flydog_sdr_gps_tpu.extensions import ft4 as jft4
from flydog_sdr_gps_tpu.extensions import ft8 as jft8
from flydog_sdr_gps_tpu.extensions import wspr as jwspr
from flydog_sdr_gps_tpu.models.rx_channel import RxTaps as JRxTaps
from flydog_sdr_gps_tpu.ops.cplx import Cplx
from flydog_sdr_gps_tpu_torch import extensions as text
from flydog_sdr_gps_tpu_torch.extensions import audio_fft as tfft
from flydog_sdr_gps_tpu_torch.extensions import ft4 as tft4
from flydog_sdr_gps_tpu_torch.extensions import ft8 as tft8
from flydog_sdr_gps_tpu_torch.extensions import ft8_decode as tfd
from flydog_sdr_gps_tpu_torch.extensions import wspr as twspr
from flydog_sdr_gps_tpu_torch.extensions import wspr_decode as twd
from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps
from flydog_sdr_gps_tpu_torch.ops.channelizer import frame
from flydog_sdr_gps_tpu_torch.server.kiwi_server import HostTaps

FS = 12000.0
BOUND = 1e-5            # of the plane's max


class FakeEngine:
    """The reference tests' stub engine (no device: the taps' decides)."""
    class params:
        fs_out = FS

    source = None


class HostEngine(FakeEngine):
    device = "cpu"


def ref_taps(audio_ch0: np.ndarray) -> JRxTaps:
    a = jnp.asarray(audio_ch0[:, None].astype(np.float32))
    z = Cplx(a, jnp.zeros_like(a))
    return JRxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                   smeter_dbm=jnp.asarray([-50.0], jnp.float32))


def port_taps(audio: np.ndarray, iq: np.ndarray | None = None) -> RxTaps:
    """Device-style taps: (B, C) tensors (audio (B,) or (B, C))."""
    a = torch.from_numpy(np.asarray(audio, np.float32).reshape(
        len(audio), -1).copy())
    z = (torch.complex(a, torch.zeros_like(a)) if iq is None
         else torch.from_numpy(iq.reshape(len(iq), -1).astype(np.complex64)))
    return RxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                  smeter_dbm=torch.full((a.shape[1],), -50.0))


def host_taps(audio: np.ndarray) -> HostTaps:
    row = np.asarray(audio, np.float32)[None, :]
    return HostTaps(row, row, row, np.zeros_like(row),
                    np.array([-50.0], np.float32), {0: 0})


def stream(ext, audio, block=512, taps=port_taps, stop_on_msg=True):
    msgs = []
    for i in range(0, len(audio), block):
        blk = np.zeros(block, np.float32)
        chunk = audio[i:i + block]
        blk[:len(chunk)] = chunk
        msgs += ext.process_block(taps(blk))
        if msgs and stop_on_msg:
            break
    return msgs


def decodes(msgs):
    return [m for m in msgs if m[0].endswith("_decode")]


def _both(name, audio, capture=None, **kw):
    """The reference's extension given ``audio`` as one block, and the
    port's fed it block by block; returns (ref ext, ref msgs, port ext,
    port msgs)."""
    ref = jext.ext_create(name, FakeEngine(), 0)
    ref.start()
    port = text.ext_create(name, FakeEngine(), 0)
    port.start()
    if capture is not None:
        ref.capture_samples = port.capture_samples = capture
    n = ref.capture_samples
    rmsgs = ref.process_block(ref_taps(audio[:n]))
    pmsgs = stream(port, audio[:n], **kw)
    return ref, rmsgs, port, pmsgs


def _same_spots(ref, port):
    """The decoded spots equal; the sync metric of each (a float from
    the refined tone powers) within 1e-4 of the reference's."""
    a, b = ref.decode_candidates(), port.decode_candidates()
    strip = lambda spots: [{k: v for k, v in s.items() if k != "sync"}
                           for s in spots]
    assert strip(a) == strip(b)
    for x, y in zip(a, b):
        assert abs(x["sync"] - y["sync"]) <= 1e-4 * abs(x["sync"])
    return b


def _same_results(ref, port):
    assert len(ref.results) == len(port.results)
    for (rc, rs), (pc, ps) in zip(ref.results, port.results):
        assert (rc["bin"], rc["dt"]) == (pc["bin"], pc["dt"])
        assert np.asarray(rs).shape == np.asarray(ps).shape


# -- the registry ------------------------------------------------------------

def test_registry_follows_the_reference_order():
    ported = list(text._registry)
    assert ported == [
        "S_meter", "IQ_display", "FFT", "CW_decoder", "sig_gen", "wspr",
        "FT8", "FT4", "TDoA", "noise_blank", "noise_filter", "FSK", "NAVTEX",
        "timecode", "IBP_scan", "FAX", "colormap", "iframe", "prefs",
        "example", "devl", "waterfall", "digi_modes", "SSTV", "Loran_C",
        "ALE_2G", "s4285", "HFDL", "DRM"]
    assert ported == list(jext._registry)


# -- the device front ends ------------------------------------------------------

def _wspr_audio(seed=5, n=None):
    rng = np.random.default_rng(seed)
    n = n or int(jwspr.CAPTURE_S * FS)
    t = np.arange(n) / FS
    return (0.3 * np.sin(2 * np.pi * 1520.0 * t)
            + 0.2 * rng.standard_normal(n)).astype(np.float32)


def test_wspr_frontend_matches_reference():
    audio = _wspr_audio()
    p, br, bi = map(np.asarray, jwspr._make_frontend()(jnp.asarray(audio)))
    z = br + 1j * bi
    tp, tz = twspr.frontend(torch.from_numpy(audio))
    assert tp.dtype == torch.float32 and tz.dtype == torch.complex64
    tp, tz = tp.numpy(), tz.numpy()
    assert tp.shape == p.shape == (166, 256) and tz.shape == z.shape
    assert np.abs(tp - p).max() <= BOUND * p.max()
    zmax = np.abs(z).max()
    assert np.abs(tz - z).max() <= BOUND * zmax
    late = slice(-4000, None)           # the last ~11 s of the capture
    assert np.abs(tz[late] - z[late]).max() <= BOUND * zmax
    # an exact phase is not the reference's: late in the capture the
    # float32 phase is quantised by 0.0625 rad, and a baseband mixed with
    # the exact phase (float64, then float32) parts from the reference
    n = len(audio)
    ph = (2 * np.pi * jwspr.DIAL_OFFSET / FS * np.arange(n)) % (2 * np.pi)
    h = torch.as_tensor(twspr.FRONTEND_TAPS, dtype=torch.float32)
    m = len(h) // twspr.DECIM

    def decimate(x):
        x = torch.cat([torch.zeros((m - 1) * twspr.DECIM),
                       torch.from_numpy(x.astype(np.float32))])
        return (frame(x, twspr.DECIM, m) @ h).numpy()
    exact = decimate(audio * np.cos(ph)) + 1j * decimate(-audio * np.sin(ph))
    assert np.abs(exact[late] - z[late]).max() > 100 * BOUND * zmax


@pytest.mark.parametrize("mode", ["ft8", "ft4"])
def test_spectrogram_matches_reference(mode):
    jm, tm = {"ft8": (jft8, tft8), "ft4": (jft4, tft4)}[mode]
    cls = {"ft8": jft8.Ft8Ext, "ft4": jft4.Ft4Ext}[mode]
    audio = _wspr_audio(seed=6, n=int(cls.CAPTURE_S * FS))
    ref = np.asarray(jm._make_spectrogram()(jnp.asarray(audio)))
    got = tm.spectrogram(torch.from_numpy(audio))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape == (len(audio) // jm.SPS, jm.NFFT // 2)
    assert np.abs(got - ref).max() <= BOUND * ref.max()


def test_fft_row_matches_reference():
    rng = np.random.default_rng(7)
    n = 512
    t = np.arange(4 * n) / FS
    iq = (0.4 * np.exp(2j * np.pi * 1750.0 * t)
          + 0.01 * (rng.standard_normal(4 * n)
                    + 1j * rng.standard_normal(4 * n)))
    rows = []
    for mod, taps in ((jext, None), (text, port_taps)):
        e = mod.ext_create("FFT", FakeEngine(), 0)
        e.start(navg=2)
        out = []
        for i in range(4):
            blk = iq[i * n:(i + 1) * n]
            if taps is None:
                a = jnp.asarray(blk.real[:, None].astype(np.float32))
                z = Cplx(a, jnp.asarray(blk.imag[:, None].astype(np.float32)))
                tp = JRxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                             smeter_dbm=jnp.zeros(1))
            else:
                tp = taps(blk.real, blk)
            out += e.process_block(tp)
        assert [m[0] for m in out] == ["fft"]
        rows.append(np.frombuffer(out[0][1], "<f4"))
    ref, got = (10.0 ** (r.astype(np.float64) / 10.0) for r in rows)
    assert len(got) == tfft.FFT_N
    assert np.abs(got - ref).max() <= BOUND * ref.max()
    peak = int(np.argmax(got))
    assert peak == int(np.argmax(ref))
    assert abs((peak - tfft.FFT_N // 2) * FS / tfft.FFT_N - 1750.0) \
        <= FS / tfft.FFT_N


def test_fft_row_from_host_taps_equals_device_taps():
    rng = np.random.default_rng(8)
    iq = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048))
    outs = []
    for engine, taps in ((FakeEngine(), lambda b: port_taps(b.real, b)),
                         (HostEngine(), None)):
        e = text.ext_create("FFT", engine, 0)
        e.start()
        out = []
        for i in range(0, 2048, 512):
            b = iq[i:i + 512]
            if taps is None:
                re = b.real.astype(np.float32)[None]
                im = b.imag.astype(np.float32)[None]
                tp = HostTaps(re, re, re, im, np.zeros(1, np.float32), {0: 0})
            else:
                tp = taps(b)
            out += e.process_block(tp)
        outs.append(out)
    assert outs[0] == outs[1] and len(outs[0]) == 3


# -- the decode scenarios ----------------------------------------------------

def test_cw_decoder_decodes_text():
    from tests.test_extensions import morse_audio
    audio = morse_audio("CQ TEST")
    got = []
    for mod, taps in ((jext, ref_taps), (text, port_taps)):
        dec = mod.ext_create("CW_decoder", FakeEngine(), 0)
        dec.start(pitch=500.0, wpm=20.0)
        text_ = ""
        for i in range(0, len(audio) - 511, 512):
            for _tag, payload in dec.process_block(taps(audio[i:i + 512])):
                text_ += payload.decode()
        got.append(text_)
    assert got[0] == got[1]
    assert "CQ" in got[1] and "TEST" in got[1], got[1]


def test_s_meter_iq_and_fft_run():
    audio = np.sin(2 * np.pi * 700 * np.arange(2048) / FS)
    for name in ("S_meter", "FFT"):
        e = text.ext_create(name, FakeEngine(), 0)
        e.start()
        out = []
        for i in range(4):
            out += e.process_block(port_taps(audio[i * 512:(i + 1) * 512]))
        assert out and isinstance(out[0][1], bytes)
    assert len(np.frombuffer(out[0][1], "<f4")) == 1024
    e = text.ext_create("IQ_display", FakeEngine(), 0)
    e.start()
    assert e.process_block(host_taps(audio[:512]))[0][0] == "iq"


def test_wspr_frontend_finds_candidate():
    """``test_extensions.py``'s scenario: random 4-FSK data 40 bins below
    the dial, in noise."""
    rng = np.random.default_rng(0)
    n = int(jwspr.CAPTURE_S * FS)
    data = rng.integers(0, 2, jwspr.NSYM)
    tones = 2 * data + jwspr.SYNC.astype(np.int64)
    f0 = jwspr.DIAL_OFFSET + (-40) * jwspr.TONE_SPACING
    sig = fsk_audio(tones, f0, jwspr.TONE_SPACING, jwspr.SPS * jwspr.DECIM, n)
    sig = (0.3 * sig + 0.2 * rng.standard_normal(n)).astype(np.float32)
    ref, rmsgs, port, pmsgs = _both("wspr", sig)
    assert pmsgs and port.results
    _same_results(ref, port)
    best = port.results[0][0]
    assert abs(best["bin"] - (twspr.SPS // 2 - 40)) <= 1, best
    assert abs(best["freq"] - f0) <= 2 * twspr.TONE_SPACING, best
    assert best["sync"] > 0.25, best
    assert port.results[0][1].shape == (162,)
    assert decodes(pmsgs) == decodes(rmsgs)


def test_ft8_frontend_costas_sync():
    rng = np.random.default_rng(1)
    n = int(jft8.Ft8Ext.CAPTURE_S * FS)
    tones = rng.integers(0, 8, jft8.NSYM)
    for pos in jft8.COSTAS_POS:
        tones[pos:pos + 7] = jft8.COSTAS
    sig = fsk_audio(tones, 1000.0, jft8.BAUD, jft8.SPS, n)
    sig = (0.3 * sig + 0.15 * rng.standard_normal(n)).astype(np.float32)
    ref, _rmsgs, port, _pmsgs = _both("FT8", sig)
    _same_results(ref, port)
    best = port.results[0][0]
    assert abs(best["freq"] - 1000.0) < 3 * FS / tft8.NFFT, best
    assert port.results[0][1].shape == (58, 8)


def test_end_to_end_wspr_spot():
    """``test_wspr_decode.py``'s message at its SNR: K1ABC FN42 37."""
    tones = twd.encode_to_tones(twd.WsprMessage("K1ABC", "FN42", 37))
    n = int(jwspr.CAPTURE_S * FS)
    f0 = jwspr.DIAL_OFFSET + (-33) * jwspr.TONE_SPACING
    rng = np.random.default_rng(2)
    sig = fsk_audio(tones, f0, jwspr.TONE_SPACING, jwspr.SPS * jwspr.DECIM, n)
    sig = (0.25 * sig + 0.25 * rng.standard_normal(n)).astype(np.float32)
    ref, rmsgs, port, pmsgs = _both("wspr", sig)
    got = decodes(pmsgs)
    assert got and got == decodes(rmsgs)
    assert got[0][1].decode().startswith("K1ABC FN42 37")
    _same_spots(ref, port)


def _offair_audio():
    """``test_wspr_offair.py``'s recorded 375 Hz capture upsampled to
    12 kHz audio, as that test makes it."""
    from flydog_sdr_gps_tpu_torch.ops import filters
    z = np.load("tests/data/wspr_offair_375.npz")["iq"].astype(np.complex128)
    up = np.zeros(len(z) * twspr.DECIM, np.complex128)
    up[::twspr.DECIM] = z * twspr.DECIM
    h = filters.kaiser_lowpass(twspr.FS_AUDIO, 150.0, 220.0, 70.0,
                               numtaps=512)
    up = np.convolve(up, h, mode="same")
    t = np.arange(len(up)) / twspr.FS_AUDIO
    audio = np.real(up * np.exp(2j * np.pi * twspr.DIAL_OFFSET * t))
    return (audio / (np.abs(audio).max() + 1e-12)).astype(np.float32)


def test_offair_decode_through_extension():
    """The off-air ZL3DMH RE66 37 capture through the port's extension
    (mix, decimate, spectrogram, sync, refine, decode)."""
    audio = _offair_audio()
    n = len(audio) // 512 * 512
    ref, rmsgs, port, pmsgs = _both("wspr", audio, capture=n,
                                    stop_on_msg=False)
    spots = _same_spots(ref, port)
    assert any(s["callsign"] == "ZL3DMH" and s["grid"] == "RE66"
               and s["dbm"] == 37 for s in spots), spots
    assert decodes(pmsgs) == decodes(rmsgs)


def test_offair_decode_from_375_baseband():
    """``test_wspr_offair.py``'s host path on the recorded baseband,
    through the port's copies."""
    z = np.load("tests/data/wspr_offair_375.npz")["iq"].astype(np.complex128)
    nsym = len(z) // twspr.SPS
    segs = z[:nsym * twspr.SPS].reshape(nsym, twspr.SPS)
    power = np.abs(np.fft.fftshift(np.fft.fft(segs, axis=1),
                                   axes=1)).astype(np.float32) ** 2
    cands = twspr.sync_correlate(power, max_dt_sym=nsym - twspr.NSYM)
    assert cands == jwspr.sync_correlate(power, max_dt_sym=nsym - twspr.NSYM)
    spots = []
    for c in cands[:5]:
        r = twspr.refine_candidate(z, c)
        if r is None:
            continue
        msg = twd.decode_soft_symbols(r["soft"])
        if msg is not None:
            spots.append((msg, r))
    r = next(r for m, r in spots
             if (m.callsign, m.grid, m.dbm) == ("ZL3DMH", "RE66", 37))
    assert abs(r["freq"] - 1535.5) < 2.0 and r["sync"] > 0.5, r


@pytest.mark.parametrize("taps", ["device", "host"])
def test_end_to_end_ft8_spot(taps):
    """``test_ft8_decode.py``'s CQ K1ABC FN42 at 1200 Hz, through either
    kind of taps."""
    cw = tfd.ldpc_encode(tfd.add_crc(tfd.pack_payload(
        tfd.Ft8Message("CQ", "K1ABC", "FN42"))))
    tones = tfd.codeword_to_tones(cw)
    n = int(tft8.Ft8Ext.CAPTURE_S * FS)
    rng = np.random.default_rng(3)
    sig = fsk_audio(tones, 1200.0, tft8.BAUD, tft8.SPS, n)
    sig = (0.3 * sig + 0.2 * rng.standard_normal(n)).astype(np.float32)
    ref = jext.ext_create("FT8", FakeEngine(), 0)
    ref.start()
    rmsgs = ref.process_block(ref_taps(sig))
    port = text.ext_create("FT8", HostEngine() if taps == "host"
                           else FakeEngine(), 0)
    port.start()
    pmsgs = stream(port, sig, taps=host_taps if taps == "host"
                   else port_taps)
    got = decodes(pmsgs)
    assert got and got == decodes(rmsgs)
    assert got[0][1].decode().startswith("CQ K1ABC FN42")
    _same_results(ref, port)


def test_end_to_end_ft4_spot():
    """``test_ft4.py``'s CQ K1ABC FN42 at 1500 Hz."""
    tones = tft4.encode_tones(tfd.pack_payload(
        tfd.Ft8Message("CQ", "K1ABC", "FN42")))
    n = int(tft4.Ft4Ext.CAPTURE_S * FS)
    rng = np.random.default_rng(4)
    sig = fsk_audio(tones, 1500.0, tft4.BAUD, tft4.SPS, n)
    sig = (0.3 * sig + 0.2 * rng.standard_normal(n)).astype(np.float32)
    ref, rmsgs, port, pmsgs = _both("FT4", sig)
    got = decodes(pmsgs)
    assert got and got == decodes(rmsgs)
    assert got[0][1].decode().startswith("CQ K1ABC FN42")


CODEC_TESTS = [
    ("test_wspr_decode", "test_pack_unpack_round_trip", {}),
    ("test_wspr_decode", "test_conv_code_and_interleave_consistency", {}),
    ("test_wspr_decode", "test_decoder_tolerates_noise", {}),
    ("test_ft8_decode", "test_ldpc_encode_valid", {}),
    ("test_ft8_decode", "test_bp_decode_with_noise", {}),
    ("test_ft8_decode", "test_crc_round_trip", {}),
    ("test_ft8_decode", "test_payload_pack_unpack",
     dict(to="W9XYZ", de="K1ABC", extra="R-15")),
    ("test_ft4", "test_ft4_tone_layout", {}),
    ("test_ft4", "test_ft4_llr_round_trip", {}),
]


@pytest.mark.parametrize("module,name,kw", CODEC_TESTS,
                         ids=[f"{m}.{n}" for m, n, _ in CODEC_TESTS])
def test_reference_codec_tests_hold_on_the_port(module, name, kw,
                                                monkeypatch):
    """The reference's own codec tests (pack, convolutional code, LDPC,
    CRC, FT4 tones and LLRs), run on the port's modules."""
    import importlib
    mod = importlib.import_module(f"tests.{module}")
    for attr, port_mod in (("wd", twd), ("w", twspr), ("fd", tfd),
                           ("f8", tft8), ("f4", tft4)):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, port_mod)
    getattr(mod, name)(**kw)


# -- the capture holds no tap ------------------------------------------------------

@pytest.mark.parametrize("name", ["wspr", "FT8", "FT4"])
def test_capture_keeps_no_reference_to_a_tap(name):
    """Each block's column is copied: after the block, dropping the tap
    frees it (a view kept in the capture would keep the whole (B, C)
    tensor alive)."""
    e = text.ext_create(name, FakeEngine(), 3)
    e.start()
    e.capture_samples = 5 * 256 + 100
    rng = np.random.default_rng(9)
    full = None
    for blk in range(6):
        a = rng.standard_normal((256, 8)).astype(np.float32)
        taps = port_taps(a)
        alive = weakref.ref(taps.audio)
        storage = taps.audio.untyped_storage().data_ptr()
        e.process_block(taps)
        if blk == 0:
            full = [a[:, 3]]
        else:
            full.append(a[:, 3])
        buf = e._capture._buf
        if buf is not None:
            assert buf.untyped_storage().data_ptr() != storage
            np.testing.assert_array_equal(
                buf[:e._samples].numpy(), np.concatenate(full))
        del taps
        gc.collect()
        assert alive() is None, f"block {blk}: the tap is still referenced"
    assert e._samples == 0           # the capture completed in block 5
