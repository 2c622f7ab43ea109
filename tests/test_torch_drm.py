"""The port's DRM receiver (``drm``, ``drm_mlc``, ``drm_tables``,
``drm_audio``) against the reference's, on the CPU.

Every test of ``tests/test_drm_mlc.py`` and ``tests/test_drm_tables.py``,
and the four DRM tests of ``tests/test_decoders2.py``, has a counterpart
here.  Its seeded inputs go through the reference's modules and through
the port's.  The results must be equal bit for bit (``==``; arrays of one
dtype), and the reference test's own assertions must hold of the port's.
The cell maps are also held against ``test_drm_tables.py``'s literal
transcription of Dream's table builder, as that test holds the
reference's.  The extension is fed the post-AGC IQ tap: the reference's
as a ``Cplx`` of jax arrays, the port's as a complex64 tensor.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu.models.rx_channel import RxTaps as JRxTaps
from flydog_sdr_gps_tpu.ops.cplx import Cplx
from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps

sys.path.insert(0, os.path.dirname(__file__))
from test_drm_tables import _reference_make_table  # noqa: E402
from test_torch_decoders import PORT, REF, FakeEngine, both  # noqa: E402


# -- test_decoders2.py --------------------------------------------------------

def _drm_loopback(P, chan=None, noise=0.01, seed=2):
    drm = P.mod("drm")
    tx = drm.DrmTx(service_id=0xA1B2C3, label_idx=7)
    bb = tx.superframe(b"Radio TPU", b"MSC data service bytes").astype(
        np.complex128)
    rng = np.random.default_rng(seed)
    sig = np.concatenate([np.zeros(777, np.complex128), bb, bb,
                          np.zeros(2000, np.complex128)])
    if chan:
        sig = chan(sig)
    sig = sig + noise * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))
    rx = drm.DrmRx()
    got = []
    for i in range(0, len(sig) - 511, 512):
        got.extend(rx.feed(sig[i:i + 512].astype(np.complex64)))
    return got


def test_drm_loopback_clean():
    d = dict(both(_drm_loopback))
    assert d.get("drm_sdc") == b"Radio TPU"
    assert d.get("drm_msc") == b"MSC data service bytes"
    fac = d["drm_fac"]
    assert fac["service_id"] == 0xA1B2C3 and fac["label_idx"] == 7
    assert fac["msc_qam"] == 16


def _multipath_cfo(s):
    t = np.arange(len(s))
    return (s + 0.3 * np.roll(s, 12)) * np.exp(2j * np.pi * 8.0 * t / 12000.0)


def test_drm_cfo_and_multipath():
    tags = [t for t, _ in both(lambda P: _drm_loopback(P, _multipath_cfo))]
    assert "drm_sdc" in tags and "drm_msc" in tags, tags


def _fac_crc(P):
    drm = P.mod("drm")
    bits = drm.fac_pack(0x123456, 3, msc_qam=16, frame_idx=1)
    bad = bits.copy()
    bad[5] ^= 1
    return bits, drm.fac_unpack(bits), drm.fac_unpack(bad)


def test_drm_fac_crc():
    _bits, fac, bad = both(_fac_crc)
    assert fac["service_id"] == 0x123456 and fac["label_idx"] == 3
    assert fac["msc_qam"] == 16 and fac["frame_idx"] == 1
    assert fac["sdc_qam"] == 4 and fac["interleaver_short"] is True
    assert bad is None


def _iq_taps(P, seg):
    re = seg.real[:, None].astype(np.float32)
    im = seg.imag[:, None].astype(np.float32)
    if P is REF:
        a = jnp.asarray(re)
        z = Cplx(a, jnp.asarray(im))
        return JRxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                       smeter_dbm=jnp.asarray([-50.0], jnp.float32))
    a = torch.from_numpy(re)
    z = torch.complex(a, torch.from_numpy(im))
    return RxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                  smeter_dbm=torch.tensor([-50.0]))


def _drm_ext(P):
    tx = P.mod("drm").DrmTx()
    bb = np.concatenate([tx.superframe(b"S", b"M"),
                         np.zeros(4000, np.complex64)])
    e = P.ext.ext_create("DRM", FakeEngine(), 0)
    e.start()
    msgs = []
    for i in range(0, len(bb) - 511, 512):
        msgs.extend(e.process_block(_iq_taps(P, bb[i:i + 512])))
    return msgs


def test_drm_via_extension_iq_tap():
    tags = [t for t, _ in both(_drm_ext)]
    assert "drm_fac" in tags and "drm_sdc" in tags and "drm_msc" in tags


# -- test_drm_mlc.py ----------------------------------------------------------

def _fac_puncture(P):
    m = P.mod("drm_mlc")
    t = m.gen_punct_table(True, 65, 0, 72, 0, m.RATE_FAC, 0)
    return t, [m.PP_0011, m.PP_0001, m.PP_0011], sum(
        len(m._EMIT[pp]) for pp in t)


def test_fac_puncture_table():
    t, cyc, total = both(_fac_puncture)
    assert len(t) == 78
    assert t == [cyc[i % 3] for i in range(78)]
    assert total == 130


def _sdc_tail(P):
    m = P.mod("drm_mlc")
    n = 207
    t = m.gen_punct_table(False, n, 0, (2 * n - 12) // 2, 0, m.RATE_SDC4, 0)
    return t, m.PP_0011, sum(len(m._EMIT[pp]) for pp in t)


def test_sdc_tailbit_pattern_selection():
    t, pp_0011, total = both(_sdc_tail)
    assert t[-6:] == [pp_0011] * 6
    assert total == 2 * 207


def _mother_code(P):
    m = P.mod("drm_mlc")
    return m.conv_encode(np.array([1, 0, 0, 0, 0, 0, 0], np.uint8),
                         [m.PP_1111] * 13)


def test_mother_code_generators():
    streams = both(_mother_code).reshape(-1, 4).T
    for j, g in enumerate((0o133, 0o171, 0o145, 0o133)):
        assert streams[j][:7].tolist() == [int(c) for c in f"{g:07b}"], j


def test_interleaver_perm_golden():
    p = both(lambda P: P.mod("drm_mlc").interleaver_perm(130, 21))
    assert p[0] == 0 and p[1] == 63 and p[2] == 106 and p[3] == 4
    assert sorted(p.tolist()) == list(range(130))


def _dispersal(P):
    m = P.mod("drm_mlc")
    x = np.random.default_rng(0).integers(0, 2, 100).astype(np.uint8)
    return (m.energy_dispersal(np.zeros(16, np.uint8)),
            m.energy_dispersal(m.energy_dispersal(x)), x)


def test_energy_dispersal_prbs():
    got, twice, x = both(_dispersal)
    state = [1] * 9
    want = []
    for _ in range(16):
        b = state[4] ^ state[8]
        want.append(b)
        state = [b] + state[:8]
    assert got.tolist() == want
    assert np.array_equal(twice, x)


def test_qam_tables_match_etsi_normalisation():
    q16, q64 = both(lambda P: (P.mod("drm_mlc").QAM16,
                               P.mod("drm_mlc").QAM64))
    assert np.allclose(q16, np.array([3, -1, 1, -3]) / np.sqrt(10))
    assert np.isclose(q64[0], 1.0801234497, atol=1e-9)
    assert np.isclose(q64[3], -0.7715167498, atol=1e-9)


def _mlc_roundtrip(P):
    m = P.mod("drm_mlc")
    rng = np.random.default_rng(7)
    out = []
    for chan, n, lv, prot in (("fac", 65, 1, 0), ("sdc", 207, 1, 0),
                              ("sdc", 207, 2, 0), ("msc", 800, 2, 1),
                              ("msc", 800, 3, 1)):
        p = m.MlcParams(chan, n, levels=lv, protection=prot)
        bits = rng.integers(0, 2, p.total_bits).astype(np.uint8)
        cells = p.encode(bits)
        noisy = cells + 0.08 * (rng.standard_normal(n)
                                + 1j * rng.standard_normal(n))
        out.append((bits, cells, p.decode(noisy)))
    return out


def test_mlc_roundtrip_with_noise_all_schemes():
    for bits, cells, dec in both(_mlc_roundtrip):
        assert len(cells) in (65, 207, 800)
        assert np.array_equal(dec, bits)


def _loopback_64qam(P):
    drm = P.mod("drm")
    tx = drm.DrmTx(service_id=0x00BEEF, label_idx=2, msc_qam=64)
    bb = tx.superframe(b"sixtyfour", b"MSC 64-QAM payload").astype(
        np.complex128)
    rng = np.random.default_rng(3)
    sig = np.concatenate([np.zeros(500), bb, bb, np.zeros(2000)])
    sig = sig + 0.005 * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))
    rx = drm.DrmRx()
    got = []
    for i in range(0, len(sig) - 511, 512):
        got.extend(rx.feed(sig[i:i + 512].astype(np.complex64)))
    return got


def test_drm_loopback_64qam():
    d = dict(both(_loopback_64qam))
    assert d.get("drm_sdc") == b"sixtyfour"
    assert d.get("drm_msc") == b"MSC 64-QAM payload"
    assert d["drm_fac"]["msc_qam"] == 64


def _super_frame(P):
    da = P.mod("drm_audio")
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
              for n in (120, 95, 130, 88, 60)]
    sf = da.build_super_frame(frames, total_len=700)
    bad = bytearray(sf)
    bad[20 + 5 + 3] ^= 0xFF
    junk = bytearray(sf)
    junk[0] = 0xFF
    junk[1] = 0xFF
    return (frames, sf, da.parse_super_frame(sf),
            da.parse_super_frame(bytes(bad)),
            da.parse_super_frame(bytes(junk)))


def test_audio_super_frame_roundtrip():
    frames, sf, got, bad, junk = both(_super_frame)
    assert len(sf) == 700
    assert got is not None and len(got) == 5
    for k in range(4):
        au, ok = got[k]
        assert ok and au == frames[k]
    au, ok = got[4]
    assert ok and au.startswith(frames[4])
    assert bad[0][1] is False and bad[1][1] is True
    assert junk is None


def _audio_service(P):
    drm = P.mod("drm")
    rng = np.random.default_rng(6)
    per_frame = [[rng.integers(0, 256, 90 + 10 * k).astype(
        np.uint8).tobytes() for k in range(5)] for _ in range(3)]
    tx = drm.DrmTx(service_id=0x00AD10, label_idx=1)
    bb = tx.superframe(b"audio svc", per_frame).astype(np.complex128)
    sig = np.concatenate([np.zeros(600), bb, bb, np.zeros(2000)])
    sig = sig + 0.004 * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))
    rx = drm.DrmRx(msc_audio=True)
    got = []
    for i in range(0, len(sig) - 511, 512):
        got.extend(rx.feed(sig[i:i + 512].astype(np.complex64)))
    return per_frame, got


def test_drm_audio_service_loopback():
    per_frame, got = both(_audio_service)
    aus = [p for t, p in got if t == "drm_audio_frame"]
    want = [au for fr in per_frame for au in fr]
    hits = sum(1 for w in want if any(a.startswith(w) for a in aus))
    assert hits >= 14, (hits, len(aus))


def _long_interleaver(P):
    drm = P.mod("drm")
    tx = drm.DrmTx(service_id=0x00C0DE, label_idx=4, interleaver="long")
    sfs = [tx.superframe(b"long ilv", b"LONG interleaver payload").astype(
        np.complex128) for _ in range(4)]
    rng = np.random.default_rng(9)
    sig = np.concatenate([np.zeros(700)] + sfs + [np.zeros(3000)])
    sig = sig + 0.004 * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))
    rx = drm.DrmRx()
    got = []
    for i in range(0, len(sig) - 511, 512):
        got.extend(rx.feed(sig[i:i + 512].astype(np.complex64)))
    return got


def test_drm_long_interleaver_loopback():
    d = dict(both(_long_interleaver))
    assert d["drm_fac"]["interleaver_short"] is False
    assert d.get("drm_sdc") == b"long ilv"
    assert d.get("drm_msc") == b"LONG interleaver payload"


# -- test_drm_tables.py -------------------------------------------------------

def _cell_map(P, mode, so):
    cm = P.mod("drm_tables").make_cell_map(mode, so)
    return cm.kinds, cm.pilots, (cm.kmin, cm.kmax, cm.tu, cm.guard,
                                 cm.syms_per_frame, cm.syms_per_super)


@pytest.mark.parametrize("mode,so", [
    ("A", 3), ("B", 2), ("B", 3), ("C", 3), ("D", 3), ("B", 0),
    ("A", 5), ("B", 5), ("C", 5), ("D", 5)])
def test_cell_map_matches_reference_algorithm(mode, so):
    got_kinds, got_pilots, _ = both(_cell_map, mode, so)
    kinds, pilots = _reference_make_table(mode, so)
    assert got_kinds.shape == kinds.shape
    assert np.array_equal(got_kinds, kinds), (mode, so)
    assert np.allclose(got_pilots, pilots, atol=1e-12), (mode, so)


def _mode_b_so3(P):
    dt = P.mod("drm_tables")
    cm = dt.make_cell_map("B", 3)
    fac_pos = tuple((s % 15, k) for s in range(15, 30)
                    for k in cm.cells_of(dt.CM_FAC, s))
    angles = [(np.angle(cm.pilots[sym, k - cm.kmin]),
               np.angle(np.exp(2j * np.pi * ph / 1024)))
              for sym in (0, 7, 29, 44) for (k, ph) in dt.FREQ_PILOTS["B"]]
    boosted = set()
    for sym in range(cm.syms_per_super):
        boosted |= set(cm.cells_of(dt.CM_BOOSTED_PI, sym).tolist())
    scat = [(sym, cm.cells_of(dt.CM_SCAT_PI, sym))
            for sym in (0, 1, 2, 3, 16, 31)]
    return ((cm.kmin, cm.kmax, cm.tu, cm.guard, cm.syms_per_frame),
            fac_pos, dt.FAC_CELLS["B"], angles,
            (cm.count(dt.CM_SDC), cm.count(dt.CM_FAC), cm.count(dt.CM_MSC)),
            sorted(boosted), scat)


def test_mode_b_so3_known_structure():
    shape, fac_pos, fac_cells, angles, counts, boosted, scat = \
        both(_mode_b_so3)
    assert shape == (-103, 103, 256, 64, 15)
    assert fac_pos == fac_cells
    assert all(np.isclose(a, b, atol=1e-9) for a, b in angles)
    sdc, fac, msc = counts
    assert sdc == 322 and fac == 3 * 65 and 3 * 2337 <= msc <= 3 * 2338
    assert boosted == [-103, -101, 101, 103]
    for sym, ks in scat:
        assert all((k - 1 - 2 * (sym % 15 % 3)) % 6 == 0 for k in ks)


def test_make_cell_map_every_mode_equal():
    """The whole table object, every field, for each (mode, occupancy)
    the reference builds."""
    jt, tt = REF.mod("drm_tables"), PORT.mod("drm_tables")
    n = 0
    for mode in "ABCD":
        for so in range(6):
            try:
                want = jt.make_cell_map(mode, so)
            except (KeyError, ValueError, IndexError):
                with pytest.raises((KeyError, ValueError, IndexError)):
                    tt.make_cell_map(mode, so)
                continue
            got = tt.make_cell_map(mode, so)
            assert vars(got).keys() == vars(want).keys()
            for k, v in vars(want).items():
                g = getattr(got, k)
                if isinstance(v, np.ndarray):
                    assert g.dtype == v.dtype and np.array_equal(g, v), k
                else:
                    assert g == v, k
            n += 1
    assert n >= 10
