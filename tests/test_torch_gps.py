"""The port's GPS/Galileo receiver against the JAX package's, on the CPU.

The same numpy inputs go through both: the IF front end and FFT
acquisition, the tracking bank (the port's plain version; the CUDA
kernel is held against it in ``test_torch_cuda.py``), the synthetic sky
and the manager started from one state (``convert.gps_manager_from_ref``).

Tolerances:
- ``downsample_if``: exact (two nonzero terms a sum, one rounding);
- ``acquire_power``: within 1e-4 of the plane's max (the reference's
  matmul FFT and ``torch.fft`` sum in different orders);
- ``acquire_all``: the same PRN order, code phases and Dopplers, SNR
  within 1e-3 relative;
- ``track_epochs``: ip, qp, ip_pre, qp_pre within 1e-3 x max|ip|, code
  phase within 1e-3 chip, carr_freq within 1e-6 relative (the loop
  updates are the reference's arithmetic as its compiler emits it; the
  sums over 16368 samples go in another order);
- the device-path scene (noise 0, not hard-limited) within 1e-5 of the
  reference's device path on every sample, the host path bit for bit;
- the manager: the same channels and epochs, unwrapped chips within
  1e-3, the same bit boundary;
- the manager's solve as the satellite set grows: the filter's fix and
  the single-point solutions within 1e-3 m of the reference's (both are
  float64 host code), each single-point solution within 1 m of the
  truth, the clock estimate equal.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu.models.gps import acquisition as jacq
from flydog_sdr_gps_tpu.models.gps import cacode as jcacode
from flydog_sdr_gps_tpu.models.gps import galileo as jgal
from flydog_sdr_gps_tpu.models.gps import manager as jman
from flydog_sdr_gps_tpu.models.gps import scene as jscene
from flydog_sdr_gps_tpu.models.gps import tracking as jtrack
from flydog_sdr_gps_tpu.ops import cplx as jcplx
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch.models.gps import acquisition as tacq
from flydog_sdr_gps_tpu_torch.models.gps import galileo as tgal
from flydog_sdr_gps_tpu_torch.models.gps import manager as tman
from flydog_sdr_gps_tpu_torch.models.gps import scene as tscene
from flydog_sdr_gps_tpu_torch.models.gps import tracking as ttrack

sys.path.insert(0, os.path.dirname(__file__))
from test_gps import synth_if  # noqa: E402

CPU = torch.device("cpu")
L1 = 1.57542e9
RX_LLA = (47.37, 8.54, 450.0)
T0 = 345600.0 + 3.0


def analog_if(sats, n, noise=0.5, seed=0):
    """IF (not yet hard-limited) of C/A and E1B satellites:
    sats = [(prn, code_phase_chips, doppler_hz, amplitude, e1b), ...];
    an E1B satellite carries BOC(1,1) on its memory code and 4 ms
    symbols that alternate."""
    rng = np.random.default_rng(seed)
    fs, fc = jacq.AcqParams().fs_if, jacq.AcqParams().fc
    t = np.arange(n, dtype=np.float64) / fs
    x = noise * rng.standard_normal(n)
    for prn, cp, fd, amp, e1b in sats:
        chips = cp + t * 1.023e6 * (1 + fd / L1)
        idx = np.floor(chips).astype(np.int64)
        if e1b:
            code = jgal.e1b_code(prn).astype(np.float64)[idx % 4092]
            code = code * np.where(chips - idx < 0.5, 1.0, -1.0)
            code = code * np.where((idx // 4092) % 2 == 0, 1.0, -1.0)
        else:
            code = jcacode.ca_code_any(prn).astype(np.float64)[idx % 1023]
        x += amp * code * np.cos(2 * np.pi * (fc + fd) * t)
    return x


# -- acquisition ------------------------------------------------------------

@pytest.mark.parametrize("one_bit", [True, False])
def test_downsample_if_is_exact(one_bit):
    p = jacq.AcqParams()
    x = np.random.default_rng(1).standard_normal(p.n_raw).astype(np.float32)
    if one_bit:
        x = np.sign(x)
    ref = jacq.downsample_if(p, jnp.asarray(x))
    got = tacq.downsample_if(tacq.AcqParams(), torch.as_tensor(x))
    assert got.dtype == torch.complex64 and got.shape == (p.fft_len,)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(ref.re))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(ref.im))


def test_acquire_power_matches_reference():
    p = jacq.AcqParams()
    raw = synth_if([(5, 123.4, 1800.0, 0.5)], p.n_raw)
    prns = (5, 17)
    ref = np.asarray(jacq.acquire_power(
        p, jacq.downsample_if(p, jnp.asarray(raw)),
        jcplx.from_numpy(jacq.code_ffts(p, prns))))
    tp = tacq.AcqParams()
    got = tacq.acquire_power(
        tp, tacq.downsample_if(tp, torch.as_tensor(raw)),
        torch.as_tensor(tacq.code_ffts(tp, prns))).numpy()
    assert got.shape == ref.shape == (2, 41, p.fft_len)
    assert np.abs(got - ref).max() <= 1e-4 * ref.max()


def test_acquire_all_matches_reference():
    p = jacq.AcqParams()
    sats = [(5, 123.4, +1800.0, 0.5), (17, 800.25, -2600.0, 0.45)]
    raw = synth_if(sats, p.n_raw)
    prns = (2, 5, 9, 17, 23, 30, 194)
    ref = jacq.acquire_all(p, raw, prns=prns)
    got = tacq.acquire_all(tacq.AcqParams(), raw, prns=prns, device=CPU)
    assert [r["prn"] for r in got] == [r["prn"] for r in ref]
    for g, r in zip(got, ref):
        assert g["code_phase"] == r["code_phase"], (g, r)
        assert g["doppler"] == r["doppler"], (g, r)
        assert abs(g["snr"] - r["snr"]) <= 1e-3 * r["snr"], (g, r)
    assert {got[0]["prn"], got[1]["prn"]} == {5, 17}


def test_acquire_all_e1b_matches_reference():
    p = jacq.AcqParams()
    raw = np.sign(analog_if([(3, 1234.5, 1300.0, 0.6, True)],
                            2 * p.n_raw)).astype(np.float32)
    ref = jgal.acquire_all_e1b(p, raw, prns=(3, 8))
    got = tgal.acquire_all_e1b(tacq.AcqParams(), raw, prns=(3, 8),
                               device=CPU)
    assert [r["prn"] for r in got] == [r["prn"] for r in ref] == [3, 8]
    for g, r in zip(got, ref):
        assert abs(g["snr"] - r["snr"]) <= 1e-3 * r["snr"], (g, r)
        assert g["code_phase"] == pytest.approx(r["code_phase"], abs=1e-6)
        assert g["doppler"] == pytest.approx(r["doppler"], abs=1e-6)
    err = (got[0]["code_phase"] - 1234.5 + 2046) % 4092 - 2046
    assert abs(err) < 0.5 and abs(got[0]["doppler"] - 1300.0) < 30.0


# -- tracking ---------------------------------------------------------------

def _bank(mod, device_kw):
    """Four rows: two C/A, one E1B with BOC, one inactive (a C/A row
    activated, then dropped)."""
    tp = mod.TrackParams()
    st, tab = mod.empty_track_state(tp, 4, **device_kw)
    rows = [(0, 9, 300.0 - 0.3, 1500.0 + 60.0, None, False),
            (1, 14, 700.5 + 0.2, -2200.0 - 40.0, None, False),
            (2, 3, 2000.25 - 0.1, 800.0 + 20.0, jgal.e1b_code(3), True),
            (3, 22, 100.0, 0.0, None, False)]
    for idx, prn, cp, dop, code, boc in rows:
        st, tab = mod.activate_channel(tp, st, tab, idx, prn, cp, dop,
                                       code=code, boc=boc)
    st = mod.deactivate_channel(st, 3)
    return tp, st, tab


def _bank_if(n_ep):
    x = analog_if([(9, 300.0, 1500.0, 0.7, False),
                   (14, 700.5, -2200.0, 0.6, False),
                   (3, 2000.25, 800.0, 0.6, True)], 16368 * n_ep, seed=4)
    return np.sign(x).astype(np.float32).reshape(n_ep, 16368)


def test_track_epochs_plain_matches_reference():
    raw = _bank_if(40)
    tp, st, tab = _bank(jtrack, {})
    st_j, outs_j = jtrack.track_epochs(tp, st, tab, jnp.asarray(raw))
    pp, ps, ptab = _bank(ttrack, dict(device=CPU))
    ps2, outs_t = ttrack.track_epochs(pp, ps, ptab, torch.as_tensor(raw))
    assert ps2 is ps                        # updated in place
    scale = float(np.abs(np.asarray(outs_j["ip"])).max())
    for k in ("ip", "qp", "ip_pre", "qp_pre"):
        err = np.abs(outs_t[k].numpy() - np.asarray(outs_j[k])).max()
        assert err <= 1e-3 * scale, (k, err, scale)
    for got, ref in ((outs_t["code_phase"].numpy(),
                      np.asarray(outs_j["code_phase"])),
                     (ps.code_phase.numpy(), np.asarray(st_j.code_phase))):
        assert np.abs(got - ref).max() <= 1e-3
    for got, ref in ((outs_t["carr_freq"].numpy(),
                      np.asarray(outs_j["carr_freq"])),
                     (ps.carr_freq.numpy(), np.asarray(st_j.carr_freq))):
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the inactive row's loop state stood still, its prompt history moved
    assert float(ps.code_phase[3]) == 100.0 and not bool(ps.active[3])
    # the three live rows hold their satellites' carriers
    f = ps.carr_freq.numpy()[:3] / (2 * np.pi) * pp.fs - pp.fc
    assert np.abs(f - np.array([1500.0, -2200.0, 800.0])).max() < 60.0, f


def test_tracking_lock_reads_the_reference_bits():
    """The 260-epoch lock of ``test_gps.py``: the same nav bits."""
    n_ms = 260
    bits = np.asarray([1, -1, -1, 1, 1, 1, -1] * 40)[:n_ms // 20 + 2]
    raw = synth_if([(9, 300.0, +1500.0, 0.8)], 16368 * n_ms, noise=0.5,
                   bits={9: (bits, 0)}).reshape(n_ms, 16368)
    tp = jtrack.TrackParams()
    st, tab = jtrack.init_track_state(tp, [9], [299.7], [1580.0])
    _, outs_j = jtrack.track_epochs(tp, st, tab, jnp.asarray(raw))
    ps, ptab = ttrack.init_track_state(ttrack.TrackParams(), [9], [299.7],
                                       [1580.0], device=CPU)
    _, outs_t = ttrack.track_epochs(ttrack.TrackParams(), ps, ptab,
                                    torch.as_tensor(raw))
    ip_j = np.asarray(outs_j["ip"])[:, 0]
    ip_t = outs_t["ip"].numpy()[:, 0]
    off_j, bits_j = jtrack.bit_sync(ip_j[20:])
    off_t, bits_t = ttrack.bit_sync(ip_t[20:])
    assert off_t == off_j and np.array_equal(bits_t, bits_j)
    agree = np.mean(bits_t == bits[1:1 + len(bits_t)])
    assert max(agree, 1 - agree) > 0.9


def test_track_state_rows_and_kernel_refusal():
    """Row writes land in place; a CUDA-only path is not taken for CPU
    tensors, and a wrong shape is refused before any launch."""
    tp = ttrack.TrackParams()
    st, tab = ttrack.empty_track_state(tp, 3, device=CPU)
    ptr = st.code_phase.data_ptr()
    st2, tab2 = ttrack.activate_channel(tp, st, tab, 1, 7, 1030.0, 500.0)
    assert st2 is st and tab2 is tab and st.code_phase.data_ptr() == ptr
    assert float(st.code_phase[1]) == pytest.approx(7.0)
    assert bool(st.active[1]) and not bool(st.active[0])
    assert tab[4092:4092 + 1023].abs().min() == 1.0
    assert tab[:4092].abs().max() == 0
    with pytest.raises(ValueError, match="raw must be"):
        ttrack.track_epochs(tp, st, tab, torch.zeros(2, 100))
    launches = ttrack.track_epochs.launches
    ttrack.track_epochs(tp, st, tab, torch.zeros(1, 16368))
    assert ttrack.track_epochs.launches == launches


# -- the synthetic sky ------------------------------------------------------

def _skies(noise, one_bit, device):
    out = []
    for mod in (jscene, tscene):
        rx = mod.ecef_from_lla(*RX_LLA)
        ephs = mod.visible_constellation(rx, T0, n_sats=4)
        gal = mod.visible_galileo(rx, T0, n_sats=2)
        dev = device if mod is tscene else device != "host"
        out.append(mod.GpsScene(rx, ephs, T0, duration=30.0, clock_ppm=0.4,
                                noise=noise, amplitude=0.5, one_bit=one_bit,
                                galileo_ephemerides=gal, device=dev))
    return out


def test_device_scene_matches_reference_device_path():
    ref, got = _skies(0.0, False, "cpu")
    assert [s.prn for s in got.sats] == [s.prn for s in ref.sats]
    assert any(s.boc for s in got.sats)
    n = 16368 * 20
    for _ in range(2):
        xr = np.asarray(ref.next_block(n))
        xg = got.next_block(n)
        assert isinstance(xg, torch.Tensor) and xg.dtype == torch.float32
        assert np.abs(xg.numpy() - xr).max() <= 1e-5
    assert got.ticks == ref.ticks


def test_host_scene_is_bit_for_bit():
    ref, got = _skies(0.9, True, "host")
    for _ in range(2):
        np.testing.assert_array_equal(got.next_block(16368 * 3 + 11),
                                      ref.next_block(16368 * 3 + 11))
    assert got.true_delay(got.sats[0].prn, T0 + 1.0) == \
        ref.true_delay(ref.sats[0].prn, T0 + 1.0)


def test_device_scene_noise_is_seeded():
    a, b = (_skies(0.9, True, "cpu")[1] for _ in range(2))
    xa, xb = a.next_block(16368 * 4), b.next_block(16368 * 4)
    assert torch.equal(xa, xb)
    assert set(torch.unique(xa).tolist()) <= {-1.0, 0.0, 1.0}


# -- the manager ------------------------------------------------------------

def _managers(max_chans=4):
    kw = dict(max_chans=max_chans, prns=(3, 9, 14, 22, 30))
    return jman.GpsManager(**kw), tman.GpsManager(**kw, device=CPU)


def test_manager_cold_search_matches_reference():
    ref, got = _managers()
    sats = [(9, 210.0, +1200.0, 0.7), (22, 555.5, -900.0, 0.65)]
    raw = synth_if(sats, ref.acq.n_raw, noise=0.5)
    s_ref = ref.cold_search(raw)
    s_got = got.cold_search(raw)
    assert [s["prn"] for s in s_got] == [s["prn"] for s in s_ref]
    assert {s["prn"] for s in s_got} == {9, 22}
    for g, r in zip(s_got, s_ref):
        assert g["code_phase"] == r["code_phase"]
        assert g["doppler"] == r["doppler"]
    for prn, ch in got.channels.items():
        assert ch.state_idx == ref.channels[prn].state_idx
    np.testing.assert_array_equal(got._code_table.numpy(),
                                  np.asarray(ref._code_table))


def test_manager_from_one_state_tracks_like_the_reference():
    """cold_search on the reference, its state carried into the port,
    then 60 epochs, then on to the bit boundary (1100 epochs)."""
    ref, got = _managers()
    bits = np.asarray([1, -1, 1, 1, -1, -1, 1, -1] * 20)
    sats = [(9, 210.0, +1200.0, 0.7), (22, 555.5, -900.0, 0.65)]
    raw = synth_if(sats, ref.acq.n_raw, noise=0.5)
    ref.cold_search(raw)
    convert.gps_manager_from_ref(ref, got)
    assert set(got.channels) == {9, 22}
    chunk = 16368 * 60
    for i in range(19):
        x = synth_if(sats, chunk, noise=0.5, seed=i + 1,
                     bits={9: (bits, 7 + 60 * i), 22: (bits, 13 + 60 * i)})
        ref.track_block(x)
        got.track_block(x)
        for prn, ch in got.channels.items():
            rc = ref.channels[prn]
            assert ch.epochs == rc.epochs == 60 * (i + 1)
            assert abs(ch.chips - rc.chips) <= 1e-3, (prn, ch.chips, rc.chips)
            assert ch.bit_offset == rc.bit_offset
        assert got.samples_tracked == ref.samples_tracked
        assert got.ticks == ref.ticks
    assert all(ch.bit_offset is not None for ch in got.channels.values())
    assert got.status()["prns"] == ref.status()["prns"] == [9, 22]


def test_manager_solve_follows_the_reference_as_the_set_grows():
    """Both managers from one state with the ``run_server --gps`` sky's
    channels (the GPS satellites above 15 degrees, 4 Galileo), then a
    solve every 2 s of GPS time with the scene's true transmit times:
    Galileo alone first, then GPS joining in two steps, as on a cold
    start where I/NAV decodes first.  The position filter's output, the
    single-point solutions by set and the clock estimate stay the
    reference's at every step."""
    rx = jscene.ecef_from_lla(*RX_LLA)
    sky = jscene.GpsScene(rx, jscene.visible_constellation(rx, T0, n_sats=8),
                          T0, duration=30.0,
                          galileo_ephemerides=jscene.visible_galileo(
                              rx, T0, n_sats=4), device=False)
    ephs = {s.prn: s.eph for s in sky.sats}
    gps = sorted(p for p in ephs if p < tman.GALILEO_PRN_BASE)
    gal = sorted(p for p in ephs if p >= tman.GALILEO_PRN_BASE)
    kw = dict(max_chans=12, prns=tuple(gps),
              galileo_prns=tuple(p - tman.GALILEO_PRN_BASE for p in gal))
    ref, got = jman.GpsManager(**kw), tman.GpsManager(**kw, device=CPU)
    for i, prn in enumerate(gps + gal):
        ref.channels[prn] = jman.GpsChannel(prn=prn, state_idx=i)
    convert.gps_manager_from_ref(ref, got)
    half = len(gps) // 2
    for step in range(10):
        t = T0 + 12.0 + 2.0 * step
        joined = gal + gps[:half * min(2, max(0, step - 3))]
        for m in (ref, got):
            m.samples_tracked = round((t - T0) * m.tp.fs * (1 + 0.4e-6))
            for prn, ch in m.channels.items():
                ch.tow_ref = None
                if prn in joined:
                    tau = sky.true_delay(prn, t)
                    clk = ephs[prn].sat_pos(t - tau)[1]
                    ch.tow_ref = (t - tau + clk, ch.chips)
        fix_ref = ref.solve(ephemerides=ephs)
        fix_got = got.solve(ephemerides=ephs)
        assert fix_ref is not None and fix_got is not None
        assert np.linalg.norm(fix_got - fix_ref) <= 1e-3, step
        assert got.last_solutions.keys() == ref.last_solutions.keys()
        for k, sol in got.last_solutions.items():
            assert sol["prns"] == ref.last_solutions[k]["prns"]
            assert np.linalg.norm(sol["pos"] - ref.last_solutions[k]["pos"]) \
                <= 1e-3
            assert np.linalg.norm(sol["pos"] - rx) <= 1.0, (step, k)
        assert got.clock.locked == ref.clock.locked
        assert got.clock.correction_ppm == ref.clock.correction_ppm
    assert set(got.last_solutions) == {"all", "gps", "galileo"}
    assert got.last_solutions["all"]["nsat"] == len(gps) + len(gal)
    assert got.clock.locked and got.fixes == ref.fixes == 10


def test_manager_takes_device_tensors_in_place():
    """A tensor of whole epochs is tracked where it lies; the numpy path
    gives the same result (the reference's device-array test)."""
    sats = [(9, 210.0, +1200.0, 0.7)]
    m1 = tman.GpsManager(prns=(9,), max_chans=2, device=CPU)
    m2 = tman.GpsManager(prns=(9,), max_chans=2, device=CPU)
    raw = synth_if(sats, m1.acq.n_raw, noise=0.5)
    m1.cold_search(raw)
    m2.cold_search(raw)
    raw2 = synth_if(sats, m1.tp.epoch * 40, noise=0.5, seed=1)
    m1.track_block(raw2)
    m2.track_block(torch.as_tensor(raw2))
    c1, c2 = m1.channels[9], m2.channels[9]
    assert c1.epochs == c2.epochs == 40
    assert c1.chips == c2.chips and m1.samples_tracked == m2.samples_tracked
    m3 = tman.GpsManager(prns=(9,), max_chans=2, device=CPU)
    m3.process(torch.as_tensor(raw), search=True)
    assert 9 in m3.channels and len(m3._sbuf) == m3.acq.n_raw
