"""The port stands on its own: it imports neither jax nor anything of the
reference package, and its copies of the reference's host-only modules
(``numerology``, ``ops.filters``, ``ops.windows``) agree with the
originals.

- a subprocess whose import system refuses ``jax``, ``jaxlib`` and
  ``flydog_sdr_gps_tpu`` imports every module of the port (the server,
  its services, the web UI, the entry point and the GPS subsystem among
  them) and runs two ``StreamEngine`` blocks on the CPU (C=8,
  audio_block=256), a block of the multi-device engine over a (2, 2)
  mesh of CPU devices, the stage-2 FFT method and ``lms_block``, then
  one ``run_block_gather`` and one waterfall row
  from that block, then a ``KiwiServer`` that serves a listener two
  blocks, then a GPS cold search and a chunk of tracking on the
  device-path sky, then the decoders' front ends on a short capture
  and a server whose autorun units claim idle channels, then the
  host-only decoders fed ``chip_smoke.py`` phase 8a's signals through
  the engine's kind of taps;
- a source scan finds no ``import``/``from`` of either in the port's
  package or ``chip_smoke.py``;
- every public constant of ``numerology`` is equal, and the filter
  designers the port calls give bit-equal taps for both decimation plans
  and three passbands; ``halfband`` and every window are bit-equal too.
"""

import dataclasses
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

from flydog_sdr_gps_tpu import numerology as jnum
from flydog_sdr_gps_tpu.ops import filters as jfilters
from flydog_sdr_gps_tpu.ops import windows as jwindows
from flydog_sdr_gps_tpu_torch import numerology as tnum
from flydog_sdr_gps_tpu_torch.ops import filters as tfilters
from flydog_sdr_gps_tpu_torch.ops import windows as twindows

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "flydog_sdr_gps_tpu_torch"
FOREIGN_IMPORT = re.compile(
    r"^\s*(from|import)\s+(flydog_sdr_gps_tpu|jax|jaxlib)(\.|\s|$)", re.M)


def test_port_runs_without_jax_and_reference_package():
    script = textwrap.dedent("""
        import importlib
        import pkgutil
        import sys

        BLOCKED = ("jax", "jaxlib", "flydog_sdr_gps_tpu")

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} is blocked in this test")

        for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
            del sys.modules[name]
        sys.meta_path.insert(0, Refuse())

        import torch
        import flydog_sdr_gps_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(
            port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 80, names
        for wanted in ("models.waterfall", "server.wf_service",
                       "ops.windows", "server.kiwi_server", "server.webui",
                       "server.services", "server.netproto", "run_server",
                       "utils.dx", "utils.eibi", "utils.security",
                       "extensions.s_meter", "runtime.native", "ops.adpcm",
                       "models.gps.acquisition", "models.gps.tracking",
                       "models.gps.scene", "models.gps.manager",
                       "models.gps.galileo", "models.gps.ephemeris",
                       "models.gps.solver", "models.gps.clock",
                       "models.gps.cacode", "models.gps.e1b_codes",
                       "runtime.gps_service", "convert",
                       "extensions.audio_fft", "extensions.cw_decoder",
                       "extensions.wspr", "extensions.wspr_decode",
                       "extensions.ft8", "extensions.ft8_decode",
                       "extensions.ft8_ldpc_tables", "extensions.ft4",
                       "extensions.spot_upload", "extensions.capture",
                       "server.autorun", "extensions.taps",
                       "extensions.fsk", "extensions.misc_ui",
                       "extensions.noise_ui", "extensions.sig_gen",
                       "extensions.tdoa", "extensions.navtex",
                       "extensions.timecode", "extensions.ibp_scan",
                       "extensions.fax", "extensions.sstv",
                       "extensions.loran_c", "extensions.ale_2g",
                       "extensions.s4285", "extensions.hfdl",
                       "extensions.drm_tables", "extensions.drm_mlc",
                       "extensions.drm", "extensions.drm_audio",
                       "parallel", "parallel.mesh", "parallel.sharded_rx",
                       "parallel.distributed", "runtime.sharded_stream"):
            assert f"{port.__name__}.{wanted}" in names, wanted

        from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
        from flydog_sdr_gps_tpu_torch.ops import demod
        from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                      StreamEngine)
        params = rx.RxParams(num_channels=8, audio_block=256)
        src = DeviceSceneSource(tones=[(7.1e6, 0.3)], noise_rms=1e-3,
                                block=params.ddc.adc_block, device="cpu")
        eng = StreamEngine(params, src, device="cpu")
        eng.set_channel(0, freq_hz=7.0995e6, mode=demod.MODE_USB)
        eng.set_channel(1, freq_hz=7.1e6, mode=demod.MODE_SAM)
        for _ in range(2):
            taps = eng.run_block()
            assert taps.audio.shape == (256, 8)
            assert bool(torch.isfinite(taps.audio).all())
        assert float(taps.audio[:, 0].abs().max()) > 1e-3

        # the multi-device engine over a (2, 2) mesh of CPU devices, the
        # stage-2 FFT method and the one-stage LMS line enhancer
        from flydog_sdr_gps_tpu_torch import parallel
        from flydog_sdr_gps_tpu_torch.ops import channelizer, noise
        from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
        mesh = parallel.make_mesh(2, 2, devices=["cpu"] * 4)
        meng = ShardedStreamEngine(params, DeviceSceneSource(
            tones=[(7.1e6, 0.3)], noise_rms=1e-3,
            block=params.ddc.adc_block, device="cpu"), mesh=mesh)
        meng.set_channel(0, freq_hz=7.0995e6, mode=demod.MODE_USB)
        mtaps = meng.run_block()
        assert mtaps.audio.shape == (256, 8)
        assert bool(torch.isfinite(mtaps.audio).all())
        y = torch.randn((params.ddc.k1 + params.ddc.tail2, 3),
                        dtype=torch.complex64)
        assert channelizer.stage2_fft(params.ddc, y).shape == (256, 3)
        lp = noise.LmsParams(notch=True)
        out, _ = noise.lms_block(lp, torch.randn(64, 2),
                                 noise.init_lms(lp, 2, "cpu"))
        assert out.shape == (64, 2)

        # the serving path and one waterfall row from the same block
        import numpy as np
        from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
        packed = eng.fetch(eng.run_block_gather(np.array([1, 0], np.int32)))
        assert packed.shape == (4 * 2 * 256 + 8 + 1,)
        assert packed.dtype == np.float32 and np.isfinite(packed).all()
        wf = WfSubsystem(params.adc_clock, 30.0e6, capacity=1, device="cpu")
        slot = wf.attach(0, 0)
        wf.ingest(eng._last_x)
        row = wf.frame(slot)
        assert row.shape == (1024,) and np.isfinite(row).all()
        want_px = round(7.1e6 / 30.0e6 * 1024)
        assert abs(int(np.argmax(row)) - want_px) <= 1, int(np.argmax(row))

        # the server on that engine: one listener over an in-process
        # socket, two served blocks, the SNR service's measurement
        import asyncio
        from flydog_sdr_gps_tpu_torch.server import KiwiServer
        from flydog_sdr_gps_tpu_torch.server.services import (
            default_services)

        class Sock:
            closed = False
            def __init__(self):
                self.sent = []
            async def send_bytes(self, data):
                self.sent.append(bytes(data))
            async def close(self):
                self.closed = True

        async def serve():
            server = KiwiServer(eng, realtime=False, port=0)
            sock = Sock()
            conn = await server.open_stream("1", "SND", sock, "127.0.0.1")
            await conn.handle_set("SET auth t=kiwi p=", "SND")
            await conn.handle_set(
                "SET mod=usb low_cut=300 high_cut=2700 freq=7099.500", "SND")
            server.start_tasks()
            while sum(p[:3] == b"SND" for p in sock.sent) < 2:
                await asyncio.sleep(0.01)
            default_services(server).services["snr_measure"].fn()
            await server.stop()
            return server, sock
        server, sock = asyncio.run(serve())
        assert sock.sent[0] == b"MSG badp=0"
        assert server.snr_history and server.snr_history[-1]["snr"] >= 0

        # the GPS receiver: the device-path sky on the CPU, a cold
        # search and a chunk of tracking
        from flydog_sdr_gps_tpu_torch.models.gps import manager as gman
        from flydog_sdr_gps_tpu_torch.models.gps import scene as gscene
        from flydog_sdr_gps_tpu_torch.runtime import GpsReceiver
        rxp = gscene.ecef_from_lla(47.37, 8.54, 450.0)
        ephs = gscene.visible_constellation(rxp, 345603.0, n_sats=3)
        sky = gscene.GpsScene(rxp, ephs, 345603.0, duration=5.0,
                              clock_ppm=0.4, noise=0.8, amplitude=0.6,
                              device="cpu")
        mgr = gman.GpsManager(max_chans=4, prns=tuple(ephs), device="cpu")
        mgr.process(sky.next_block(16368 * 20), search=True)
        mgr.process(sky.next_block(16368 * 20))
        assert set(mgr.channels) == set(ephs), sorted(mgr.channels)
        assert all(c.epochs == 20 for c in mgr.channels.values())
        assert GpsReceiver(sky, mgr).status()["tracking"] == len(ephs)

        # the decoders' front ends, and autorun units on the server
        from flydog_sdr_gps_tpu_torch.extensions import ft8, wspr
        power, z = wspr.frontend(torch.randn(12000 * 12))
        assert power.shape == (17, 256) and z.dtype == torch.complex64
        assert ft8.spectrogram(torch.randn(12000)).shape == (6, 1024)

        async def autorun():
            server = KiwiServer(eng, realtime=False, port=0,
                                autorun=["wspr:7038.6", "FT8:14074"])
            server.start_tasks()
            # (the wspr unit waits for the next 120 s cycle to capture)
            wspr_unit, ft8_unit = server.autorun.units
            while not (wspr_unit.ext is not None and ft8_unit.ext is not None
                       and ft8_unit.ext._samples):
                await asyncio.sleep(0.01)
            await server.stop()
        asyncio.run(autorun())

        # the host-only decoders: chip_smoke.py phase 8a's cases through
        # the engine's kind of taps, on the CPU
        import chip_smoke
        dec = chip_smoke.phase_host_decoders(
            torch, torch.device("cpu"), channels=8, block=2048, card="cpu")
        assert len(dec) == 10 and all(r["decoded"] for r in dec.values())
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("STANDALONE-OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "STANDALONE-OK" in res.stdout


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        hit = FOREIGN_IMPORT.search(path.read_text())
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0)!r}"


def test_entry_points_default_to_the_card():
    import inspect
    from flydog_sdr_gps_tpu_torch.models.gps import acquisition, tracking
    from flydog_sdr_gps_tpu_torch.models.gps import galileo
    from flydog_sdr_gps_tpu_torch.models.gps.manager import GpsManager
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    for cls in (StreamEngine, DeviceSceneSource, WfSubsystem, GpsManager,
                tracking.init_track_state, tracking.empty_track_state,
                galileo.acquire_all_e1b):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    # a numpy capture with no device named is searched on the card
    assert inspect.signature(
        acquisition.acquire_all).parameters["device"].default is None


def _plain(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.asdict(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def test_numerology_copy_equals_reference():
    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_")
                and not isinstance(v, (types.ModuleType, type))
                and k != "annotations"}
    ref, got = public(jnum), public(tnum)
    assert set(got) == set(ref) and len(ref) > 30
    for name, value in ref.items():
        assert _plain(got[name]) == _plain(value), name
    assert [f.name for f in dataclasses.fields(tnum.RxConfig)] == \
        [f.name for f in dataclasses.fields(jnum.RxConfig)]


@pytest.mark.parametrize("decims, fs_out", [
    (jnum.DECIM_PLAN_12K, jnum.ADC_CLOCK_NOM / jnum.RX_DECIM_12K),
    (jnum.DECIM_PLAN_20K, jnum.ADC_CLOCK_NOM / jnum.RX_DECIM_20K)])
def test_decimation_stage_copy_is_bit_equal(decims, fs_out):
    args = (jnum.ADC_CLOCK_NOM, decims, 0.38 * fs_out)
    got = tfilters.design_decimation_stages(*args, atten_db=90.0)
    ref = jfilters.design_decimation_stages(*args, atten_db=90.0)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("passband", [(300.0, 2700.0), (-4900.0, 4900.0),
                                      (-5500.0, 5500.0)])
@pytest.mark.parametrize("fs", [jnum.ADC_CLOCK_NOM / jnum.RX_DECIM_12K,
                                jnum.ADC_CLOCK_NOM / jnum.RX_DECIM_20K])
def test_complex_bandpass_copy_is_bit_equal(fs, passband):
    np.testing.assert_array_equal(
        tfilters.complex_bandpass(fs, *passband, 90.0, 513),
        jfilters.complex_bandpass(fs, *passband, 90.0, 513))
    for fn in ("kaiser_beta", "kaiser_numtaps", "kaiser_lowpass"):
        assert hasattr(tfilters, fn)


@pytest.mark.parametrize("atten, numtaps", [(80.0, None), (90.0, None),
                                            (60.0, 31)])
def test_halfband_copy_is_bit_equal(atten, numtaps):
    got = tfilters.halfband(atten, numtaps)
    np.testing.assert_array_equal(got, jfilters.halfband(atten, numtaps))
    mid = len(got) // 2
    # a true halfband: of the odd taps only the centre is not zero
    assert len(got) % 4 == 3 and mid % 2 == 1
    assert np.count_nonzero(got[1::2]) == 1 and got[mid] > 0.4


@pytest.mark.parametrize("kind", [jwindows.HANNING, jwindows.HAMMING,
                                  jwindows.BLACKMAN_HARRIS,
                                  jwindows.RECTANGULAR])
def test_windows_copy_is_bit_equal(kind):
    assert (twindows.HANNING, twindows.HAMMING, twindows.BLACKMAN_HARRIS,
            twindows.RECTANGULAR) == (jwindows.HANNING, jwindows.HAMMING,
                                      jwindows.BLACKMAN_HARRIS,
                                      jwindows.RECTANGULAR)
    for n in (8, 1000, 8192):
        for periodic in (True, False):
            got = twindows.window(kind, n, periodic)
            ref = jwindows.window(kind, n, periodic)
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == np.float32
        assert twindows.coherent_gain(got) == jwindows.coherent_gain(ref)
        assert twindows.noise_bandwidth(got) == jwindows.noise_bandwidth(ref)
    with pytest.raises(ValueError):
        twindows.window("welch", 8)
