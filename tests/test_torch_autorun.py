"""Autorun of the port (background decoders on idle channels) against the
reference's, on the CPU.

- ``parse_spec``: the reference test's cases.
- ``test_autorun.py``'s scenario on the port's server (``device="cpu"``,
  port 0): both units claim idle channels with no client, taps flow into
  the decoder, decode messages become spots with the upload gated,
  ``/status`` reports ``autorun=2``, a listener preempts a unit, and the
  unit re-claims when the listener leaves.
- The two managers block by block on the same ``HostTaps`` (a stub
  server and engine, 3 channels, audio_block=2048): an FT8 transmission
  and then an FT4 one on every channel; units ``wspr``, ``FT8/FT4``
  (alternating) and ``FT8``; a listener takes a channel at block 30 and
  leaves at block 60.  The claims, the engine's retunes, the units'
  slots, the spots (extension, dial, text) and the gated uploads are
  equal after every block, and so are ``/status``'s ``autorun=`` and
  ``spots=`` fields as the server computes them.
"""

import asyncio
import time
import types

import numpy as np
import pytest

from chip_smoke import fsk_audio
from flydog_sdr_gps_tpu.server import autorun as jautorun
from flydog_sdr_gps_tpu.server import kiwi_server as jks
from flydog_sdr_gps_tpu_torch import run_server
from flydog_sdr_gps_tpu_torch.extensions import ft4 as tft4
from flydog_sdr_gps_tpu_torch.extensions import ft8 as tft8
from flydog_sdr_gps_tpu_torch.extensions import ft8_decode as tfd
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import demod
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.server import autorun as tautorun
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks


def test_parse_spec():
    parse_spec = tautorun.parse_spec
    assert parse_spec("wspr:7038.6") == [("wspr", 7038.6)]
    assert parse_spec("ft8:14074") == [("FT8", 14074.0)]
    [(name, f)] = parse_spec("WSPR:7.0386M")
    assert name == "wspr" and f == pytest.approx(7038.6)
    assert parse_spec("wspr:7038600") == [("wspr", 7038.6)]
    assert parse_spec("ft8/ft4:14074/14080") == \
        [("FT8", 14074.0), ("FT4", 14080.0)]
    assert parse_spec("ft8/ft4:14074") == \
        [("FT8", 14074.0), ("FT4", 14074.0)]
    with pytest.raises(ValueError):
        parse_spec("nosuch:123")
    with pytest.raises(ValueError):
        parse_spec("ft8/ft4:1/2/3")
    # a name neither package registers is refused by name; every name the
    # reference registers is taken, in any case, as the reference takes it
    with pytest.raises(ValueError, match="nosuch"):
        parse_spec("nosuch:518")
    assert parse_spec("NAVTEX:518") == [("NAVTEX", 518.0)] == \
        jautorun.parse_spec("NAVTEX:518")
    assert parse_spec("navtex:518") == jautorun.parse_spec("navtex:518")


async def _wait(cond, what, timeout=120.0):
    t0 = time.monotonic()
    while not cond():
        await asyncio.sleep(0.05)
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"


def test_autorun_claims_decodes_and_yields():
    aiohttp = pytest.importorskip("aiohttp")
    params = trx.RxParams(num_channels=2, audio_block=128)
    eng = tstream.StreamEngine(
        params, tsource.SyntheticSource(tones=((7.040e6, 0.2),),
                                        noise_rms=1e-3), device="cpu")
    server = tks.KiwiServer(eng, port=0, realtime=False,
                            autorun=["wspr:7038.6", "FT8:14074"])

    async def scenario():
        runner = await server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            # --- with zero clients, autorun claims both channels ---
            await _wait(lambda: len(server.autorun.channels) == 2, "claims")
            wspr_unit = server.autorun.units[0]
            assert wspr_unit.ext is not None
            ch = wspr_unit.rx_chan
            assert eng.ctl[ch].in_use
            assert abs(eng.ctl[ch].freq_hz - 7038600.0) < 1
            assert eng.ctl[ch].mode == demod.MODE_USB
            # --- taps flow into the decoder front end ---
            s0 = wspr_unit.ext._samples
            await _wait(lambda: wspr_unit.ext._samples > s0, "taps")
            # --- decode messages become logged spots (upload gated) ---
            unit = server.autorun.units[1]
            unit.ext.process_block = lambda taps: [
                ("ft8_decode", b"CQ K1ABC FN42 1230.0")]
            await _wait(lambda: server.autorun.spots, "spots")
            assert server.autorun.spots[0]["ext"] == "FT8"
            assert "K1ABC" in server.autorun.spots[0]["text"]
            assert server.autorun.uploads_gated >= 1
            async with aiohttp.ClientSession() as session:
                async with session.get(base + "/status") as r:
                    text = await r.text()
                assert "autorun=2" in text and "spots=" in text
                # --- a real user preempts an autorun channel ---
                ws = await session.ws_connect(base + "/777/SND")
                await ws.send_str("SET auth t=kiwi p=")
                await _wait(lambda: any(c.rx_chan is not None
                                        for c in server.conns.values()),
                            "the listener's channel")
                assert len(server.autorun.channels) == 1
                async with session.get(base + "/status") as r:
                    assert "autorun=1" in await r.text()
                await ws.close()
            # --- after the user leaves, autorun re-claims ---
            await _wait(lambda: len(server.autorun.channels) == 2,
                        "the re-claim")
        finally:
            await server.stop()
            await runner.cleanup()
    asyncio.run(scenario())


def test_reclaim_with_a_block_in_flight_keeps_the_loop_running():
    """A listener preempts a unit and leaves while blocks are in flight;
    the unit re-claims the channel and is fed, and the block loop runs
    on without a restart (a failure in the fan-out would restart it and
    drop the blocks in flight)."""
    params = trx.RxParams(num_channels=2, audio_block=128)
    eng = tstream.StreamEngine(
        params, tsource.SyntheticSource(tones=((14.075e6, 0.2),),
                                        noise_rms=1e-3), device="cpu")
    server = tks.KiwiServer(eng, port=0, realtime=False,
                            autorun=["FT8:14074", "FT8:14074"])
    starts = []
    init = server._block_loop_once_init

    async def counted():
        starts.append(eng.seq)
        await init()
    server._block_loop_once_init = counted

    class Sock:
        closed = False

        async def send_bytes(self, data):
            pass

        async def close(self):
            self.closed = True

    async def scenario():
        server.start_tasks()
        try:
            await _wait(lambda: len(server.autorun.channels) == 2, "claims")
            conn = await server.open_stream("l", "SND", Sock(), "127.0.0.1")
            await conn.handle_set("SET auth t=kiwi p=", "SND")
            assert conn.rx_chan is not None
            assert len(server.autorun.channels) == 1
            seq = eng.seq
            await _wait(lambda: eng.seq >= seq + 3, "blocks with the listener")
            server.release(conn)
            server.conns.pop("l", None)
            await _wait(lambda: len(server.autorun.channels) == 2,
                        "the re-claim")
            unit = next(u for u in server.autorun.units
                        if u.rx_chan == conn.rx_chan)
            await _wait(lambda: unit.ext._samples >= 3 * 128,
                        "the re-claimed unit fed")
        finally:
            await server.stop()
        assert starts == [0], f"the block loop restarted at blocks {starts}"
    asyncio.run(scenario())


def test_run_server_autorun_on_the_cpu():
    """``run_server --cpu --autorun wspr:7038.6 --autorun FT8:14074``:
    the entry point hands the specs to the server, whose units claim
    two idle channels and are fed the block loop's taps."""
    args = run_server.parse_args(["--cpu", "--channels", "4",
                                  "--no-realtime", "--port", "0",
                                  "--autorun", "wspr:7038.6",
                                  "--autorun", "FT8:14074"])
    server, _cfg, eng = run_server.build(args)
    assert [u.slots for u in server.autorun.units] == [
        [("wspr", 7038.6)], [("FT8", 14074.0)]]

    async def scenario():
        server.start_tasks()
        try:
            await _wait(lambda: all(u.ext is not None and u.ext._samples
                                    for u in server.autorun.units),
                        "both units fed")
            assert {eng.ctl[u.rx_chan].freq_hz
                    for u in server.autorun.units} == {7038600.0, 14074000.0}
        finally:
            await server.stop()
    asyncio.run(scenario())


# -- the two managers block by block ------------------------------------------

BLOCK, CHANNELS, NBLOCKS = 2048, 3, 122
SPECS = ["wspr:7038.6", "FT8/FT4:14074/14080", "FT8:14074"]


class StubEngine:
    """What a manager and its extensions ask of an engine."""

    def __init__(self):
        self.params = types.SimpleNamespace(num_channels=CHANNELS,
                                            fs_out=12000.0,
                                            audio_block=BLOCK)
        self.ctl = [types.SimpleNamespace(in_use=False)
                    for _ in range(CHANNELS)]
        self.source = None
        self.device = "cpu"
        self.calls = []

    def set_channel(self, ch, **kw):
        self.calls.append((ch, tuple(sorted(kw.items()))))


def _scene_audio():
    """An FT8 CQ K1ABC FN42 at 1200 Hz from sample 0, then an FT4 CQ
    K1ABC FN42 at 1500 Hz where the alternating unit's FT4 capture
    starts (block 80), in noise."""
    n = NBLOCKS * BLOCK
    payload = tfd.pack_payload(tfd.Ft8Message("CQ", "K1ABC", "FN42"))
    t8 = tfd.codeword_to_tones(tfd.ldpc_encode(tfd.add_crc(payload)))
    sig = np.zeros(n)
    sig += fsk_audio(t8, 1200.0, tft8.BAUD, tft8.SPS, n)
    t4 = tft4.encode_tones(payload)
    start = 80 * BLOCK
    sig[start:] += fsk_audio(t4, 1500.0, tft4.BAUD, tft4.SPS, n - start)
    rng = np.random.default_rng(21)
    return (0.3 * sig + 0.2 * rng.standard_normal(n)).astype(np.float32)


def test_managers_agree_block_by_block():
    audio = _scene_audio()
    sides = []
    for mod, ks in ((jautorun, jks), (tautorun, tks)):
        server = types.SimpleNamespace(engine=StubEngine(), conns={})
        sides.append((mod.AutorunManager(server, SPECS), server, ks))
    for blk in range(NBLOCKS):
        states = []
        for mgr, server, ks in sides:
            if blk == 30:               # a listener takes a channel
                server.conns["l"] = listener = types.SimpleNamespace(
                    rx_chan=None)
                assert mgr.release_one()
                used = mgr.channels
                listener.rx_chan = next(c for c in range(CHANNELS)
                                         if c not in used)
            if blk == 60:               # and leaves
                server.conns.pop("l")
            mgr.tick()
            subs = sorted(mgr.channels | {c.rx_chan for c in
                                          server.conns.values()})
            rows = np.stack([audio[blk * BLOCK:(blk + 1) * BLOCK]] * len(subs))
            taps = ks.HostTaps(rows, rows, rows, np.zeros_like(rows),
                               np.zeros(CHANNELS, np.float32),
                               {c: i for i, c in enumerate(subs)})
            mgr.process_block(taps)
            states.append((
                [(u.rx_chan, u.ext_name, u.freq_khz, u.slot_idx,
                  None if u.ext is None else u.ext._samples)
                 for u in mgr.units],
                list(server.engine.calls),
                [(s["ext"], s["dial_khz"], s["text"]) for s in mgr.spots],
                mgr.uploads_gated,
                # /status's fields, as the server computes them
                (len(mgr.channels), len(mgr.spots)),
                [c.in_use for c in server.engine.ctl]))
        assert states[0] == states[1], f"block {blk}"
    units, _calls, spots, gated, status, _in_use = states[1]
    # FT8/FT4 ran FT8, then FT4 from block 80, then FT8 again
    assert [u[1] for u in units] == ["wspr", "FT8", "FT8"]
    assert any(call[1][0] == ("freq_hz", 14080000.0) for call in _calls)
    assert status == (3, len(spots)) and gated == len(spots) >= 3
    texts = [(e, t.split()[:3]) for e, _d, t in spots]
    assert ("FT8", ["CQ", "K1ABC", "FN42"]) in texts
    assert ("FT4", ["CQ", "K1ABC", "FN42"]) in texts
