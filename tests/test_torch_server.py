"""The KiwiSDR-protocol server of the port against the reference's, on the
CPU, and the port's serving behaviour on its own.

Side by side (C=4, audio_block=128, the ``run_server`` scene from a
seeded ``SyntheticSource``, ``realtime=False``): the reference server
serves the scripted clients for ``WARM`` blocks; its streaming state, its
control mirrors, its per-channel ADPCM codec state and its waterfall slots
are then carried into the port (``convert``), and both serve ``K`` more
blocks to the same clients over in-process sockets.  The lanes are
compared from that settled state, because while the passband FIR fills
the AGC lifts float32 rounding by 80 dB and nonlinear lanes part.

Tolerances:
- packet kinds, order, SND flags and sequence numbers, the IQ header's
  GPS time, W/F headers: identical;
- the S-meter field: within 1 LSB (0.1 dB);
- s16 payloads (AM, its camper, USB with the LMS chain on, IQ): within
  2 LSB, but 6 LSB on the LMS lane, whose adaptive weights feed rounding
  back;
- the ADPCM payload (the SAM lane): compared after decoding, max |difference| <= 1e-3 of
  full scale (the codec is not continuous: one LSB of input can change
  later nibbles, but both decodes track their inputs);
- W/F rows: within 1 dB unit a bin;
- the S-meter extension's float: within 0.05 dB.

Everything else drives the port alone: late joiner, slow client, keepalive
kick, password check, the stall ladder through ``_device_get``, the HTTP
front on an ephemeral port, the refused constructor arguments.
"""

import asyncio
import json
import struct
import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import AdminSock
from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.ops import adpcm as jadpcm
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.runtime import stream as jstream
from flydog_sdr_gps_tpu.server import kiwi_server as jks
from flydog_sdr_gps_tpu.server import wf_service as jwf
from flydog_sdr_gps_tpu_torch import convert, run_server
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import adpcm as tadpcm
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks
from flydog_sdr_gps_tpu_torch.server import packets
from flydog_sdr_gps_tpu_torch.server import wf_service as twf
from flydog_sdr_gps_tpu_torch.utils.cfg import Config

C, BLOCK = 4, 128
WARM, K = 10, 6
HZ_PER_START = 30.0e6 / (1024 << 14)


def am_mod(t):
    return 1.0 + 0.6 * np.sin(2 * np.pi * 1000.0 * t)


def scene():
    """The ``run_server`` scene, the AM station with a steady 1 kHz tone."""
    return dict(tones=[(7.100e6, 0.30, am_mod), (14.2018e6, 0.15),
                       (10.000e6, 0.20)], noise_rms=3e-4, seed=7)


# (ts, stream, commands), in the order the sockets connect
SCRIPT = [
    ("a", "SND", ["SET auth t=kiwi p=", "SET ident_user=am",
                  "SET mod=am low_cut=-4000 high_cut=4000 freq=7100.000",
                  "SET compression=0", "SET little-endian",
                  "SET agc=1 manGain=50"]),
    ("a", "EXT", ["SET auth t=kiwi p=",
                  "SET ext_switch_to_client=S_meter first_time=1"]),
    ("b", "SND", ["SET auth t=kiwi p=",
                  "SET mod=usb low_cut=300 high_cut=2700 freq=14201.000",
                  "SET compression=0", "SET nr algo=2",
                  "SET nr type=1 en=1", "SET nr type=0 en=1"]),
    ("b", "W/F", ["SET auth t=kiwi p=", "SET zoom=0 start=0",
                  "SET wf_speed=4"]),
    ("c", "SND", ["SET auth t=kiwi p=",
                  "SET mod=sam low_cut=-4000 high_cut=4000 freq=7100.000",
                  "SET compression=1"]),
    ("d", "SND", ["SET auth t=kiwi p=",
                  "SET mod=iq low_cut=-5000 high_cut=5000 freq=14201.000"]),
    ("d", "W/F", ["SET auth t=kiwi p=", "SET wf_comp=0",
                  f"SET zoom=5 start={int(13.73125e6 / HZ_PER_START)}",
                  "SET MARKER min=14000 max=14400"]),
    ("m", "MON", ["SET auth t=kiwi p=", "SET compression=0",
                  "SET little-endian"]),
]
SND_SOCKS = [("a", "SND"), ("b", "SND"), ("c", "SND"), ("d", "SND"),
             ("m", "MON")]


class Sock:
    """An in-process socket: the surface a connection asks of one."""

    def __init__(self, gate: asyncio.Event | None = None):
        self.sent: list[bytes] = []
        self.closed = False
        self.gate = gate            # a stalled client: sends wait here

    async def send_bytes(self, data):
        if self.gate is not None:
            await self.gate.wait()
        self.sent.append(bytes(data))

    async def close(self):
        self.closed = True

    def of(self, tag: bytes) -> list[bytes]:
        return [p for p in self.sent if p[:len(tag)] == tag]


async def attach(server, mod, ts, stream, sock):
    """What both servers' ``ws_entry`` do when a socket connects (the
    reference has it inside its aiohttp handler only)."""
    if hasattr(server, "open_stream"):
        return await server.open_stream(ts, stream, sock, "127.0.0.1")
    conn = server.conns.get(ts)
    if conn is None:
        conn = mod.Connection(server, ts)
        server.conns[ts] = conn
    conn.ip = "127.0.0.1"
    if stream == "EXT":
        conn.ext_ws = sock
    elif stream == "SND":
        conn.snd_ws = sock
    elif stream == "W/F":
        conn.wf_ws = sock
    elif stream == "MON":
        conn.snd_ws = sock
        target = next(c for c in server.conns.values()
                      if c is not conn and c.rx_chan is not None)
        conn.rx_chan, conn.camping = target.rx_chan, True
    if conn.rx_chan is None:
        assert server.claim_channel(conn) is not None
    return conn


async def connect_all(server, mod):
    socks = {}
    for ts, stream, cmds in SCRIPT:
        sock = socks[(ts, stream)] = Sock()
        conn = await attach(server, mod, ts, stream, sock)
        for cmd in cmds:
            await conn.handle_set(cmd, stream)
    return socks


async def serve_until(server, socks, counts: dict, timeout=600.0):
    """Run the block loop until every listed socket holds its count of
    SND packets; let the running block finish."""
    server._stop.clear()
    task = asyncio.create_task(server.block_loop())
    t0 = time.monotonic()
    while any(len(socks[k].of(b"SND")) < n for k, n in counts.items()):
        await asyncio.sleep(0.01)
        assert not task.done(), task.exception()
        assert time.monotonic() - t0 < timeout, "the server stalled"
    server._stop.set()
    await task
    await asyncio.sleep(0.05)           # sender tasks drain


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def carry_over(ref, port):
    """Put the port's server into the reference server's state."""
    re, pe = ref.engine, port.engine
    pe.state = convert.state_from_ref(_numpy_tree(re.state), pe.params,
                                      "unfused", "cpu")
    tuned_by_sets = pe.tuning
    convert.load_ctl(pe, re.ctl)
    for f in ("bank", "dphi1", "pb_coef", "mode", "nr_notch_on",
              "nr_den_on", "manual_gain_db"):
        a, b = getattr(pe.tuning, f), getattr(tuned_by_sets, f)
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), f
    pe.seq, pe.block_ticks = re.seq, re.block_ticks
    while pe.source.ticks < re.source.ticks:
        pe.source.next_block(pe.params.ddc.adc_block)
    assert pe.source.ticks == re.source.ticks
    port._chan_codec = convert.chan_codec_from_ref(ref._chan_codec)
    for ts, rc in ref.conns.items():
        pc = port.conns[ts]
        assert pc.rx_chan == rc.rx_chan and pc.mode == rc.mode
        assert pc.snd_group_key() == rc.snd_group_key()
        pc.snd_seq, pc.wf_seq = rc.snd_seq, rc.wf_seq
        if pc.ext is not None:
            pc.ext._n = rc.ext._n
    assert set(port.wf.slots) == set(ref.wf.slots)
    for key, rs in ref.wf.slots.items():
        ps = port.wf.slots[key]
        ps.state = convert.wf_state_from_ref(_numpy_tree(rs.state), "cpu")
        ps.acc = [torch.from_numpy(np.array(a)) for a in rs.acc]
        ps.dirty, ps.row_seq = rs.dirty, rs.row_seq
        ps.row_db = None if rs.row_db is None else np.array(rs.row_db)


@pytest.fixture(scope="module")
def pair():
    """{(ts, stream): (reference packets, port packets)} of the K blocks
    served from the common state, plus both servers."""
    mp = pytest.MonkeyPatch()
    every_block = (0, 1e9, 1e9, 1e9, 1e9)    # a W/F row every block
    mp.setattr(jwf, "WF_SPEEDS_FPS", every_block)
    mp.setattr(twf, "WF_SPEEDS_FPS", every_block)

    async def run():
        ref = jks.KiwiServer(jstream.StreamEngine(
            jrx.RxParams(num_channels=C, audio_block=BLOCK, stage2="poly"),
            jsource.SyntheticSource(**scene())), realtime=False)
        port = tks.KiwiServer(tstream.StreamEngine(
            trx.RxParams(num_channels=C, audio_block=BLOCK,
                         stage2="unfused"),
            tsource.SyntheticSource(**scene()), device="cpu"),
            realtime=False)
        rs = await connect_all(ref, jks)
        ps = await connect_all(port, tks)
        await asyncio.sleep(0.05)       # the sender tasks drain
        # the volleys of MSG replies so far are part of the comparison
        hello = {k: (list(rs[k].sent), list(ps[k].sent)) for k in rs}
        await serve_until(ref, rs, {k: WARM for k in SND_SOCKS})
        carry_over(ref, port)
        codec0 = convert.chan_codec_from_ref(ref._chan_codec)
        for s in list(rs.values()) + list(ps.values()):
            s.sent.clear()
        await serve_until(ref, rs, {k: K for k in SND_SOCKS})
        await serve_until(port, ps, {k: K for k in SND_SOCKS})
        for srv in (ref, port):
            for conn in list(srv.conns.values()):
                conn.close_sender()
        return dict(hello=hello, ref=ref, port=port, codec0=codec0,
                    socks={k: (rs[k], ps[k]) for k in rs})

    try:
        yield asyncio.run(run())
    finally:
        mp.undo()


def _snd(pkt):
    flags = pkt[3]
    seq, = struct.unpack("<I", pkt[4:8])
    sm, = struct.unpack(">H", pkt[8:10])
    n = 20 if flags & packets.SND_FLAG_MODE_IQ else 10
    return flags, seq, sm, pkt[10:n], pkt[n:]


def _kinds(sock, n_snd=None):
    out, snd = [], 0
    for p in sock.sent:
        kind = p[:3]
        out.append(kind)
        snd += kind == b"SND"
        if n_snd is not None and snd >= n_snd:
            break
    return out


def test_hello_volleys_identical(pair):
    """Every reply to the scripted SETs (badp, the audio and waterfall
    init messages, the DX markers, the extension's ready) is the same
    bytes."""
    n = 0
    for key, (want, got) in pair["hello"].items():
        assert got == want, key
        n += len(got)
    assert n >= 12
    mkr = [p for p in pair["hello"][("d", "W/F")][1] if p[:8] == b"MSG mkr="]
    assert mkr and json.loads(mkr[0][8:])[0] == {"t": 4}


@pytest.mark.parametrize("key", SND_SOCKS)
def test_snd_headers_identical(pair, key):
    rs, ps = pair["socks"][key]
    assert _kinds(ps, K) == _kinds(rs, K)
    want, got = rs.of(b"SND")[:K], ps.of(b"SND")[:K]
    assert len(got) == K
    for w, g in zip(want, got):
        wf_, ws, wm, wh, wp = _snd(w)
        gf, gs, gm, gh, gp = _snd(g)
        assert (gf, gs, gh, len(gp)) == (wf_, ws, wh, len(wp))
        assert abs(gm - wm) <= 1
    seqs = [_snd(g)[1] for g in got]
    assert seqs == list(range(seqs[0], seqs[0] + K)) and seqs[0] >= WARM


@pytest.mark.parametrize("key,dtype,lsb", [
    (("a", "SND"), "<i2", 2), (("b", "SND"), ">i2", 6),
    (("d", "SND"), ">i2", 2), (("m", "MON"), "<i2", 2)])
def test_s16_payloads_close(pair, key, dtype, lsb):
    rs, ps = pair["socks"][key]
    worst, peak = 0, 0
    for w, g in zip(rs.of(b"SND")[:K], ps.of(b"SND")[:K]):
        a = np.frombuffer(_snd(w)[4], dtype).astype(np.int32)
        b = np.frombuffer(_snd(g)[4], dtype).astype(np.int32)
        worst = max(worst, int(np.abs(a - b).max()))
        peak = max(peak, int(np.abs(a).max()))
    assert peak > 25, "the lane is silent"
    assert worst <= lsb, worst


@pytest.mark.parametrize("key", [("c", "SND")])
def test_adpcm_payloads_close_after_decoding(pair, key):
    rs, ps = pair["socks"][key]
    out = []
    for mod, sock in ((jadpcm, rs), (tadpcm, ps)):
        # both decoders start from the encoders' common state
        pred, index = pair["codec0"][2]
        st, pcm = mod.AdpcmState(int(pred), int(index)), []
        for p in sock.of(b"SND")[:K]:
            flags, *_rest, payload = _snd(p)
            assert flags & packets.SND_FLAG_COMPRESSED
            pcm.append(mod.decode(np.frombuffer(payload, np.uint8), st))
        out.append(np.concatenate(pcm).astype(np.float64) / 32768.0)
    ref, got = out
    assert np.abs(ref).max() > 0.01
    assert np.abs(got - ref).max() <= 1e-3


def test_camper_gets_the_owners_payload(pair):
    _, ps = pair["socks"][("a", "SND")]
    _, pm = pair["socks"][("m", "MON")]
    own = {_snd(p)[1] - _snd(ps.of(b"SND")[0])[1]: _snd(p)[4]
           for p in ps.of(b"SND")[:K]}
    for p in pm.of(b"SND")[:K]:
        k = _snd(p)[1] - _snd(pm.of(b"SND")[0])[1]
        assert _snd(p)[4] == own[k]


@pytest.mark.parametrize("key,zoom", [(("b", "W/F"), 0), (("d", "W/F"), 5)])
def test_wf_rows_close(pair, key, zoom):
    rs, ps = pair["socks"][key]
    want, got = rs.of(b"W/F"), ps.of(b"W/F")
    n = min(len(want), len(got))
    assert n >= K - 2
    for w, g in zip(want[:n], got[:n]):
        assert g[:16] == w[:16]                      # x_bin, zoom, seq
        x_bin, fz, _seq = struct.unpack("<III", g[4:16])
        assert fz == zoom                            # and no compression
        a = np.frombuffer(w[16:], np.uint8).astype(np.int32)
        b = np.frombuffer(g[16:], np.uint8).astype(np.int32)
        assert len(b) == 1024 and np.abs(a - b).max() <= 1
    row = np.frombuffer(got[n - 1][16:], np.uint8)
    span = 30e6 / 2 ** zoom
    lo = struct.unpack("<I", got[n - 1][4:8])[0] * HZ_PER_START
    px = int((14.2018e6 - lo) / span * 1024)
    assert abs(int(np.argmax(row[px - 8:px + 8])) - 8) <= 2
    assert row[px - 8:px + 8].max() > np.median(row) + 30


def test_extension_messages_close(pair):
    rs, ps = pair["socks"][("a", "EXT")]
    want, got = rs.of(b"EXT smeter "), ps.of(b"EXT smeter ")
    n = min(len(want), len(got))
    assert n >= K - 1
    for w, g in zip(want[:n], got[:n]):
        a, = struct.unpack("<f", w[11:15])
        b, = struct.unpack("<f", g[11:15])
        assert abs(a - b) <= 0.05 and -60 < b < 0


def test_codec_state_and_control_mirrors_convert(pair):
    ref, port = pair["ref"], pair["port"]
    codec = convert.chan_codec_from_ref(ref._chan_codec)
    assert sorted(codec) == sorted(port._chan_codec) == [2]
    assert codec[2].dtype == np.int32 and codec[2].any()
    assert codec[2] is not ref._chan_codec[2]
    ctl = convert.ctl_from_ref(ref.engine.ctl)
    assert [(c.freq_hz, c.mode, c.passband, c.nr_notch_on, c.nr_den_on,
             c.in_use) for c in ctl] == \
        [(c.freq_hz, c.mode, c.passband, c.nr_notch_on, c.nr_den_on,
          c.in_use) for c in port.engine.ctl]
    assert ctl[1].nr_notch_on and ctl[1].nr_den_on
    with pytest.raises(ValueError):
        convert.load_ctl(port.engine, ref.engine.ctl[:2])
    with pytest.raises(ValueError):
        convert.chan_codec_from_ref({0: np.zeros(3)})


# -- the port alone -----------------------------------------------------------

def _port_server(channels=C, cfg=None, **scene_kw):
    sc = dict(scene(), **scene_kw)
    eng = tstream.StreamEngine(
        trx.RxParams(num_channels=channels, audio_block=BLOCK,
                     stage2="unfused"),
        tsource.SyntheticSource(**sc), device="cpu")
    return tks.KiwiServer(eng, cfg=cfg, realtime=False, port=0)


async def _listener(server, ts, freq_khz=14201.0, sock=None, auth="p="):
    sock = sock or Sock()
    conn = await server.open_stream(ts, "SND", sock, "127.0.0.1")
    await conn.handle_set(f"SET auth t=kiwi {auth}", "SND")
    await conn.handle_set(
        f"SET mod=usb low_cut=300 high_cut=2700 freq={freq_khz:.3f}", "SND")
    await conn.handle_set("SET compression=0", "SND")
    return conn, sock


async def _wait(cond, timeout=120.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        await asyncio.sleep(0.01)
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"


def test_late_joiner_is_served_from_the_largest_warm_bucket():
    """A second listener grows the bucket: while the new bucket is being
    prepared off the serving path the first stream keeps flowing, and the
    joiner hears audio as soon as it is warm."""
    async def scenario():
        server = _port_server()
        delay = 0.6
        real = server.engine.prewarm_gather

        def slow_prewarm(bucket):
            time.sleep(delay)
            real(bucket)
        server.engine.prewarm_gather = slow_prewarm
        server.start_tasks()
        try:
            _, s1 = await _listener(server, "c1")
            await _wait(lambda: len(s1.of(b"SND")) >= 3, what="stream 1")
            assert server._warm_buckets == {1}
            t_join, n_join = time.monotonic(), len(s1.of(b"SND"))
            _, s2 = await _listener(server, "c2", 14200.5)
            await _wait(lambda: len(s2.of(b"SND")) >= 1, what="stream 2")
            assert time.monotonic() - t_join >= delay * 0.5
            assert len(s1.of(b"SND")) - n_join >= 2, \
                "stream 1 stalled while bucket 2 was prepared"
            assert 2 in server._warm_buckets
            assert server.compiles_in_flight == 0
            seqs = [_snd(p)[1] for p in s1.of(b"SND")]
            assert seqs == list(range(len(seqs)))
            # with an engine whose prewarm has nothing to do, the joiner
            # hears audio within two blocks
            server.engine.prewarm_gather = real
            n3 = server.engine.seq
            _, s3 = await _listener(server, "c3", 14200.7)
            await _wait(lambda: len(s3.of(b"SND")) >= 1, what="stream 3")
            assert server.engine.seq - n3 <= 4
        finally:
            await server.stop()
    asyncio.run(scenario())


def test_slow_client_drops_oldest_stream_packets_and_counts(monkeypatch):
    # a shorter send queue fills in fewer blocks; the policy is the same
    monkeypatch.setattr(tks.Connection, "SENDQ_MAX", 16)

    async def scenario():
        server = _port_server()
        gate = asyncio.Event()
        server.start_tasks()
        try:
            conn, slow = await _listener(server, "slow", sock=Sock(gate))
            _, fast = await _listener(server, "fast", 14200.5)
            await _wait(lambda: conn.send_drops >= 3, what="drops")
            drops = conn.send_drops
            assert len(fast.of(b"SND")) >= tks.Connection.SENDQ_MAX
            gate.set()
            await _wait(lambda: len(slow.of(b"SND")) >= 8, what="recovery")
            # the replies to the SETs survived the stall; the oldest
            # audio went, the rest arrives in order
            assert slow.sent[0] == b"MSG badp=0"
            assert [p for p in slow.sent if p.startswith(b"MSG audio_init")]
            seqs = [_snd(p)[1] for p in slow.of(b"SND")]
            assert seqs == list(range(drops, drops + len(seqs)))
            assert conn.send_drops == drops
            # the policy loop tells the listener how much it lost
            task = asyncio.create_task(server.policy_loop(0.05))
            await _wait(lambda: [p for p in slow.sent
                                 if p.startswith(b"MSG audio_dropped=")],
                        what="audio_dropped")
            task.cancel()
        finally:
            await server.stop()
    asyncio.run(scenario())


def test_keepalive_kick_frees_the_channel():
    async def scenario():
        server = _port_server()
        server.keepalive_sec = 0.2
        server.policy_period = 0.05
        server.start_tasks()
        try:
            conn, sock = await _listener(server, "idle")
            assert server.engine.ctl[0].in_use
            alive, asock = await _listener(server, "alive", 14200.5)
            t0 = time.monotonic()
            while "idle" in server.conns:
                await alive.handle_set("SET keepalive", "SND")
                await asyncio.sleep(0.05)
                assert time.monotonic() - t0 < 30
            assert sock.closed and conn.kick and server.kicks == 1
            assert not server.engine.ctl[0].in_use
            assert "alive" in server.conns and not asock.closed
        finally:
            await server.stop()
    asyncio.run(scenario())


@pytest.mark.parametrize("stored", ["plain", "hashed"])
def test_password_check(stored):
    from flydog_sdr_gps_tpu_torch.utils import security
    cfg = Config()
    cfg.set("user_password", "sesame" if stored == "plain"
            else security.hash_password("sesame", iters=500))

    async def scenario():
        server = _port_server(cfg=cfg)
        bad, bsock = await _listener(server, "bad", auth="p=wrong")
        good, gsock = await _listener(server, "good", 14200.5,
                                      auth="p=sesame")
        await asyncio.sleep(0.05)
        assert bsock.sent == [b"MSG badp=1"] and not bad.authed
        assert gsock.sent[0] == b"MSG badp=0" and good.authed
        assert good.tlimit_exempt
        server.start_tasks()
        try:
            await _wait(lambda: len(gsock.of(b"SND")) >= 2, what="audio")
            assert not bsock.of(b"SND")
        finally:
            await server.stop()
    asyncio.run(scenario())


def test_stall_ladder_resets_then_asks_for_a_restart():
    """A fetch that never comes back: warn, reset the streaming state,
    then kick the clients and request the restart."""
    async def scenario():
        server = _port_server()
        server.stall_warn_s = 0.1
        server.stall_reset_blocks = 2
        server.stall_restart_blocks = 3
        release = []

        def wedged(handle):
            while not release:
                time.sleep(0.02)
            return handle.result()
        server._device_get = wedged
        _, sock = await _listener(server, "c1")
        server.start_tasks()
        try:
            await _wait(lambda: server.restart_requested, 30, "restart")
            await _wait(lambda: server.engine.resets >= 1, 10, "reset")
            assert sock.closed and not server.conns
            assert server._stop.is_set()
        finally:
            release.append(True)
            await server.stop()
    asyncio.run(scenario())


def test_stall_while_a_bucket_is_prepared_does_not_escalate():
    async def scenario():
        server = _port_server()
        server.stall_warn_s = 0.05
        server.stall_reset_blocks = 1
        server.stall_restart_blocks = 2
        server.compiles_in_flight = 1
        t_end = time.monotonic() + 0.5

        def slow(handle):
            while time.monotonic() < t_end:
                time.sleep(0.02)
            return handle.result()
        server._device_get = slow
        _, sock = await _listener(server, "c1")
        server.start_tasks()
        try:
            await _wait(lambda: len(sock.of(b"SND")) >= 1, what="audio")
            assert not server.restart_requested
            assert server.engine.resets == 0
        finally:
            await server.stop()
    asyncio.run(scenario())


@pytest.mark.parametrize("kw,word", [
    (dict(autorun=["nosuch:518"]), "autorun")])
def test_unported_parts_are_refused_by_name(kw, word):
    """Autorun runs (``test_torch_autorun.py``); a unit of a decoder that
    neither package registers is refused, naming it."""
    eng = _port_server().engine
    with pytest.raises(ValueError,
                       match=f"{word}: unknown extension 'nosuch'"):
        tks.KiwiServer(eng, **kw)


def test_every_reference_extension_is_taken_by_autorun():
    """Every name the reference registers (the host-only decoders too) is
    an autorun unit of the server and of ``run_server --autorun``, as in
    the reference."""
    eng = _port_server().engine
    server = tks.KiwiServer(eng, autorun=["NAVTEX:518", "navtex:490"])
    assert [u.slots for u in server.autorun.units] == \
        [[("NAVTEX", 518.0)], [("NAVTEX", 490.0)]]
    for name in ("NAVTEX", "DRM", "HFDL", "timecode"):
        args = run_server.parse_args(["--autorun", f"{name}:518"])
        assert args.autorun == [f"{name}:518"]


def test_mesh_engine_is_served_through_the_gather():
    """The multi-device engine is served through the same contract as
    the single one (``run_block_gather``, ``prewarm_gather``): a
    listener gets SND packets in sequence, and the bucket served is
    warm."""
    from flydog_sdr_gps_tpu_torch import parallel
    from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
    eng = ShardedStreamEngine(
        trx.RxParams(num_channels=C, audio_block=BLOCK),
        tsource.SyntheticSource(**scene()),
        mesh=parallel.make_mesh(2, 2, devices=["cpu"] * 4))

    async def scenario():
        server = tks.KiwiServer(eng, realtime=False, port=0)
        server.start_tasks()
        try:
            _, sock = await _listener(server, "m1")
            await _wait(lambda: len(sock.of(b"SND")) >= 3, what="audio")
            seqs = [_snd(p)[1] for p in sock.of(b"SND")]
            assert seqs == list(range(len(seqs)))
            assert 1 in server._warm_buckets
        finally:
            await server.stop()
    asyncio.run(scenario())


@pytest.mark.parametrize("flag,word", [
    (["--autorun", "nosuch:518"], "autorun")])
def test_run_server_refuses_unported_flags(flag, word, capsys):
    with pytest.raises(SystemExit) as e:
        run_server.parse_args(flag)
    assert e.value.code == 2
    assert word in capsys.readouterr().err


def test_run_server_mesh_builds_on_the_cpu_and_answers_status(monkeypatch):
    """``run_server --cpu --mesh time=2,chan=2`` builds the multi-device
    engine over four CPU devices on the host scene, the channel count
    rounded up to a multiple of 4, and answers /status on port 0; on a
    host whose card count is not time*chan it exits naming the count."""
    from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
    args = run_server.parse_args(["--cpu", "--mesh", "time=2,chan=2",
                                  "--channels", "3", "--no-realtime",
                                  "--port", "0"])
    server, _cfg, eng = run_server.build(args)
    assert isinstance(eng, ShardedStreamEngine)
    assert eng.mesh.shape == {"time": 2, "chan": 2}
    assert eng.params.num_channels == 4
    assert isinstance(eng.source, tsource.SyntheticSource)

    aiohttp = pytest.importorskip("aiohttp")

    async def scenario():
        runner = await server.start()
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(
                        f"http://127.0.0.1:{server.port}/status") as r:
                    text = await r.text()
            assert "status=active" in text and "users_max=4" in text
        finally:
            await server.stop()
            await runner.cleanup()
    asyncio.run(scenario())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 4 cards; this host has 1"):
        run_server.build(run_server.parse_args(["--mesh", "time=2,chan=2"]))
    with pytest.raises(SystemExit):
        run_server.parse_args(["--mesh", "time=two"])


def test_run_server_needs_the_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_server.build(run_server.parse_args(["--channels", "2"]))


def test_run_server_serves_http_and_a_stream_on_an_ephemeral_port():
    """``run_server --cpu --channels 4 --no-realtime`` on port 0: /status,
    /users, /VER, /dx, the web UI, and one SND stream whose first packet
    equals what an in-process socket camping on the channel gets."""
    aiohttp = pytest.importorskip("aiohttp")
    args = run_server.parse_args(["--cpu", "--channels", "4",
                                  "--no-realtime", "--port", "0"])

    async def scenario():
        server, _cfg, eng = run_server.build(args)
        assert eng.device.type == "cpu" and eng.params.audio_block == 128
        assert len(server.dx.labels) > 1000
        runner = await server.start()
        assert server.port != 0
        base = f"http://127.0.0.1:{server.port}"
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(base + "/status") as r:
                    text = await r.text()
                assert "status=active" in text and "users_max=4" in text
                assert "sdr_hw=cpu" in text
                async with http.get(base + "/VER") as r:
                    assert await r.json() == {"maj": 0, "min": 1}
                async with http.get(base + "/dx?min=7000&max=7200") as r:
                    assert any(row[0] == 7100.0
                               for row in (await r.json())["dx"])
                async with http.get(base + "/") as r:
                    assert "<canvas" in await r.text()
                ws = await http.ws_connect(base + "/1234/SND")
                await ws.send_str("SET auth t=kiwi p=")
                await ws.send_str(
                    "SET mod=usb low_cut=300 high_cut=2700 freq=14201.000")
                await ws.send_str("SET compression=0")
                await _wait(lambda: "1234" in server.conns
                            and server.conns["1234"].authed, what="auth")
                camper = Sock()
                mon = await server.open_stream("mon", "MON", camper)
                await mon.handle_set("SET auth t=kiwi p=", "MON")
                await mon.handle_set("SET compression=0", "MON")
                got = {}
                while len(got) < 3:
                    m = await asyncio.wait_for(ws.receive(), 60)
                    assert m.type == aiohttp.WSMsgType.BINARY
                    if m.data[:3] == b"SND":
                        got[_snd(m.data)[1]] = m.data
                await _wait(lambda: len(camper.of(b"SND")) >= 1,
                            what="camper")
                # a camper's packet carries the same payload and S-meter
                # as the client's packet of that block
                payloads = {_snd(p)[4]: _snd(p)[2] for p in got.values()}
                while not any(payloads.get(_snd(p)[4]) == _snd(p)[2]
                              for p in camper.of(b"SND")):
                    m = await asyncio.wait_for(ws.receive(), 60)
                    if m.data[:3] == b"SND":
                        payloads[_snd(m.data)[4]] = _snd(m.data)[2]
                    assert len(payloads) < 40
                async with http.get(base + "/users") as r:
                    users = await r.json()
                assert [u["m"] for u in users] == ["usb", "lsb"]
                async with http.get(base + "/s-meter") as r:
                    rows = await r.json()
                assert rows[0]["dbm"] is not None
                await ws.close()
            await _wait(lambda: "1234" not in server.conns, what="release")
        finally:
            await server.stop()
            await runner.cleanup()
    asyncio.run(scenario())


def test_server_core_runs_without_aiohttp(monkeypatch):
    """Only the HTTP front needs aiohttp."""
    monkeypatch.setattr(tks, "web", None)

    async def scenario():
        server = _port_server()
        with pytest.raises(RuntimeError, match="aiohttp not available"):
            await server.start()
        _, sock = await _listener(server, "c1")
        server.start_tasks()
        try:
            await _wait(lambda: len(sock.of(b"SND")) >= 2, what="audio")
        finally:
            await server.stop()
    asyncio.run(scenario())


# -- the GPS subsystem in the server ---------------------------------------

class _Request:
    def __init__(self, **query):
        self.query = {k: str(v) for k, v in query.items()}


def _gps_receiver(tmod, device="cpu"):
    """A small host-path sky (3 GPS satellites, one decoy PRN) and a
    4-row manager on the CPU, fed 0.1 s chunks as fast as they come."""
    from flydog_sdr_gps_tpu_torch.models.gps import manager as tman
    from flydog_sdr_gps_tpu_torch.models.gps import scene as tscene
    rx_pos = tscene.ecef_from_lla(47.37, 8.54, 450.0)
    t0 = 345600.0 + 3.0
    ephs = tscene.visible_constellation(rx_pos, t0, n_sats=3)
    sky = tscene.GpsScene(rx_pos, ephs, t0, duration=30.0, clock_ppm=0.4,
                          noise=0.8, amplitude=0.6, device="host")
    decoy = next(p for p in (3, 7, 30) if p not in ephs)
    mgr = tman.GpsManager(max_chans=4, prns=tuple(ephs) + (decoy,),
                          device=device)
    return tmod.GpsReceiver(sky, mgr, chunk_seconds=0.1), ephs


def test_server_runs_gps_and_reports_it():
    """``KiwiServer(gps=...)`` on the CPU: the receiver starts with the
    serving core, tracks the sky, and ADMIN ``gps``, ``/gps``,
    ``/gps?iq=<prn>``, ``/status`` and the stats' ``gf`` report it with
    the reference's keys."""
    from flydog_sdr_gps_tpu.models.gps import manager as jman
    from flydog_sdr_gps_tpu.runtime import gps_service as jgps
    from flydog_sdr_gps_tpu_torch.runtime import gps_service as tgps
    ref_keys = set(jgps.GpsReceiver(None, jman.GpsManager()).status())
    gps, ephs = _gps_receiver(tgps)

    async def scenario():
        server = _port_server()
        server = tks.KiwiServer(server.engine, realtime=False, port=0,
                                gps=gps)
        assert gps.engine is server.engine
        conn, sock = await _listener(server, "c1")
        server.start_tasks()
        try:
            await _wait(lambda: gps.mgr.ticks >= 3 * gps.chunk
                        and len(gps.mgr.channels) >= 2, timeout=90,
                        what="GPS chunks and tracked rows")
            await conn.handle_set("SET STATS_UPD ch=0", "SND")
            await _wait(lambda: any(b"stats_cb" in p for p in sock.sent),
                        what="the stats reply")
            admin = AdminSock(["SET auth t=admin p=", "SET gps"])
            await server._ws_admin_loop(admin, lambda: [], "127.0.0.1")
            resp = await server.http_gps(_Request())
            prn = sorted(gps.mgr.channels)[0]
            resp_iq = await server.http_gps(_Request(iq=prn))
            status = (await server.http_status(_Request())).text
        finally:
            await server.stop()
        return sock, admin, resp, resp_iq, status
    sock, admin, resp, resp_iq, status = asyncio.run(scenario())
    assert gps.errors == 0
    assert set(gps.mgr.channels) <= set(ephs) and len(gps.mgr.channels) >= 2
    reply = [p for p in admin.sent if p[:4] == b"GPS "]
    st = json.loads(reply[0][4:])
    assert st["enabled"] is True and set(st) == ref_keys | {"enabled"}
    assert st["tracking"] == len(st["prns"]) >= 2
    body = json.loads(resp.text)
    assert body["enabled"] is True and set(body) == ref_keys | {"enabled"}
    iq = json.loads(resp_iq.text)
    assert set(iq) == {"prn", "iq"} and len(iq["iq"]) > 0
    assert all(len(pair) == 2 for pair in iq["iq"])
    assert f"gps_good={st['tracking']}" in status and "fixes=0" in status
    stats = [p for p in sock.sent if b"stats_cb" in p]
    assert stats and b"gf" in stats[-1]


def test_gps_clock_retunes_like_the_reference():
    """``GpsReceiver._apply_clock`` with a locked clock moves the port
    engine's tuning words exactly as it moves the reference engine's."""
    from flydog_sdr_gps_tpu.models.gps import manager as jman
    from flydog_sdr_gps_tpu.ops import demod as jdemod
    from flydog_sdr_gps_tpu.runtime import gps_service as jgps
    from flydog_sdr_gps_tpu_torch.models.gps import manager as tman
    from flydog_sdr_gps_tpu_torch.ops import demod as tdemod
    from flydog_sdr_gps_tpu_torch.ops.nco import words_from_limbs
    from flydog_sdr_gps_tpu_torch.runtime import gps_service as tgps
    params = dict(num_channels=C, audio_block=BLOCK)
    jeng = jstream.StreamEngine(jrx.RxParams(**params),
                                jsource.SyntheticSource(**scene()))
    teng = tstream.StreamEngine(trx.RxParams(**params),
                                tsource.SyntheticSource(**scene()),
                                device="cpu")
    for eng, dm in ((jeng, jdemod), (teng, tdemod)):
        for ch, f in enumerate((7.1e6, 14.2e6, 10.0e6, 21.3e6)):
            eng.set_channel(ch, freq_hz=f, mode=dm.MODE_USB)
    recs = [jgps.GpsReceiver(None, jman.GpsManager(), engine=jeng),
            tgps.GpsReceiver(None, tman.GpsManager(device="cpu"),
                             engine=teng)]
    fs_true = recs[1].mgr.tp.fs * (1 + 0.4e-6)
    words = []
    for rec in recs:
        for k in range(6):
            rec.mgr.clock.update(2.0 * k, int(round(2.0 * k * fs_true)))
        assert rec.mgr.clock.locked
        before = rec.adc_clock_corrected
        rec._apply_clock()
        assert rec.retunes == 1 and rec.adc_clock_corrected != before
        words.append(rec.engine.tuning.dphi1)
    assert recs[0].adc_clock_corrected == recs[1].adc_clock_corrected
    ref = words_from_limbs(np.array(words[0], np.int32))
    assert torch.equal(words[1].cpu(), ref)
    # ticks are whole samples: 0.4 ppm of 16.368 MHz over 2 s is 13.1
    assert abs(recs[1].mgr.clock.correction_ppm - 0.4) < 0.01
    # a second call with the same estimate changes nothing
    recs[1]._apply_clock()
    assert recs[1].retunes == 1


def test_run_server_gps_starts_on_the_cpu():
    """``run_server --gps --cpu``: the reference's sky (8 GPS satellites
    where visible, decoys 3, 7, 30, 4 Galileo) on the host path in 0.1 s
    chunks, paced at real time, the manager on the CPU; the receiver
    starts with the serving core and searches its first chunk."""
    args = run_server.parse_args(["--cpu", "--gps", "--channels", "2",
                                  "--no-realtime", "--port", "0"])
    assert args.gps and args.gps_ppm == 0.4

    async def scenario():
        server, _cfg, eng = run_server.build(args)
        gps = server.gps
        assert gps is not None and gps.engine is eng and gps.realtime
        assert gps.source.device == "host" and gps.source.eps == 0.4e-6
        assert gps.mgr.device.type == "cpu" and gps.mgr.max_chans == 12
        assert gps.chunk == round(0.1 * gps.mgr.tp.fs)
        assert {3, 7, 30} <= set(gps.mgr.prns)
        assert len(gps.mgr.galileo_prns) == 4
        server.start_tasks()
        try:
            await _wait(lambda: gps.mgr.ticks > 0, timeout=120,
                        what="the first GPS chunk")
        finally:
            await server.stop()
        return gps
    gps = asyncio.run(scenario())
    assert gps.errors == 0 and len(gps.mgr.channels) > 0
