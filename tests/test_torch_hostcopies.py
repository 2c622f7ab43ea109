"""The port's own copies of the reference's host-only modules, held bit
for bit against the originals on seeded inputs.

``server.packets`` (every framing function), ``ops.adpcm`` (encode, decode,
``encode_batch``, the u8 codec; with the native library and with the
numpy versions), ``runtime.native`` (the sample converters, the sequence
check, the block ring), ``server.netproto`` bodies, ``utils.security``,
``utils.cfg``, ``utils.dx`` / ``utils.eibi`` lookups, ``utils.log`` /
``utils.trace``, ``server.update`` version parsing, the host-only
extensions, the GPS subsystem's host modules, and the decoders' host
code: the WSPR and FT8/FT4 candidate searches, soft symbols, tone powers,
LLRs and decoders on the reference's own front-end arrays, ``cw_decoder``,
``spot_upload``'s query and datagram bytes, ``server.autorun``'s spec
parser.  Nothing here has a tolerance: every comparison is ``==``.
"""

import json
import types

import numpy as np
import pytest

from flydog_sdr_gps_tpu import extensions as jext
from flydog_sdr_gps_tpu.ops import adpcm as jadpcm
from flydog_sdr_gps_tpu.runtime import native as jnative
from flydog_sdr_gps_tpu.server import netproto as jnetproto
from flydog_sdr_gps_tpu.server import packets as jpackets
from flydog_sdr_gps_tpu.server import update as jupdate
from flydog_sdr_gps_tpu.utils import cfg as jcfg
from flydog_sdr_gps_tpu.utils import dx as jdx
from flydog_sdr_gps_tpu.utils import eibi as jeibi
from flydog_sdr_gps_tpu.utils import log as jlog
from flydog_sdr_gps_tpu.utils import security as jsecurity
from flydog_sdr_gps_tpu.utils import trace as jtrace
from flydog_sdr_gps_tpu_torch import extensions as text
from flydog_sdr_gps_tpu_torch.ops import adpcm as tadpcm
from flydog_sdr_gps_tpu_torch.runtime import native as tnative
from flydog_sdr_gps_tpu_torch.server import netproto as tnetproto
from flydog_sdr_gps_tpu_torch.server import packets as tpackets
from flydog_sdr_gps_tpu_torch.server import update as tupdate
from flydog_sdr_gps_tpu_torch.utils import cfg as tcfg
from flydog_sdr_gps_tpu_torch.utils import dx as tdx
from flydog_sdr_gps_tpu_torch.utils import eibi as teibi
from flydog_sdr_gps_tpu_torch.utils import log as tlog
from flydog_sdr_gps_tpu_torch.utils import security as tsecurity
from flydog_sdr_gps_tpu_torch.utils import trace as ttrace


def _rng(seed=0):
    return np.random.default_rng(seed)


def _public_constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float, str, tuple, dict))}


# -- server.packets ---------------------------------------------------------

def test_packets_constants_equal():
    assert _public_constants(tpackets) == _public_constants(jpackets)
    assert len(_public_constants(tpackets)) >= 12


def _packet_cases():
    rng = _rng(1)
    audio = (0.7 * rng.standard_normal(256)).astype(np.float32)
    audio[:4] = (2.0, -2.0, 1.0, -1.0)          # clipping
    re_, im_ = (rng.standard_normal(128).astype(np.float32) * 0.3
                for _ in range(2))
    row = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    payload = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    return {
        "smeter_u16": lambda m: [m.smeter_u16(v) for v in
                                 (-200.0, -127.0, -73.4, -0.05, 20.0, 1e4)],
        "snd_packet": lambda m: m.snd_packet(0x12, 77, -81.3, payload),
        "snd_packet_wrap": lambda m: m.snd_packet(0xff, 2 ** 32 - 1, 3.0,
                                                  b""),
        "snd_packet_iq": lambda m: m.snd_packet_iq(
            0x08, 5, -50.0, 0, 345600, 123456789, payload),
        "audio_payload_s16_be": lambda m: m.audio_payload_s16(audio),
        "audio_payload_s16_le": lambda m: m.audio_payload_s16(audio, True),
        "iq_payload_s16_be": lambda m: m.iq_payload_s16(re_, im_),
        "iq_payload_s16_le": lambda m: m.iq_payload_s16(re_, im_, True),
        "wf_packet": lambda m: m.wf_packet(123456, 7, 99, row),
        "wf_packet_compressed": lambda m: m.wf_packet(0, 14, 1, row,
                                                      compressed=True),
        "msg": lambda m: m.msg(badp=0, audio_rate=12000,
                               sample_rate="12000.768049", name="a b"),
        "msg_empty": lambda m: m.msg(),
        "parse_set": lambda m: [m.parse_set(t) for t in (
            "SET mod=usb low_cut=300 high_cut=2700 freq=14200.000",
            "SET auth t=kiwi p=secret", "SET keepalive", "SET nr type=1 en=1",
            "SET zoom=7 start=12345.0", "SERVER DE CLIENT x SND", "",
            "SET ident_user=a%20b", "SET devl.p0=1.5")],
    }


@pytest.mark.parametrize("name", sorted(_packet_cases()))
def test_packets_framing_bit_for_bit(name):
    case = _packet_cases()[name]
    assert case(tpackets) == case(jpackets)


# -- ops.adpcm and runtime.native -------------------------------------------

def _pcm(seed, n=2048):
    rng = _rng(seed)
    t = np.arange(n)
    x = 9000 * np.sin(2 * np.pi * 1000 / 12000 * t) \
        + 3000 * rng.standard_normal(n)
    x[n // 2:n // 2 + 8] = (32767, -32768) * 4        # clipped bursts
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def test_adpcm_tables_equal():
    assert np.array_equal(tadpcm.STEP_TABLE, jadpcm.STEP_TABLE)
    assert np.array_equal(tadpcm.INDEX_TABLE, jadpcm.INDEX_TABLE)


def test_native_libraries_build_outside_the_package():
    """The port builds its host libraries into the ignored build
    directory, at first use, never beside the sources."""
    assert tnative.adpcm_native is not None
    assert tnative.NativeRing is not None
    pkg = tnative._DIR
    import os
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert os.path.isdir(tnative._BUILD_ROOT)
    assert os.sep + "build" + os.sep in tnative._BUILD_ROOT


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adpcm_encode_decode_bit_for_bit(path, seed):
    pcm = _pcm(seed)
    enc = {"native": lambda m, x, s: m.encode(x, s),
           "numpy": lambda m, x, s: m._encode_py(x, s)}[path]
    dec = {"native": lambda m, x, s: m.decode(x, s),
           "numpy": lambda m, x, s: m._decode_py(x, s)}[path]
    out = []
    for mod in (tadpcm, jadpcm):
        st_e, st_d = mod.AdpcmState(), mod.AdpcmState()
        # two packets: the state carries over
        nib = [enc(mod, pcm[:1024], st_e), enc(mod, pcm[1024:], st_e)]
        pcm2 = [dec(mod, nib[0], st_d), dec(mod, nib[1], st_d)]
        out.append((np.concatenate(nib), np.concatenate(pcm2),
                    (st_e.predictor, st_e.index),
                    (st_d.predictor, st_d.index)))
    (tn, tp, tse, tsd), (jn, jp, jse, jsd) = out
    assert np.array_equal(tn, jn) and tn.dtype == jn.dtype
    assert np.array_equal(tp, jp) and tp.dtype == jp.dtype
    assert (tse, tsd) == (jse, jsd)
    # and the two paths of the port agree with each other
    st = tadpcm.AdpcmState()
    assert np.array_equal(tadpcm._encode_py(pcm, st),
                          tadpcm.encode(pcm, tadpcm.AdpcmState()))


@pytest.mark.parametrize("native_on", [True, False])
def test_adpcm_encode_batch_bit_for_bit(native_on, monkeypatch):
    if not native_on:
        monkeypatch.setattr(tnative, "adpcm_native", None)
        monkeypatch.setattr(jnative, "adpcm_native", None)
    rows = np.stack([_pcm(s, 256) for s in range(5)])
    rng = _rng(9)
    out = []
    for mod in (tadpcm, jadpcm):
        states = np.stack([rng.integers(-3000, 3000, 5),
                           rng.integers(0, 89, 5)], axis=1).astype(np.int32)
        rng = _rng(9)                   # the same states for both
        enc1 = mod.encode_batch(rows, states)
        enc2 = mod.encode_batch(rows[:, ::-1].copy(), states)
        out.append((enc1, enc2, states.copy()))
    for a, b in zip(*out):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    # a batch row equals the single-stream encoder from the same state
    st = tadpcm.AdpcmState()
    zero = np.zeros((5, 2), np.int32)
    assert np.array_equal(tadpcm.encode_batch(rows, zero)[3],
                          tadpcm.encode(rows[3], st))
    assert (st.predictor, st.index) == tuple(zero[3])


def test_adpcm_u8_codec_bit_for_bit():
    row = _rng(4).integers(0, 256, 1034, dtype=np.uint8)
    got, want = [], []
    for mod, out in ((tadpcm, got), (jadpcm, want)):
        enc = mod.encode_u8(row, mod.AdpcmState())
        out += [enc, mod.decode_u8(enc, mod.AdpcmState())]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, want))


def _native_cases():
    rng = _rng(5)
    raw24 = rng.integers(0, 256, 3 * 1000, dtype=np.uint8)
    s16 = rng.integers(-32768, 32768, 1000).astype(np.int16)
    f32 = (rng.standard_normal(1000) * 0.6).astype(np.float32)
    f32[:3] = (1.5, -1.5, np.float32(1.0))

    def ring(m):
        r = m.NativeRing(16, nblocks=4)
        log = []
        for k in range(6):              # two more than the ring holds
            log.append(r.push(np.full(16, k, np.float32)))
        log += [r.fill, r.overruns]
        while True:
            x = r.pop()
            if x is None:
                break
            log.append(x.tobytes())
        return log + [r.fill, r.pop()]

    def seq(m):
        c = m.SeqCheck()
        return [c.check(s) for s in (0, 1, 2, 5, 6, 6, 100, 101)] \
            + [c.total_gaps]

    return {
        "s24_to_f32": lambda m: m.s24_to_f32(raw24, 2.0 ** -23).tobytes(),
        "s24_to_f32_bytes_swap": lambda m: m.s24_to_f32(
            raw24.tobytes(), 2.0 ** -23, True).tobytes(),
        "s16_to_f32": lambda m: m.s16_to_f32(s16, 1 / 32768.0).tobytes(),
        "s16_to_f32_swap": lambda m: m.s16_to_f32(s16, 1 / 32768.0,
                                                  True).tobytes(),
        "f32_to_s16be": lambda m: m.f32_to_s16be(f32),
        "ring": ring,
        "seq_check": seq,
    }


@pytest.mark.parametrize("name", sorted(_native_cases()))
def test_native_bit_for_bit(name):
    case = _native_cases()[name]
    assert case(tnative) == case(jnative)


def test_native_unknown_name_raises():
    with pytest.raises(AttributeError):
        tnative.no_such_thing


# -- server.netproto, server.update -----------------------------------------

def _netproto_cases():
    server = types.SimpleNamespace(
        cfg=None, port=8073, conns={}, freq_offset_khz=0.0,
        engine=types.SimpleNamespace(params=types.SimpleNamespace(
            num_channels=4)), ui_srate=30e6, start_time=0.0,
        snr_history=[dict(snr=17.0)], gps=None)
    desc = ("<root><URLBase>http://10.0.0.1:5000</URLBase><service>"
            "<serviceType>urn:schemas-upnp-org:service:WANIPConnection:1"
            "</serviceType><controlURL>/ctl/IPConn</controlURL></service>"
            "</root>")
    return {
        "constants": _public_constants,
        "natpmp_external": lambda m: m.natpmp_external_addr_request(),
        "natpmp_map": lambda m: [m.natpmp_map_request(8073, 8073, 3600),
                                 m.natpmp_map_request(1, 65535, 0)],
        "natpmp_parse": lambda m: [
            m.natpmp_parse_response(bytes([0, 128, 0, 0, 0, 0, 0, 9,
                                           1, 2, 3, 4])),
            m.natpmp_parse_response(bytes([0, 130, 0, 0, 0, 0, 0, 9, 31,
                                           137, 31, 137, 0, 0, 14, 16])),
            m.natpmp_parse_response(b"\x00\x80\x00\x03\x00\x00\x00\x00")],
        "ssdp": lambda m: [m.ssdp_msearch_request(),
                           m.ssdp_parse_response(
                               b"HTTP/1.1 200 OK\r\nLOCATION: http://10.0.0.1"
                               b":5000/d.xml\r\nST: x\r\n\r\n")],
        "upnp": lambda m: [m.upnp_control_url(desc, "http://10.0.0.1:5000/"),
                           m.upnp_add_port_mapping_soap(8073, 8073,
                                                        "10.0.0.9"),
                           m.upnp_parse_soap_response(200, b"<ok/>"),
                           m.upnp_parse_soap_response(
                               500, b"<errorCode>718</errorCode>")],
        "ip_api": lambda m: [m.parse_ip_api(
            json.dumps({"ip": "1.2.3.4", "lat": 1.5, "lon": 2.5}).encode(),
            "ip", "lat", "lon"),
            m.parse_ip_api(b"not json", "ip", None, None)],
        "urls": lambda m: [m.registry_url("http://r.example/api", server),
                           m.ddns_update_url("http://d.example/u",
                                             "me.example", "1.2.3.4")],
    }


@pytest.mark.parametrize("name", sorted(_netproto_cases()))
def test_netproto_bit_for_bit(name):
    case = _netproto_cases()[name]
    try:
        want = case(jnetproto)
    except Exception as e:              # the copy must fail the same way
        with pytest.raises(type(e)):
            case(tnetproto)
        return
    assert case(tnetproto) == want


def test_update_version_parsing_equal():
    texts = ('__version__ = "1.23"', "VERSION_MAJ = 1\nVERSION_MIN = 702",
             "nothing here", '__version__ = "0.1.0"')
    assert [tupdate.parse_version(t) for t in texts] == \
        [jupdate.parse_version(t) for t in texts]
    assert _public_constants(tupdate) == _public_constants(jupdate)
    calls = []

    def runner(cmd):                    # nothing leaves this process
        calls.append(cmd)
        if "grep -q 100%" in cmd:
            return 1, ""                # the disk is not full
        return (1, "offline") if "git show" in cmd else (0, "ok")
    st = [m.UpdateManager(runner=runner, repo_dir="/srv/checkout").check()
          for m in (tupdate, jupdate)]
    assert tupdate.UpdateManager().repo_dir == str(
        __import__("pathlib").Path(__file__).resolve().parents[1])
    assert st[0] == st[1]
    # each asks for its own package's version file
    shows = [c for c in calls if "git show" in c]
    assert len(shows) == 2 and "flydog_sdr_gps_tpu_torch/" in shows[0]
    assert shows[0].replace("_torch/", "/") == shows[1]


# -- utils --------------------------------------------------------------------

def test_security_bit_for_bit(monkeypatch):
    import secrets
    for mod in (tsecurity, jsecurity):
        monkeypatch.setattr(mod.secrets, "token_hex",
                            lambda n: "ab" * n, raising=True)
        monkeypatch.setattr(mod.secrets, "token_bytes",
                            lambda n: b"\x07" * n, raising=True)
    assert secrets.token_hex(2) == "abab"
    got = [(m.generate_authkey(), m.hash_password("hunter2", iters=1000),
            m.make_token("k" * 64, t=1000.0)) for m in (tsecurity, jsecurity)]
    assert got[0] == got[1]
    key, stored, token = got[0]
    for m in (tsecurity, jsecurity):
        assert m.is_hashed(stored) and not m.is_hashed("plain")
        assert m.verify_password("hunter2", stored)
        assert not m.verify_password("hunter3", stored)
        assert m.verify_password("plain", "plain")
        assert m.check_token("k" * 64, token, now=1010.0)
        assert not m.check_token("k" * 64, token, now=2000.0)
        assert not m.check_token("j" * 64, token, now=1010.0)
    # each verifies what the other hashed
    assert tsecurity.verify_password("pw", jsecurity.hash_password("pw", 500))


def test_cfg_bit_for_bit(tmp_path):
    docs = []
    for mod, name in ((tcfg, "t.json"), (jcfg, "j.json")):
        path = tmp_path / name
        path.write_text(json.dumps({"rx_name": "x", "nested": {"a": 1},
                                    "user_password": "pw"}))
        c = mod.Config(str(path))
        c.set("nested.b", "2.5")
        c.set("keepalive_sec", 30)
        c.set("flag", "true")
        reads = (c.string("rx_name"), c.string("missing", "d"),
                 c.int("keepalive_sec"), c.int("nested.b", 7),
                 c.float("nested.b"), c.bool("flag"), c.bool("missing", True),
                 c.get("nested"), c.seq)
        c.save()
        docs.append((reads, json.loads(path.read_text()), c.doc))
    assert docs[0] == docs[1]
    assert tcfg.Config().doc == jcfg.Config().doc


def _labels(mod):
    rng = _rng(11)
    db = mod.DxDatabase()
    for k in range(60):
        db.upsert(mod.DxLabel(float(np.round(rng.uniform(100, 29000), 1)),
                              ("am", "usb", "cw")[k % 3], f"stn{k % 17}",
                              f"note {k}", low_cut=-k, high_cut=k, offset=k))
    return db


def test_dx_lookups_bit_for_bit(tmp_path):
    out = []
    for mod, name in ((tdx, "t.json"), (jdx, "j.json")):
        db = _labels(mod)
        db.update_gid(3, mod.DxLabel(5000.0, "am", "new", "n"))
        db.update_gid(-1, mod.DxLabel(6000.0, "usb", "added", ""))
        removed = (db.delete_gid(0), db.delete_gid(10 ** 6),
                   db.delete(6000.0, "added"), db.delete(1.0))
        rows = [lab.to_json() for lab in db.labels]
        spans = [[(g, lab.to_json()) for g, lab in db.in_range_gid(lo, hi)]
                 for lo, hi in ((0, 30000), (5000, 9000), (9000, 5000))]
        plain = [lab.to_json() for lab in db.in_range(7000, 15000)]
        filt = [[mod.filter_match(lab, *f) for lab in db.labels]
                for f in (("stn1", "", False, False, False),
                          ("STN1", "", True, False, False),
                          ("stn?", "note 1*", False, True, False),
                          ("", "^note [0-9]$", False, False, True))]
        db.path = str(tmp_path / name)
        db.save()
        again = mod.DxDatabase(db.path)
        out.append((removed, rows, spans, plain, filt, db.seq,
                    json.loads(open(db.path).read()),
                    [lab.to_json() for lab in again.labels],
                    mod.DxLabel.from_json(rows[0]).to_json()))
    assert out[0] == out[1]
    assert len(out[0][1]) >= 55


def test_eibi_bit_for_bit(tmp_path):
    with open(teibi.DATA_JSON, "rb") as a, open(jeibi.DATA_JSON, "rb") as b:
        assert a.read() == b.read()
    assert "flydog_sdr_gps_tpu_torch" in teibi.DATA_JSON
    csv = tmp_path / "sked.csv"
    csv.write_text(
        "kHz;Time(UTC);Days;ITU;Station;Lng;Target;Remarks;P;Start;Stop\n"
        "5000;0000-2400;;USA;WWV;E;NAm;time;;;\n"
        "6070;0600-2200;;D;Channel 292;G;Eu;;;;\n"
        "8992;0000-2400;;USA;USAF HFGCS;E;;usb;;;\n"
        "518;0000-2400;;G;NAVTEX;-TS;;;;;\n"
        "bad row\n")
    got = []
    for mod, dxm in ((teibi, tdx), (jeibi, jdx)):
        db = dxm.DxDatabase()
        n = mod.load_builtin(db)
        look = [[lab.to_json() for lab in db.in_range(lo, hi)][:40]
                for lo, hi in ((5990, 6010), (9400, 9420), (14000, 14350))]
        cls = [mod.classify(f, s, lang) for f, s, lang in (
            (6070.0, "Channel 292", "G"), (5000.0, "WWV", "E"),
            (8992.0, "USAF HFGCS", "E"), (518.0, "NAVTEX", "-TS"),
            (14100.0, "Beacon", "-CW"))]
        parsed = [lab.to_json() for lab in mod.parse_csv(str(csv))]
        got.append((n, look, cls, parsed, mod._band_of(9500.0)))
    assert got[0] == got[1]
    assert got[0][0] > 1000


def test_log_and_trace_equal():
    out = []
    for lg, tr in ((tlog, ttrace), (jlog, jtrace)):
        ring = lg.LogRing(depth=4, mirror=None)
        for k in range(6):
            ring.write(f"line {k}", prefix="p ")
        t = tr.EventTrace(depth=8)
        for k in range(10):
            t.ev("SND", "start" if k % 2 == 0 else "end", str(k))
        off = tr.EventTrace(enabled=False)
        off.ev("SND", "x")
        out.append(([s.split(" ", 1)[1] for s in ring.tail(10)],
                    len(t.dump()), len(t.spans("SND", "start", "end")),
                    off.dump(), lg.N_LOG_SAVE,
                    (tr.EV_SND, tr.EV_WF, tr.EV_WS)))
    assert out[0] == out[1]


# -- extensions ---------------------------------------------------------------

def test_extension_registry_lists_what_is_ported():
    assert text.ext_list() == jext.ext_list()
    assert len(text.ext_list()) == 29


@pytest.mark.parametrize("name", ["S_meter", "IQ_display"])
def test_extensions_bit_for_bit(name):
    rng = _rng(3)
    audio = rng.standard_normal((2, 128)).astype(np.float32)
    iq = rng.standard_normal((2, 2, 128)).astype(np.float32)
    smeter = np.array([-80.5, -63.25, -120.0, -99.0], np.float32)
    from flydog_sdr_gps_tpu.server import kiwi_server as jks
    from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks
    out = []
    for mod, ks in ((text, tks), (jext, jks)):
        taps = ks.HostTaps(audio, audio[::-1], iq[0], iq[1], smeter,
                           {1: 0, 3: 1})
        ext = mod.ext_create(name, None, 3)
        ext.start(first_time="1")
        msgs = [ext.process_block(taps) for _ in range(3)]
        msgs.append(ext.command({"_cmd": "x"}))
        ext.stop()
        out.append(msgs)
    assert out[0] == out[1]
    assert any(out[0])


# -- the GPS subsystem's host modules ----------------------------------------

from flydog_sdr_gps_tpu.models.gps import cacode as jcacode  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import clock as jclock  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import e1b_codes as je1b  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import ephemeris as jeph  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import galileo as jgal  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import solver as jsolver  # noqa: E402
from flydog_sdr_gps_tpu.models.gps import tracking as jtracking  # noqa: E402
from flydog_sdr_gps_tpu.runtime import gps_service as jgps  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import cacode as tcacode  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import clock as tclock  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import e1b_codes as te1b  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import ephemeris as teph  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import galileo as tgal  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import solver as tsolver  # noqa: E402
from flydog_sdr_gps_tpu_torch.models.gps import (  # noqa: E402
    tracking as ttracking)
from flydog_sdr_gps_tpu_torch.runtime import gps_service as tgps  # noqa: E402


def _eph(mod, prn=12):
    e = mod.Ephemeris(prn=prn)
    e.week = 245
    e.toc = 302400.0; e.af0 = 4.2e-5; e.af1 = 1.1e-11; e.af2 = 0.0
    e.iode = 77
    e.crs = 23.5; e.delta_n = 4.5e-9; e.m0 = 1.2345
    e.cuc = 2.4e-6; e.e = 0.0123; e.cus = 7.9e-6
    e.sqrt_a = np.sqrt(26560e3); e.toe = 302400.0
    e.cic = 5.5e-8; e.omega0 = -2.01; e.cis = -6.1e-8
    e.i0 = 0.958; e.crc = 201.8; e.omega = 0.77
    e.omega_dot = -8.1e-9; e.idot = 3.1e-10
    return e


def test_gps_constants_equal():
    def public(mod):        # the caches (_E1B_CODES, ...) are state
        return {k: v for k, v in _public_constants(mod).items()
                if not k.startswith("_")}
    for t, j in ((tcacode, jcacode), (teph, jeph), (tsolver, jsolver),
                 (tgal, jgal)):
        assert public(t) == public(j), t.__name__
    assert tcacode.G2_DELAYS == jcacode.G2_DELAYS
    np.testing.assert_array_equal(tgal.INAV_SYNC, jgal.INAV_SYNC)


@pytest.mark.parametrize("group", ["navstar", "qzss_sbas"])
def test_ca_codes_bit_for_bit(group):
    prns = (range(1, 33) if group == "navstar"
            else jcacode.QZSS_PRNS + jcacode.SBAS_PRNS)
    for prn in prns:
        np.testing.assert_array_equal(tcacode.ca_code_any(prn),
                                      jcacode.ca_code_any(prn))
        np.testing.assert_array_equal(
            tcacode.ca_code_sampled(prn, 4.092e6, 16384),
            jcacode.ca_code_sampled(prn, 4.092e6, 16384))


def test_e1b_tables_bit_for_bit(tmp_path):
    for prn in range(1, 51):
        np.testing.assert_array_equal(te1b.e1b_chips(prn),
                                      je1b.e1b_chips(prn))
        np.testing.assert_array_equal(tgal.e1b_code(prn), jgal.e1b_code(prn))
    path = tmp_path / "e1b.txt"
    path.write_text("".join(f"{p} {je1b._HEX[p - 1]}\n" for p in (1, 7)))
    got, ref = tcacode.load_e1b_codes(str(path)), \
        jcacode.load_e1b_codes(str(path))
    assert sorted(got) == sorted(ref)
    for p in ref:
        np.testing.assert_array_equal(got[p], ref[p])
    from flydog_sdr_gps_tpu.models.gps import acquisition as jacq
    from flydog_sdr_gps_tpu_torch.models.gps import acquisition as tacq
    np.testing.assert_array_equal(
        tgal.e1b_code_fft(tacq.AcqParams(), tgal.e1b_code(5)),
        jgal.e1b_code_fft(jacq.AcqParams(), jgal.e1b_code(5)))


def test_ephemeris_codec_and_parity_bit_for_bit():
    rng = _rng(3)
    d29 = d30 = 0
    for _ in range(50):
        data = int(rng.integers(0, 1 << 24))
        w = teph.parity_encode(data, d29, d30)
        assert w == jeph.parity_encode(data, d29, d30)
        bad = w ^ (1 << int(rng.integers(0, 30)))
        for word in (w, bad):
            assert teph.parity_check(word, d29, d30) == \
                jeph.parity_check(word, d29, d30)
        d29, d30 = (w >> 1) & 1, w & 1
    te, je = _eph(teph), _eph(jeph)
    for sub in (1, 2, 3, 4, 5):
        words = teph.encode_subframe(sub, te, tow_next=302406.0)
        assert words == jeph.encode_subframe(sub, je, tow_next=302406.0)
        dt, dj = teph.Ephemeris(prn=12), jeph.Ephemeris(prn=12)
        assert teph.decode_subframe(words, dt) == \
            jeph.decode_subframe(words, dj)
        assert vars(dt) == vars(dj)
    for t in (302400.0, 302500.5, 304000.0):
        pt, ct = te.sat_pos(t)
        pj, cj = je.sat_pos(t)
        np.testing.assert_array_equal(pt, pj)
        assert ct == cj


def test_subframe_assembler_bit_for_bit():
    e = _eph(jeph)
    bits = []
    d29 = d30 = 0
    for sub in (1, 2, 3):
        for w24 in jeph.encode_subframe(sub, e):
            word = jeph.parity_encode(w24, d29, d30)
            bits += [(word >> i) & 1 for i in range(29, -1, -1)]
            d29, d30 = (word >> 1) & 1, word & 1
    stream = [1 - 2 * b for b in [0] * 9 + bits + [0, 0]]
    at, aj = teph.SubframeAssembler(prn=12), jeph.SubframeAssembler(prn=12)
    for i in range(0, len(stream), 41):
        assert at.feed(stream[i:i + 41]) == aj.feed(stream[i:i + 41])
    assert at.events == aj.events and at.subframes == aj.subframes == 3
    assert vars(at.eph) == vars(aj.eph) and at.eph.complete()


def test_solvers_bit_for_bit():
    rng = _rng(5)
    truth = np.array([1113194.0, -4842330.0, 3985000.0])
    sats = []
    while len(sats) < 8:
        v = rng.standard_normal(3)
        v = v / np.linalg.norm(v) * 26560e3
        if np.dot(v - truth, truth) > 0:
            sats.append(v)
    sat_pos = np.asarray(sats)
    pr = np.linalg.norm(sat_pos - truth, axis=1) + 8521.77
    pr = pr + rng.standard_normal(len(pr)) * 3.0
    got, ref = tsolver.solve_ls(sat_pos, pr), jsolver.solve_ls(sat_pos, pr)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    ekf_t, ekf_j = tsolver.EkfSolver(), jsolver.EkfSolver()
    for k in range(5):
        np.testing.assert_array_equal(
            ekf_t.update(sat_pos, pr + k, dt=2.0),
            ekf_j.update(sat_pos, pr + k, dt=2.0))
    assert tsolver.lla_from_ecef(truth) == jsolver.lla_from_ecef(truth)
    assert tsolver.az_el(truth, sat_pos[0]) == jsolver.az_el(truth,
                                                            sat_pos[0])


def test_clock_discipline_bit_for_bit():
    rng = _rng(7)
    ct, cj = tclock.ClockDiscipline(), jclock.ClockDiscipline()
    t, ticks = 0.0, 0
    for _ in range(40):
        dt = 2.0 + rng.standard_normal() * 1e-3
        t += dt
        ticks = (ticks + int(round(dt * 124.9824e6))) % (1 << 48)
        assert ct.update(t, ticks) == cj.update(t, ticks)
        assert ct.locked == cj.locked
    assert ct.correction_ppm == cj.correction_ppm


def test_viterbi_crc_and_inav_bit_for_bit():
    rng = _rng(9)
    bits = rng.integers(0, 2, 114).astype(np.uint8)
    coded = tgal.conv_encode_k7(np.concatenate([bits, np.zeros(6,
                                                               np.uint8)]))
    np.testing.assert_array_equal(
        coded, jgal.conv_encode_k7(np.concatenate([bits, np.zeros(
            6, np.uint8)])))
    soft = (1.0 - 2.0 * coded) + 0.6 * rng.standard_normal(len(coded))
    np.testing.assert_array_equal(tgal.viterbi_decode_k7(soft),
                                  jgal.viterbi_decode_k7(soft))
    sym = rng.standard_normal(240)
    np.testing.assert_array_equal(tgal.inav_deinterleave(sym),
                                  jgal.inav_deinterleave(sym))
    np.testing.assert_array_equal(tgal.inav_interleave(sym),
                                  jgal.inav_interleave(sym))
    assert tgal.crc24q(bits) == jgal.crc24q(bits)
    te, je = _eph(teph, 5), _eph(jeph, 5)
    syms_t, syms_j = [], []
    for wt in (1, 2, 3, 4, 5, 0):
        wt_t = tgal.encode_word(wt, te, wn=245, tow=302400.0 + 2 * wt)
        wt_j = jgal.encode_word(wt, je, wn=245, tow=302400.0 + 2 * wt)
        np.testing.assert_array_equal(wt_t, wt_j)
        dt, dj = teph.Ephemeris(prn=5), jeph.Ephemeris(prn=5)
        assert tgal.decode_word(wt_t, dt) == jgal.decode_word(wt_j, dj)
        assert vars(dt) == vars(dj)
        syms_t.extend(1.0 - 2.0 * tgal.encode_nominal_page(wt_t))
        syms_j.extend(1.0 - 2.0 * jgal.encode_nominal_page(wt_j))
    np.testing.assert_array_equal(syms_t, syms_j)
    noisy = np.asarray(syms_t) + 0.5 * rng.standard_normal(len(syms_t))
    at, aj = tgal.InavAssembler(prn=5), jgal.InavAssembler(prn=5)
    for i in range(0, len(noisy), 173):
        assert at.feed(noisy[i:i + 173]) == aj.feed(noisy[i:i + 173])
    assert at.events == aj.events and at.subframes == aj.subframes >= 5
    assert vars(at.eph) == vars(aj.eph)


@pytest.mark.parametrize("kind", ["ties", "zeros", "short", "no_tail"])
def test_viterbi_steps_every_state_at_once_bit_for_bit(kind):
    """The port's decoder steps all 64 states at once; the reference's
    visits them one by one.  Equal metrics (integer soft values, zeros)
    keep the same survivor, and an untailed or short block traces back
    the same way."""
    rng = _rng(17)
    for n in (1, 6, 7, 120, 125):
        soft = {"ties": rng.integers(-2, 3, 2 * n).astype(np.float64),
                "zeros": np.zeros(2 * n),
                "short": rng.standard_normal(2 * n),
                "no_tail": rng.standard_normal(2 * n)}[kind]
        tail = kind != "no_tail"
        np.testing.assert_array_equal(tgal.viterbi_decode_k7(soft, tail),
                                      jgal.viterbi_decode_k7(soft, tail))


@pytest.mark.parametrize("seed", [0, 1])
def test_bit_sync_bit_for_bit(seed):
    rng = _rng(seed)
    bits = np.repeat(rng.choice([-1.0, 1.0], 120), 20)[13:]
    ip = bits * 500.0 + 200.0 * rng.standard_normal(len(bits))
    off_t, b_t = ttracking.bit_sync(ip)
    off_j, b_j = jtracking.bit_sync(ip)
    assert off_t == off_j and np.array_equal(b_t, b_j)
    for settle in (300, 600):
        assert ttracking.bit_sync_confident(ip, settle) == \
            jtracking.bit_sync_confident(ip, settle)
    assert ttracking.bit_sync(np.ones(45))[0] == jtracking.bit_sync(
        np.ones(45))[0]


class _Mgr:
    """What ``GpsReceiver._apply_clock`` asks of a manager."""

    def __init__(self, clock_mod, clk):
        self.clock = clock_mod.ClockDiscipline(nominal_hz=16.368e6)
        self.clock._count = 4
        self.adc_clock_nom = 125e6
        self._clk = clk
        self.tp = types.SimpleNamespace(fs=16.368e6)

    def adc_clock(self):
        return self._clk


class _Eng:
    def __init__(self):
        self.retuned = []
        self.params = types.SimpleNamespace(num_channels=4)

    def retune_all(self, clk):
        self.retuned.append(clk)


def test_gps_receiver_clock_gate_bit_for_bit():
    """The stability gate: wandering estimates do not retune, settled
    ones do, changes under ``min_clock_change_ppm`` do not."""
    seq = [125e6 * (1 + d * 1e-6) for d in
           (0.40, 0.41, 0.30, 0.42, 0.40, 0.401, 0.402, 0.4005, 0.4003,
            0.4004, 0.55, 0.40)]
    log = {}
    for name, gmod, cmod in (("t", tgps, tclock), ("j", jgps, jclock)):
        eng = _Eng()
        rec = gmod.GpsReceiver(None, _Mgr(cmod, 0.0), engine=eng)
        out = []
        for clk in seq:
            rec.mgr._clk = clk
            rec._apply_clock()
            out.append((rec.retunes, rec.adc_clock_corrected))
        log[name] = (out, eng.retuned)
    assert log["t"] == log["j"]
    assert 0 < log["t"][0][-1][0] < len(seq)


# -- the decoders' host code ---------------------------------------------------

import jax.numpy as jnp  # noqa: E402

from chip_smoke import fsk_audio  # noqa: E402
from flydog_sdr_gps_tpu.extensions import cw_decoder as jcw  # noqa: E402
from flydog_sdr_gps_tpu.extensions import ft4 as jft4  # noqa: E402
from flydog_sdr_gps_tpu.extensions import ft8 as jft8  # noqa: E402
from flydog_sdr_gps_tpu.extensions import ft8_decode as jfd  # noqa: E402
from flydog_sdr_gps_tpu.extensions import ft8_ldpc_tables as jldpc  # noqa: E402
from flydog_sdr_gps_tpu.extensions import spot_upload as jsu  # noqa: E402
from flydog_sdr_gps_tpu.extensions import wspr as jwspr  # noqa: E402
from flydog_sdr_gps_tpu.extensions import wspr_decode as jwd  # noqa: E402
from flydog_sdr_gps_tpu.server import autorun as jautorun  # noqa: E402
from flydog_sdr_gps_tpu_torch.extensions import cw_decoder as tcw  # noqa: E402
from flydog_sdr_gps_tpu_torch.extensions import ft4 as tft4  # noqa: E402
from flydog_sdr_gps_tpu_torch.extensions import ft8 as tft8  # noqa: E402
from flydog_sdr_gps_tpu_torch.extensions import (  # noqa: E402
    ft8_decode as tfd, ft8_ldpc_tables as tldpc, spot_upload as tsu,
    wspr as twspr, wspr_decode as twd)
from flydog_sdr_gps_tpu_torch.server import autorun as tautorun  # noqa: E402

DECODER_PAIRS = {"cw_decoder": (jcw, tcw), "ft4": (jft4, tft4),
                 "ft8": (jft8, tft8), "ft8_decode": (jfd, tfd),
                 "ft8_ldpc_tables": (jldpc, tldpc),
                 "spot_upload": (jsu, tsu), "wspr": (jwspr, twspr),
                 "wspr_decode": (jwd, twd)}


@pytest.mark.parametrize("name", sorted(DECODER_PAIRS))
def test_decoder_constants_equal(name):
    jm, tm = DECODER_PAIRS[name]
    assert _public_constants(tm) == _public_constants(jm)
    arrays = {k for k, v in vars(jm).items()
              if k.isupper() and isinstance(v, np.ndarray)}
    assert arrays <= {k for k, v in vars(tm).items()
                      if k.isupper() and isinstance(v, np.ndarray)}
    for k in arrays:
        a, b = getattr(jm, k), getattr(tm, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    if name == "wspr":      # the port names its front end's taps
        from flydog_sdr_gps_tpu.ops import filters as jfilters
        assert np.array_equal(tm.FRONTEND_TAPS, jfilters.kaiser_lowpass(
            jm.FS_AUDIO, 150.0, 210.0, 60.0, numtaps=jm.DECIM * 8))


def _same(a, b):
    """``==`` through dicts, lists, tuples, numpy arrays and dataclasses
    (each package's dataclass compared field by field)."""
    import dataclasses
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__
                and _same(dataclasses.astuple(a), dataclasses.astuple(b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.fixture(scope="module")
def wspr_arrays():
    """The reference front end's power and baseband for K1ABC FN42 37
    at ``test_wspr_decode.py``'s SNR (0.25 signal, 0.25 noise)."""
    tones = jwd.encode_to_tones(jwd.WsprMessage("K1ABC", "FN42", 37))
    n = int(jwspr.CAPTURE_S * 12000)
    f0 = jwspr.DIAL_OFFSET - 33 * jwspr.TONE_SPACING
    sig = fsk_audio(tones, f0, jwspr.TONE_SPACING, jwspr.SPS * jwspr.DECIM, n)
    sig = (0.25 * sig + 0.25 * _rng(2).standard_normal(n)).astype(np.float32)
    power, bre, bim = jwspr._make_frontend()(jnp.asarray(sig))
    power = np.asarray(power)
    return power, np.asarray(bre) + 1j * np.asarray(bim)


def test_wspr_host_bit_for_bit(wspr_arrays):
    power, z375 = wspr_arrays
    out = []
    for w, wd in ((twspr, twd), (jwspr, jwd)):
        cands = w.sync_correlate(power, max_dt_sym=power.shape[0] - w.NSYM)
        soft = [w.soft_symbols(power, c) for c in cands[:5]]
        tp = [w.tone_powers(z375, (c["bin"] - w.SPS // 2) * w.TONE_SPACING,
                            c["dt"] * w.SPS, drift)
              for c, drift in zip(cands[:3], (0.0, 1.5, -2.0))]
        refined = [w.refine_candidate(z375, c, search_drift=i == 0)
                   for i, c in enumerate(cands[:2])]
        msgs = [wd.decode_soft_symbols(r["soft"]) for r in refined]
        out.append((cands, soft, tp, refined, msgs))
    assert _same(out[0], out[1])
    assert out[0][4][0] == twd.WsprMessage("K1ABC", "FN42", 37)


def test_wspr_decode_bit_for_bit():
    out = []
    for wd in (twd, jwd):
        rng = _rng(11)
        msgs = [wd.WsprMessage(c, g, d) for c, g, d in
                (("K1ABC", "FN42", 37), ("VK2DEF", "QF56", 0),
                 ("G4AAA", "IO91", 23))]
        bits = [wd.pack_message(m) for m in msgs]
        tones = [wd.encode_to_tones(m) for m in msgs]
        coded = wd.conv_encode(np.concatenate([bits[0],
                                               np.zeros(31, np.uint8)]))
        soft = (2.0 * coded - 1) * 2.0 + np.random.default_rng(1) \
            .standard_normal(162)
        noisy = rng.standard_normal(162) * 3.0
        out.append((bits, tones, coded, wd.interleave_map(),
                    wd.stack_decode(soft), [wd.unpack_message(b)
                                            for b in bits],
                    wd.deinterleave_soft(noisy), wd.decode_soft_symbols(
                        noisy.astype(np.float32)),
                    [wd.plausible(m) for m in msgs]))
    assert _same(out[0], out[1])


@pytest.fixture(scope="module")
def ft_arrays():
    """The reference's FT8 and FT4 spectrograms (and the FT4 audio) of
    CQ K1ABC FN42 at ``test_ft8_decode.py``'s / ``test_ft4.py``'s SNRs."""
    payload = jfd.pack_payload(jfd.Ft8Message("CQ", "K1ABC", "FN42"))
    t8 = jfd.codeword_to_tones(jfd.ldpc_encode(jfd.add_crc(payload)))
    n8 = int(jft8.Ft8Ext.CAPTURE_S * 12000)
    a8 = (0.3 * fsk_audio(t8, 1200.0, jft8.BAUD, jft8.SPS, n8)
          + 0.2 * _rng(3).standard_normal(n8)).astype(np.float32)
    t4 = jft4.encode_tones(payload)
    n4 = int(jft4.Ft4Ext.CAPTURE_S * 12000)
    a4 = (0.3 * fsk_audio(t4, 1500.0, jft4.BAUD, jft4.SPS, n4)
          + 0.2 * _rng(4).standard_normal(n4)).astype(np.float32)
    return (np.asarray(jft8._make_spectrogram()(jnp.asarray(a8))),
            np.asarray(jft4._make_spectrogram()(jnp.asarray(a4))),
            np.asarray(a4, np.float64))


def test_ft8_host_bit_for_bit(ft_arrays):
    power = ft_arrays[0]
    out = []
    for f8, fd in ((tft8, tfd), (jft8, jfd)):
        rng = _rng(12)
        cands = f8.costas_sync(power)
        logls = [f8.tone_logls(power, c) for c in cands[:5]]
        llrs = [fd.tone_powers_to_llrs(p) for p in logls]
        msg91 = fd.add_crc(np.random.default_rng(2).integers(
            0, 2, 77).astype(np.uint8))
        cw = fd.ldpc_encode(msg91)
        noisy = (2.0 * cw - 1.0) * 2.0 + rng.standard_normal(174) * 0.9
        bad = cw.copy()
        bad[100] ^= 1
        calls = [fd.Ft8Message(*m) for m in (
            ("CQ", "K1ABC", "FN42"), ("W9XYZ", "K1ABC", "R-15"),
            ("K1ABC", "W9XYZ", "RR73"), ("QRZ", "G4AAA", "73"))]
        packed = [fd.pack_payload(m) for m in calls]
        out.append((cands, logls, llrs, [fd.decode_llrs(x) for x in llrs],
                    cw, fd.ldpc_check(cw), fd.ldpc_check(bad),
                    fd.bp_decode(noisy), fd.crc14(msg91[:77]),
                    fd.check_crc(msg91), packed,
                    [fd.unpack_payload(b) for b in packed],
                    fd.codeword_to_tones(cw)))
    assert _same(out[0], out[1])
    assert out[0][3][0] == tfd.Ft8Message("CQ", "K1ABC", "FN42")


def test_ft4_host_bit_for_bit(ft_arrays):
    _, power, audio = ft_arrays
    out = []
    for f4 in (tft4, jft4):
        cands = f4.costas_sync(power)
        pw = [f4.matched_tone_powers(audio, c, df) for c in cands[:2]
              for df in (0.0, -5.86, 5.86)]
        llrs = [f4.tone_powers_to_llrs(p) for p in pw]
        out.append((cands, pw, llrs, [f4.decode_llrs(x) for x in llrs],
                    f4.encode_tones(np.zeros(77, np.uint8)),
                    f4.DATA_POS))
    assert _same(out[0], out[1])
    assert tfd.Ft8Message("CQ", "K1ABC", "FN42") in out[0][3]


def test_cw_decoder_bit_for_bit():
    from flydog_sdr_gps_tpu.server import kiwi_server as jks
    from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks
    from tests.test_extensions import morse_audio

    class Engine:
        class params:
            fs_out = 12000.0
    audio = morse_audio("CQ DE K1ABC 73 ?")
    out = []
    for mod, ks in ((text, tks), (jext, jks)):
        dec = mod.ext_create("CW_decoder", Engine(), 1)
        dec.start(pitch=500.0, wpm=22.0)
        msgs = []
        for i in range(0, len(audio) - 255, 256):
            row = audio[None, i:i + 256]
            taps = ks.HostTaps(row, row, row, row,
                               np.zeros(2, np.float32), {1: 0})
            msgs.append(dec.process_block(taps))
        out.append((msgs, dec.wpm, dec.thresh, dec.env, dec.symbol))
    assert out[0] == out[1]
    assert "K1ABC" in "".join(p.decode() for m in out[0][0] for _t, p in m)


def test_spot_upload_bit_for_bit():
    import time
    when = time.struct_time((2026, 8, 21, 4, 32, 0, 0, 0, 0))
    spot = dict(call="K1ABC", grid="FN42", freq_hz=14075234, snr_db=-7,
                mode="FT8", time=1787000000)
    out = []
    for su in (tsu, jsu):
        url = su.wsprnet_url("TP0U", "JN47", 7.0386, when, -17.0, 0.3, 1,
                             7.040102, "K1ABC", "FN42", "+37")
        pkts = []
        for antenna in (None, "dipole"):
            rep = su.PskReporter("TP0U", "JN47", antenna=antenna)
            rep.rand_id = 0x1234ABCD
            pkts += [rep.datagram([spot], now=1787000100 + k)
                     for k in range(4)]
        sent = []
        up = su.SpotUploader("TP0U", "JN47", http_send=sent.append,
                             udp_send=lambda pkt, addr: sent.append(
                                 (pkt, addr)))
        up.reporter.rand_id = 7
        for s in (dict(ext="WSPR", dial_khz=7038.6, t=1787000000.0,
                       text="K1ABC FN42 +37 -17dB 0.3s"),
                  dict(ext="FT8", dial_khz=14074.0, t=1787000000.0,
                       text="CQ K1ABC FN42 1230.0"),
                  dict(ext="FT4", dial_khz=14080.0, t=1787000001.0,
                       text="W9XYZ K1ABC R-07 611.5"),
                  dict(ext="FT8", dial_khz=14074.0, t=1787000002.0,
                       text="")):
            up(s)
        out.append((url, pkts, sent, up.sent))
    assert out[0] == out[1]
    assert len(out[0][2]) == 3


@pytest.mark.parametrize("name", ["test_wsprnet_url_fields",
                                  "test_pskreporter_datagram_structure",
                                  "test_spot_uploader_routing"])
def test_spot_upload_expectations_hold_on_the_port(name, monkeypatch):
    """``tests/test_spot_upload.py``'s own assertions, on the port's
    module."""
    from tests import test_spot_upload
    monkeypatch.setattr(test_spot_upload, "su", tsu)
    getattr(test_spot_upload, name)()


def test_autorun_parse_spec_bit_for_bit():
    specs = ["wspr:7038.6", "ft8:14074", "WSPR:7.0386M", "wspr:7038600",
             "ft8/ft4:14074/14080", "ft8/ft4:14074", "FT4:14080",
             "nosuch:123", "ft8/ft4:1/2/3"]
    out = []
    for mod in (tautorun, jautorun):
        got = []
        for spec in specs:
            try:
                got.append(mod.parse_spec(spec))
            except ValueError as e:
                got.append(("ValueError", str(e)))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][-2][0] == "ValueError"
