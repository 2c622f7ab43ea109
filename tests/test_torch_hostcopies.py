"""The port's own copies of the reference's host-only modules, held bit
for bit against the originals on seeded inputs.

``server.packets`` (every framing function), ``ops.adpcm`` (encode, decode,
``encode_batch``, the u8 codec; with the native library and with the
numpy versions), ``runtime.native`` (the sample converters, the sequence
check, the block ring), ``server.netproto`` bodies, ``utils.security``,
``utils.cfg``, ``utils.dx`` / ``utils.eibi`` lookups, ``utils.log`` /
``utils.trace``, ``server.update`` version parsing and the two host-only
extensions.  Nothing here has a tolerance: every comparison is ``==``.
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
    assert text.ext_list() == ["IQ_display", "S_meter"]
    assert set(text.ext_list()) <= set(jext.ext_list())


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
