"""Binary wire formats of the KiwiSDR protocol.

Byte-compatible with the reference structs:
- SND real: `rx/rx_sound.h:42-53` — "SND" + flags u8 + seq u32LE +
  smeter u16BE + payload (s16 BE audio, or IMA-ADPCM when compressed).
- SND IQ:   `rx/rx_sound.h:55-70` — adds last_gps_solution u8, dummy,
  gpssec u32LE, gpsnsec u32LE before the payload.
- W/F:      `rx/rx_waterfall.h:73-88` — "W/F " + x_bin u32LE +
  (flags<<16 | zoom) u32LE + seq u32LE + 1024 dB bytes (ADPCM adds a
  10-byte pad).
- MSG:      text after "MSG " — space-separated key=value pairs.

Flag bits match `web/openwebrx/audio.js:37-47`.
"""

from __future__ import annotations

import struct

import numpy as np

SND_FLAG_LPF = 0x0001
SND_FLAG_ADC_OVFL = 0x0002
SND_FLAG_NEW_FREQ = 0x0004
SND_FLAG_MODE_IQ = 0x0008
SND_FLAG_COMPRESSED = 0x0010
SND_FLAG_RESTART = 0x0020
SND_FLAG_SQUELCH_UI = 0x0040
SND_FLAG_LITTLE_ENDIAN = 0x0080

WF_FLAGS_COMPRESSION = 0x00010000
WF_FLAGS_NO_SYNC = 0x00020000
ADPCM_PAD = 10

SMETER_BIAS = 127.0


def smeter_u16(dbm: float) -> int:
    """(dBm+127)*10 clamped, `rx/rx_sound.cpp:1220-1226`."""
    dbm = min(max(dbm, -127.0), 3.4)
    return int((dbm + SMETER_BIAS) * 10)


def snd_packet(flags: int, seq: int, smeter_dbm: float,
               payload: bytes) -> bytes:
    hdr = b"SND" + struct.pack("<BI", flags & 0xFF, seq & 0xFFFFFFFF) \
        + struct.pack(">H", smeter_u16(smeter_dbm))
    return hdr + payload


def snd_packet_iq(flags: int, seq: int, smeter_dbm: float,
                  last_gps_solution: int, gpssec: int, gpsnsec: int,
                  payload: bytes) -> bytes:
    hdr = b"SND" + struct.pack("<BI", (flags | SND_FLAG_MODE_IQ) & 0xFF,
                               seq & 0xFFFFFFFF) \
        + struct.pack(">H", smeter_u16(smeter_dbm)) \
        + struct.pack("<BBII", last_gps_solution & 0xFF, 0,
                      gpssec & 0xFFFFFFFF, gpsnsec & 0xFFFFFFFF)
    return hdr + payload


def audio_payload_s16(audio_f32: np.ndarray, little_endian: bool = False
                      ) -> bytes:
    """Float [-1,1] -> s16, big-endian by default (`rx_sound.cpp:1205`)."""
    s = np.clip(np.asarray(audio_f32) * 32767.0, -32768, 32767)
    dt = "<i2" if little_endian else ">i2"
    return s.astype(dt).tobytes()


def iq_payload_s16(iq_re: np.ndarray, iq_im: np.ndarray,
                   little_endian: bool = False) -> bytes:
    inter = np.empty(len(iq_re) * 2, np.float32)
    inter[0::2] = iq_re
    inter[1::2] = iq_im
    return audio_payload_s16(inter, little_endian)


def wf_packet(x_bin: int, zoom: int, seq: int, row_u8: bytes,
              compressed: bool = False) -> bytes:
    """``row_u8``: the 1024 dB bytes, or — when compressed — the ADPCM
    nibbles of (10-byte pad + row), (10+1024)/2 bytes
    (`rx_waterfall.cpp:1625-1628`)."""
    flags = WF_FLAGS_COMPRESSION if compressed else 0
    hdr = b"W/F " + struct.pack("<III", x_bin & 0xFFFFFFFF,
                                (flags | (zoom & 0xFFFF)) & 0xFFFFFFFF,
                                seq & 0xFFFFFFFF)
    return hdr + row_u8


def msg(**kv) -> bytes:
    """Server->client "MSG key=value ..." frame."""
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    return b"MSG " + body.encode()


def parse_set(text: str) -> dict:
    """Parse a client "SET k=v k2=v2 ..." command into a dict.

    Mirrors the tolerant parsing of `rx/rx_cmd.cpp` (values may contain
    '=' only in known keys; flags without '=' map to True).
    """
    if text.startswith("SET "):
        text = text[4:]
    out: dict = {"_cmd": None}
    for i, tok in enumerate(text.split()):
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
        else:
            out[tok] = True
        if i == 0:
            out["_cmd"] = tok.split("=", 1)[0]
    return out
