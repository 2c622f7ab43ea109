"""The wire as a listener reads it: SND and W/F packets of the KiwiSDR
protocol, their s16 payloads, and the IMA ADPCM quantizer (the public
IMA/DVI tables), written out plainly.

An ADPCM stream is judged code by code: from the state the served
stream itself has reached, would the reference's sample have been given
the code that was served?  That holds each code to the reference without
the lossy codec's own error, and without the divergence that two
encoders fed slightly different samples show.
"""

from __future__ import annotations

import struct

import numpy as np

STEP = [7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34,
        37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157,
        173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598,
        658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878,
        2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
        5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
        15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767]
INDEX = [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8]

SND_LITTLE_ENDIAN = 0x80
SND_IQ = 0x08
WF_COMPRESSED = 0x00010000
WF_PAD = 10
SMETER_BIAS = 127.0


def parse_snd(pkt: bytes) -> dict:
    """Flags, sequence number, the S-meter field and the payload of one
    SND packet."""
    if pkt[:3] != b"SND" or len(pkt) < 10:
        raise ValueError("not an SND packet")
    flags = pkt[3]
    seq, = struct.unpack("<I", pkt[4:8])
    sm, = struct.unpack(">H", pkt[8:10])
    n = 20 if flags & SND_IQ else 10
    return dict(flags=flags, seq=seq, smeter_u16=sm, payload=pkt[n:])


def s16(payload: bytes, flags: int) -> np.ndarray:
    return np.frombuffer(payload, "<i2" if flags & SND_LITTLE_ENDIAN
                         else ">i2").astype(np.int64)


def nibbles(payload: bytes) -> np.ndarray:
    b = np.frombuffer(payload, np.uint8)
    out = np.empty(2 * len(b), np.int64)
    out[0::2] = b & 0xF
    out[1::2] = b >> 4
    return out


def parse_wf(pkt: bytes) -> dict:
    _x, fz, seq = struct.unpack("<III", pkt[4:16])
    return dict(zoom=fz & 0xFFFF, compressed=bool(fz & WF_COMPRESSED),
                seq=seq, payload=pkt[16:])


def _quantize(diff: int, step: int) -> int:
    nib = 0
    if diff < 0:
        nib, diff = 8, -diff
    if diff >= step:
        nib |= 4
        diff -= step
    if diff >= step >> 1:
        nib |= 2
        diff -= step >> 1
    if diff >= step >> 2:
        nib |= 1
    return nib


def _advance(pred: int, idx: int, nib: int, lo: int, hi: int):
    step = STEP[idx]
    delta = step >> 3
    if nib & 1:
        delta += step >> 2
    if nib & 2:
        delta += step >> 1
    if nib & 4:
        delta += step
    pred = pred - delta if nib & 8 else pred + delta
    return max(lo, min(hi, pred)), max(0, min(88, idx + INDEX[nib]))


def code_mismatch(codes: np.ndarray, want: np.ndarray, pred: int, idx: int,
                  u8: bool = False) -> tuple[int, int, int]:
    """How many of the served ``codes`` no sample within one unit of
    ``want``'s gets from the state the served stream has reached;
    returns (mismatches, the stream's final predictor and index)."""
    lo, hi = (0, 255) if u8 else (-32768, 32767)
    bad = 0
    if len(codes) != len(want):
        return max(len(codes), len(want)), pred, idx
    for c, s in zip(codes.tolist(), want.tolist()):
        step = STEP[idx]
        bad += all(_quantize(int(s) + d - pred, step) != c
                   for d in (0, -1, 1))
        pred, idx = _advance(pred, idx, c, lo, hi)
    return bad, pred, idx


def encode(samples: np.ndarray, pred: int, idx: int, u8: bool = False
           ) -> np.ndarray:
    """The codes of ``samples`` from a state (the control's own stream)."""
    lo, hi = (0, 255) if u8 else (-32768, 32767)
    out = []
    for s in samples.tolist():
        c = _quantize(int(s) - pred, STEP[idx])
        pred, idx = _advance(pred, idx, c, lo, hi)
        out.append(c)
    return np.array(out, np.int64)


def audio_s16(audio: np.ndarray) -> np.ndarray:
    """Float audio as the server puts it on the wire (scaled, clipped,
    truncated toward zero)."""
    return np.clip(audio * 32767.0, -32768, 32767).astype(np.int16
                                                         ).astype(np.int64)


def smeter_u16(dbm: float) -> int:
    return int((min(max(float(dbm), -127.0), 3.4) + SMETER_BIAS) * 10)
