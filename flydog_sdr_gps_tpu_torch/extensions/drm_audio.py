"""DRM MSC audio super frame layer (ETSI ES 201 980 section 5.3.1).

Reference: `dream/MSC/aacsuperframe.cpp` (+`audiosuperframe.cpp`):
each 400 ms logical frame carries one AUDIO SUPER FRAME holding 5
AAC access units (12 kHz AAC in modes A-D): a header of 12-bit frame
borders (cumulative byte offsets, mod 4096, plus 4 reserved bits
when there are 9 borders), one CRC-8 byte per frame (located
together after the header in the EEP case, `aacsuperframe.cpp:156`),
then the frame payloads.

This implements the packaging layer — build/parse of the super
frame, border arithmetic including the mod-4096 wrap (Table 11 note
2), per-frame CRC — so the DRM receiver delivers clean, validated
AAC access units.  The AAC *codec* itself stays out of scope (the
reference vendors FDK-AAC; audio AUs surface raw on the
``drm_audio_frame`` tap).

The per-frame CRC-8 here is the DRM CRC (x^8+x^4+x^3+x^2+1, inverted
in/out — same as FAC) computed over the whole access unit; the
standard scopes it to the higher-protected portion, which for the
repo's EEP-only configuration is the choice Dream's EEP path also
effectively exercises.
"""

from __future__ import annotations

import numpy as np

from .drm import crc8

NUM_FRAMES_12K = 5          # AAC @ 12 kHz, robustness modes A-D


def _crc8_bytes(data: bytes) -> int:
    return crc8(np.unpackbits(np.frombuffer(data, np.uint8)))


def build_super_frame(frames: list[bytes], total_len: int) -> bytes:
    """Pack access units into one audio super frame of exactly
    ``total_len`` bytes (the logical frame's MSC capacity); unused
    payload space pads the LAST frame with zeros (its border math
    still resolves because borders precede the last frame)."""
    n = len(frames)
    borders = n - 1
    header_bits = 12 * borders + (4 if borders == 9 else 0)
    assert header_bits % 8 == 0, "unsupported frame count"
    header_bytes = header_bits // 8
    payload_len = total_len - header_bytes - n
    sizes = [len(f) for f in frames]
    if sum(sizes) > payload_len:
        raise ValueError(f"{sum(sizes)} bytes > capacity {payload_len}")
    # grow the final frame to fill the payload exactly
    frames = list(frames)
    frames[-1] = frames[-1] + b"\x00" * (payload_len - sum(sizes))

    bits = []
    acc = 0
    for f in frames[:-1]:
        acc += len(f)
        b = acc % 4096                  # Table 11 note 2
        bits.extend((b >> (11 - i)) & 1 for i in range(12))
    if borders == 9:
        bits.extend([0, 0, 0, 0])
    out = bytearray(np.packbits(np.array(bits, np.uint8)).tobytes())
    for f in frames:                    # EEP: CRCs grouped post-header
        out.append(_crc8_bytes(f))
    for f in frames:
        out += f
    assert len(out) == total_len, (len(out), total_len)
    return bytes(out)


def parse_super_frame(data: bytes, num_frames: int = NUM_FRAMES_12K
                      ) -> list[tuple[bytes, bool]] | None:
    """-> [(access_unit, crc_ok), ...] or None if the borders are
    inconsistent (`aacsuperframe.cpp:80-132` header())."""
    n = num_frames
    borders = n - 1
    header_bits = 12 * borders + (4 if borders == 9 else 0)
    header_bytes = header_bits // 8
    if len(data) < header_bytes + n:
        return None
    payload_len = len(data) - header_bytes - n
    hbits = np.unpackbits(np.frombuffer(data[:header_bytes], np.uint8))
    sizes = []
    prev = 0
    for k in range(borders):
        b = 0
        for i in range(12):
            b = (b << 1) | int(hbits[12 * k + i])
        if b < prev:
            b += 4096                   # Table 11 note 2
        if b > payload_len:
            return None
        sizes.append(b - prev)
        prev = b
    sizes.append(payload_len - prev)
    if sizes[-1] < 0:
        return None
    crcs = data[header_bytes:header_bytes + n]
    out = []
    off = header_bytes + n
    for k in range(n):
        au = data[off:off + sizes[k]]
        off += sizes[k]
        out.append((au, _crc8_bytes(au) == crcs[k]))
    return out
