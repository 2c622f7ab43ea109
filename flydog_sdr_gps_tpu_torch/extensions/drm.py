"""DRM extension — Digital Radio Mondiale receiver core (OFDM + FAC/SDC/MSC).

Reference: `extensions/DRM/` vendors Dream 2.1.1 (2.9 MB C++ incl.
FDK-AAC), forked per channel with shmem IPC (`DRM.cpp:155-158,377`).
DRM is a COFDM broadcast system; this module implements the receiver
stack for robustness mode B in the 10 kHz channel (spectrum occupancy
3) at the framework's 12 kHz channel rate:

- OFDM cell mapping: the REAL ETSI ES 201 980 section 8.4 layout via
  :mod:`drm_tables` (same tables as Dream's `CellMappingTable.cpp`):
  carriers k = -103..103 (Tu = 256 samples at 12 kHz = mode B's
  46.875 Hz spacing, 64-sample 1/4 guard), scattered gain pilots on
  the k ≡ 1+2(s mod 3) (mod 6) lattice with the W/Z/Q phase formula,
  time/frequency reference pilots, 65 FAC cells per frame at the
  table positions, SDC in the first 2 superframe symbols, remaining
  cells MSC.
- Coding: the REAL ETSI section 7 multilevel coding via
  :mod:`drm_mlc` (tables matching Dream's `MLC/` value-for-value):
  energy dispersal, punctured K=7 rate-1/4 mother code
  (133/171/145/133 octal), ETSI table 58/59 puncturing/tailbit
  patterns, 7.3.3 block bit-interleavers (t_0 = 13/21), normalized
  QAM mapping.  FAC = 72 bits at R=3/5 over 65 QPSK cells; SDC =
  CS_1_SM (R=1/2 QPSK); MSC = CS_2_SM 16-QAM (2 levels) or CS_3_SM
  64-QAM (3 levels), EEP protection level 1.
- SDC and MSC payloads are length+CRC-16 framed byte streams (the
  full DRM multiplex/SDC-entity parse is out of scope; no AAC).
- Sync: guard-interval correlation (symbol timing + fractional CFO),
  pilot-grid channel estimator with frequency interpolation,
  zero-forcing equalization.

Scope note: MSC payload is delivered as a byte stream (data services /
text). AAC audio decode is NOT implemented — the reference's audio
path depends on the vendored FDK-AAC codec; xHE/AAC bitstreams are
surfaced raw on the "drm_msc" tap instead.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_iq
from . import drm_mlc
from . import drm_tables
from .hfdl import crc16_ccitt

FS = 12000.0
CMAP = drm_tables.make_cell_map("B", 3, fs=FS)
TU = CMAP.tu                 # 256 samples (46.875 Hz spacing)
GUARD = CMAP.guard           # 64 samples (1/4 guard, mode B)
TS = TU + GUARD              # 320 samples/symbol
SYMS_PER_FRAME = CMAP.syms_per_frame        # 15
FRAMES_PER_SUPER = drm_tables.NUM_FRAMES_IN_SUPERFRAME
KMIN, KMAX = CMAP.kmin, CMAP.kmax           # -103..103 (SO_3)

_PILOT_FLAGS = (drm_tables.CM_SCAT_PI | drm_tables.CM_TI_PI
                | drm_tables.CM_FRE_PI)


def pilot_cells(ssym: int) -> tuple[np.ndarray, np.ndarray]:
    """(carriers k, complex pilot values) of superframe symbol
    ``ssym`` (phases/gains per ETSI 8.4, from the cell map)."""
    ks = CMAP.cells_of(_PILOT_FLAGS, ssym)
    return ks, CMAP.pilots[ssym, ks - KMIN]


def fac_cells_of(fsym: int) -> np.ndarray:
    """FAC carriers of frame symbol ``fsym`` (table positions)."""
    return CMAP.cells_of(drm_tables.CM_FAC, SYMS_PER_FRAME + fsym)


def data_cells(sym: int, frame_in_super: int,
               want_sdc: bool) -> np.ndarray:
    """MSC (or SDC) carriers of frame symbol ``sym`` of frame
    ``frame_in_super``."""
    ssym = frame_in_super * SYMS_PER_FRAME + sym
    flag = drm_tables.CM_SDC if want_sdc else drm_tables.CM_MSC
    return CMAP.cells_of(flag, ssym)


# ---------------------------------------------------------------------------
# channel coding: one MlcParams per logical channel, sized from the
# cell map (MSC is coded per transmission frame, SDC per superframe,
# FAC per frame — `dream/MLC/MLC.cpp:474` CalculateParam)
# ---------------------------------------------------------------------------

def _count_data_cells(sdc: bool, frame: int | None = None) -> int:
    tot = 0
    frames = range(FRAMES_PER_SUPER) if frame is None else (frame,)
    for f in frames:
        for sym in range(SYMS_PER_FRAME):
            ssym = f * SYMS_PER_FRAME + sym
            flag = drm_tables.CM_SDC if sdc else drm_tables.CM_MSC
            tot += len(CMAP.cells_of(flag, ssym))
    return tot


NUM_FAC_CELLS = drm_tables.NUM_FAC_CELLS
FAC_MLC = drm_mlc.MlcParams("fac", NUM_FAC_CELLS)
SDC_MLC = drm_mlc.MlcParams("sdc", _count_data_cells(True))
# ETSI 6.2: the MSC is a CONTINUOUS cell stream across the superframe;
# one multiplex frame = N_MUX cells (frame boundaries fall mid-symbol),
# the cells beyond 3*N_MUX at the superframe end are dummy cells
# (`dream/OFDMcellmapping/CellMappingTable.cpp:588-597`)
_MSC_TOTAL_CELLS = _count_data_cells(False)
N_MUX = _MSC_TOTAL_CELLS // FRAMES_PER_SUPER
NUM_MSC_DUMMY = _MSC_TOTAL_CELLS - N_MUX * FRAMES_PER_SUPER
# ETSI 7.6 MSC cell interleaving: block permutation with t_0 = 5 over
# one multiplex frame; depth D=1 (short, 400 ms) and D=5 (long, 2 s)
# both implemented, selected by the FAC interleaver-depth flag.
# Long (Dream's SI_LONG, the reference encoder: out_n[i] =
# frame_{n - (i mod 5)}[perm[i]], `interleaver/SymbolInterleaver.cpp:
# 42-57`) spreads each multiplex frame over 5 transmitted frames;
# the receiver reconstructs frame m once frames m..m+4 arrived.
_MSC_CELL_PERM = drm_mlc.interleaver_perm(N_MUX, 5)
_LONG_D = 5
_LONG_SRC = np.arange(N_MUX) % _LONG_D    # i -> frame lag of cell i
# EEP (N1=0) protection level 1, 16-QAM and 64-QAM variants
MSC_MLC_16 = drm_mlc.MlcParams("msc", N_MUX, levels=2, protection=1)
MSC_MLC_64 = drm_mlc.MlcParams("msc", N_MUX, levels=3, protection=1)
# Dream's MSC dummy-cell values (`tables/TableCarMap.cpp:358-361`)
_DUMMY_CELLS = np.array([0.3162277660 + 0.3162277660j,
                         0.3162277660 - 0.3162277660j])


def crc8(data_bits: np.ndarray) -> int:
    """DRM CRC-8 (ETSI ES 201 980 annex D): poly x^8+x^4+x^3+x^2+1,
    init all-ones, output inverted, MSB first (verified equivalent to
    Dream's `util/CRC.cpp` shift-register form)."""
    reg = 0xFF
    for b in data_bits:
        fb = ((reg >> 7) & 1) ^ int(b)
        reg = ((reg << 1) & 0xFF) ^ (0x1D if fb else 0)
    return reg ^ 0xFF


# ---------------------------------------------------------------------------
# FAC block: the ETSI 72-bit parameter set (channel params 20 bits +
# service params 44 bits + CRC-8), field layout per the reference's
# `dream/FAC/FAC.cpp:37-215` (ETSI ES 201 980 section 6.3)
# ---------------------------------------------------------------------------

_FAC_IDENTITY = (3, 1, 2)      # identity field per superframe frame
_FAC_FRAME_OF = {3: 0, 0: 0, 1: 1, 2: 2}
_MSC_MODE_OF_QAM = {64: 0, 16: 3}       # CS_3_SM / CS_2_SM
_QAM_OF_MSC_MODE = {0: 64, 1: 64, 2: 64, 3: 16}


def fac_pack(service_id: int, label_idx: int, msc_qam: int = 16,
             frame_idx: int = 0,
             interleaver_short: bool = True) -> np.ndarray:
    """72 FAC bits: channel + service parameters + CRC-8."""
    bits = np.zeros(64, np.uint8)
    pos = 0

    def put(val, n):
        nonlocal pos
        for i in range(n):
            bits[pos + i] = (val >> (n - 1 - i)) & 1
        pos += n
    put(0, 1)                             # base/enhancement: base
    put(_FAC_IDENTITY[frame_idx], 2)      # identity (frame position)
    put(3, 4)                             # spectrum occupancy SO_3
    put(1 if interleaver_short else 0, 1)  # interleaver depth
    put(_MSC_MODE_OF_QAM[msc_qam], 2)     # MSC mode
    put(1, 1)                             # SDC mode: CS_1_SM (QPSK)
    put(4, 4)                             # number of services: 1 audio
    put(0, 3)                             # reconfiguration index
    put(0, 2)                             # rfu
    put(service_id & 0xFFFFFF, 24)        # service identifier
    put(0, 2)                             # short ID
    put(0, 1)                             # CA indication
    put(0, 4)                             # language
    put(0, 1)                             # audio/data flag: audio
    put(label_idx & 0x1F, 5)              # service descriptor
    put(0, 7)                             # rfa
    assert pos == 64
    c = crc8(bits)
    return np.concatenate([bits, np.array(
        [(c >> (7 - i)) & 1 for i in range(8)], np.uint8)])


def fac_unpack(bits72: np.ndarray) -> dict | None:
    if crc8(bits72[:64]) != int("".join(map(str, bits72[64:72])), 2):
        return None

    def get(lo, n):
        v = 0
        for i in range(n):
            v = (v << 1) | int(bits72[lo + i])
        return v
    if get(3, 4) != 3:                    # spectrum occupancy SO_3
        return None
    return {"service_id": get(20, 24),
            "label_idx": get(52, 5),
            "msc_qam": _QAM_OF_MSC_MODE[get(8, 2)],
            "frame_idx": _FAC_FRAME_OF.get(get(1, 2), 0),
            "interleaver_short": bool(get(7, 1)),
            # SDC mode is channel-parameter bit 10 (CS_1_SM=1 -> QPSK;
            # a bit-11 read here misreported 4-QAM SDC as 16-QAM,
            # caught by the Dream oracle test)
            "sdc_qam": 4 if get(10, 1) else 16,
            "language": get(47, 4),
            "audio": get(51, 1) == 0}


# FAC channel coding: the spec MLC chain — 72 bits at R=3/5 (rate id
# 6, `TableMLC.h` iCodRateCombFDC4SM) through the punctured rate-1/4
# mother code to the 130 bits of the 65 QPSK FAC cells

def fac_encode(bits72: np.ndarray) -> np.ndarray:
    """72 FAC bits -> 65 QPSK cells (dispersal+FEC+interleave+map)."""
    return FAC_MLC.encode(np.asarray(bits72, np.uint8))


def fac_cells_decode(cells: np.ndarray) -> dict | None:
    """65 equalized FAC cells -> FAC dict or None."""
    return fac_unpack(FAC_MLC.decode(np.asarray(cells)))


# ---------------------------------------------------------------------------
# SDC block: ETSI ES 201 980 section 6.4 — AFS index (4 bits), data
# entities [length(7) version(1) type(4) body], zero padding, CRC-16
# over the AFS index coded as a byte plus the data field (layout per
# the reference's `dream/SDC/SDCTransmit.cpp:39-123`)
# ---------------------------------------------------------------------------

def crc16_drm(bits: np.ndarray) -> int:
    """DRM CRC-16 (x^16+x^12+x^5+1, init all-ones, output inverted,
    MSB first — Dream `util/CRC.cpp` iPolynMask[15])."""
    reg = 0xFFFF
    for b in bits:
        fb = ((reg >> 15) & 1) ^ int(b)
        reg = ((reg << 1) & 0xFFFF) ^ (0x1021 if fb else 0)
    return reg ^ 0xFFFF


def _bits_of(val: int, n: int) -> list[int]:
    return [(val >> (n - 1 - i)) & 1 for i in range(n)]


def sdc_entity_type0(len_a: int, len_b: int, prot_a: int = 0,
                     prot_b: int = 1) -> tuple[int, list[int]]:
    """Multiplex description (one stream)."""
    return 0, (_bits_of(prot_a, 2) + _bits_of(prot_b, 2)
               + _bits_of(len_a, 12) + _bits_of(len_b, 12))


def sdc_entity_type1(label: bytes) -> tuple[int, list[int]]:
    """Service label (short id 0)."""
    label = label[:16]
    body = _bits_of(0, 2) + _bits_of(0, 2)        # short id + rfu
    for byte in label:
        body += _bits_of(byte, 8)
    return 1, body


def sdc_entity_type9(stream_id: int = 0, coding: int = 0,
                     sr_idx: int = 3, text: bool = False
                     ) -> tuple[int, list[int]]:
    """Audio information (layout per `dream/SDC/audioparam.cpp:153`):
    short id, stream id, coding (0=AAC), SBR, mode, sample rate
    (AAC: 1=12 kHz, 3=24 kHz), text flag, enhancement, coder
    field, rfa."""
    return 9, (_bits_of(0, 2) + _bits_of(stream_id, 2)
               + _bits_of(coding, 2) + [0]          # SBR off
               + _bits_of(0, 2)                     # mono
               + _bits_of(sr_idx, 3) + [1 if text else 0, 0]
               + _bits_of(0, 5) + [0])


def sdc_pack(entities: list[tuple[int, list[int]]],
             total_bits: int) -> np.ndarray:
    """Assemble one SDC block of exactly ``total_bits`` bits."""
    bits = [0, 0, 0, 1]                   # AFS index = 1 (Dream)
    for etype, body in entities:
        assert len(body) >= 4 and (len(body) - 4) % 8 == 0, etype
        bits += _bits_of((len(body) - 4) // 8, 7)
        bits += [0]                       # version flag
        bits += _bits_of(etype, 4)
        bits += body
    data_bits = (total_bits - 20)
    assert len(bits) - 4 <= data_bits, "SDC overflow"
    bits += [0] * (4 + data_bits - len(bits))
    # CRC over AFS-as-byte (4 zero MSBs) + data field
    crc_in = [0, 0, 0, 0] + bits[:4 + data_bits]
    c = crc16_drm(np.array(crc_in, np.uint8))
    bits += _bits_of(c, 16)
    assert len(bits) == total_bits
    return np.array(bits, np.uint8)


def sdc_parse(bits: np.ndarray) -> dict | None:
    """Parse one SDC block -> {'label', 'streams', 'protection',
    'audio'} or None on CRC failure."""
    bits = np.asarray(bits, np.uint8)
    n = len(bits)
    crc_in = np.concatenate([np.zeros(4, np.uint8), bits[:n - 16]])
    want = 0
    for b in bits[n - 16:]:
        want = (want << 1) | int(b)
    if crc16_drm(crc_in) != want:
        return None

    def get(lo, k):
        v = 0
        for i in range(k):
            v = (v << 1) | int(bits[lo + i])
        return v
    info: dict = {"afs": get(0, 4), "streams": [], "protection": None,
                  "label": None, "audio": None}
    pos = 4
    while pos + 12 <= n - 16:
        ln = get(pos, 7)
        etype = get(pos + 8, 4)
        body = pos + 12
        nbody = ln * 8 + 4
        if etype == 0 and ln == 0:
            break                         # zero padding reached
        if body + nbody > n - 16:
            break
        if etype == 0:
            prot = (get(body, 2), get(body + 2, 2))
            streams = []
            for off in range(body + 4, body + nbody - 23, 24):
                streams.append((get(off, 12), get(off + 12, 12)))
            info["protection"] = prot
            info["streams"] = streams
        elif etype == 1:
            raw = bytes(get(body + 4 + 8 * i, 8)
                        for i in range((nbody - 4) // 8))
            info["label"] = raw
        elif etype == 9:
            info["audio"] = dict(
                short_id=get(body, 2), stream_id=get(body + 2, 2),
                coding=get(body + 4, 2), sbr=get(body + 6, 1),
                mode=get(body + 7, 2), sr_idx=get(body + 9, 3),
                text=get(body + 12, 1))
        pos = body + nbody
    return info


def audio_frames_per_super(audio: dict | None) -> int:
    """AU count per audio super frame from the SDC type-9 audio
    params: AAC @24 kHz -> 10, @12 kHz -> 5 (ETSI 5.3.1.1)."""
    if audio and audio.get("coding") == 0 and audio.get("sr_idx") == 3:
        return 10
    return 5


# ---------------------------------------------------------------------------
# Transmitter (loopback source / sig-gen)
# ---------------------------------------------------------------------------

class DrmTx:
    def __init__(self, service_id: int = 0xA1B2C3, label_idx: int = 7,
                 msc_qam: int = 16, interleaver: str = "short"):
        self.service_id = service_id
        self.label_idx = label_idx
        self.msc_qam = msc_qam
        assert interleaver in ("short", "long")
        self.interleaver = interleaver
        # SI_LONG: ring of the last D=5 logical frames' pre-interleave
        # cells (zeros until the pipeline fills, like Dream's
        # interleaver memory)
        self._ilv_ring: list[np.ndarray] = []

    def _interleave(self, cells: np.ndarray) -> np.ndarray:
        if self.interleaver == "short":
            return cells[_MSC_CELL_PERM]
        self._ilv_ring.insert(0, cells)
        del self._ilv_ring[_LONG_D:]
        mem = np.stack(
            [self._ilv_ring[j] if j < len(self._ilv_ring)
             else np.zeros_like(cells) for j in range(_LONG_D)])
        return mem[_LONG_SRC, _MSC_CELL_PERM]

    def superframe(self, sdc_payload: bytes,
                   msc_payload) -> np.ndarray:
        """One 3-frame superframe of passband audio (no silence pad).

        ``sdc_payload``: the service label carried in the ETSI SDC
        block (type-1 entity, <=16 bytes; the block also carries the
        type-0 multiplex description and type-9 audio info).
        ``msc_payload``: bytes (data service, length+CRC-16 framed)
        OR a list of 3 lists of AAC access units — then each multiplex
        frame carries an ETSI 5.3.1 AUDIO SUPER FRAME
        (:mod:`drm_audio`)."""
        msc_mlc = MSC_MLC_16 if self.msc_qam == 16 else MSC_MLC_64
        stream_len = msc_mlc.total_bits // 8
        audio_mode = isinstance(msc_payload, (list, tuple))
        label = (sdc_payload if isinstance(sdc_payload, bytes)
                 else str(sdc_payload).encode())
        sdc_bits = sdc_pack([
            sdc_entity_type0(0, stream_len),
            sdc_entity_type9(sr_idx=1),      # AAC 12 kHz -> 5 AUs
            sdc_entity_type1(label),
        ], SDC_MLC.total_bits)
        sdc_cells = SDC_MLC.encode(sdc_bits)
        # MSC: one multiplex frame of N_MUX cells per logical frame,
        # cell-interleaved (ETSI 7.6 short), then laid out as one
        # CONTINUOUS stream across the superframe + dummy cells
        msc_stream = []
        for f in range(FRAMES_PER_SUPER):
            if audio_mode:
                from . import drm_audio
                sf = drm_audio.build_super_frame(
                    list(msc_payload[f]), stream_len)
                bits = np.unpackbits(np.frombuffer(sf, np.uint8))
            else:
                bits = self._framed_bytes(msc_payload)
            msc_bits = np.zeros(msc_mlc.total_bits, np.uint8)
            msc_bits[:min(len(bits), len(msc_bits))] = \
                bits[:len(msc_bits)]
            cells = msc_mlc.encode(msc_bits)
            msc_stream.append(self._interleave(cells))
        if NUM_MSC_DUMMY:
            msc_stream.append(
                _DUMMY_CELLS[np.arange(NUM_MSC_DUMMY) % 2])
        msc_cells = np.concatenate(msc_stream)
        si, mi = 0, 0
        out = []
        for f in range(FRAMES_PER_SUPER):
            fac_cells = fac_encode(
                fac_pack(self.service_id, self.label_idx,
                         msc_qam=self.msc_qam, frame_idx=f,
                         interleaver_short=(self.interleaver
                                            == "short"))[:72])
            fi = 0
            for sym in range(SYMS_PER_FRAME):
                ssym = f * SYMS_PER_FRAME + sym
                spec = np.zeros(TU, np.complex128)

                def put(k, v):
                    spec[k % TU] = v
                ks, vals = pilot_cells(ssym)
                for k, v in zip(ks, vals):
                    put(int(k), v)
                for k in fac_cells_of(sym):
                    put(int(k), fac_cells[fi])
                    fi += 1
                for k in data_cells(sym, f, want_sdc=True):
                    put(int(k), sdc_cells[si])
                    si += 1
                for k in data_cells(sym, f, want_sdc=False):
                    put(int(k), msc_cells[mi])
                    mi += 1
                td = np.fft.ifft(spec) * np.sqrt(TU)
                out.append(np.concatenate([td[-GUARD:], td]))
        # complex baseband: DRM is 8.5 kHz wide and rides the IQ
        # tap (reference: ext_register_receive_iq_samps, DRM.cpp),
        # not the real audio channel
        return np.concatenate(out).astype(np.complex64)

    @staticmethod
    def _framed_bytes(payload: bytes) -> np.ndarray:
        hdr = len(payload).to_bytes(2, "big")
        crc = crc16_ccitt(hdr + payload).to_bytes(2, "big")
        return np.unpackbits(np.frombuffer(hdr + payload + crc,
                                           np.uint8))

    @staticmethod
    def _fit(bits: np.ndarray, n: int) -> np.ndarray:
        if len(bits) >= n:
            return bits[:n]
        reps = -(-n // len(bits))
        return np.tile(bits, reps)[:n]



# ---------------------------------------------------------------------------
# Receiver
# ---------------------------------------------------------------------------

class DrmRx:
    """Streaming DRM receiver: 12 kHz real audio in; FAC dicts and
    SDC/MSC payloads out.

    ``msc_audio=True`` parses each frame's MSC as an ETSI 5.3.1
    audio super frame and emits validated AAC access units on
    ``drm_audio_frame`` instead of the byte-stream framing."""

    def __init__(self, msc_audio: bool = False):
        self._audio = np.zeros(0, np.complex64)
        self._n0 = 0
        self.fac: dict | None = None
        self.msc_audio = msc_audio
        self._synced_at: int | None = None
        # SI_LONG deinterleaver: ring of received per-frame MSC cell
        # chunks across CONSECUTIVE superframes (feed() steps one
        # superframe at a time when synced); frame m reconstructs
        # once frames m..m+4 have arrived
        self._rx_ring: list[np.ndarray] = []

    def feed(self, iq: np.ndarray) -> list[tuple[str, object]]:
        self._audio = np.concatenate([self._audio,
                                      np.asarray(iq, np.complex64)])
        need = (FRAMES_PER_SUPER * SYMS_PER_FRAME + 2) * TS + TU
        out = []
        while len(self._audio) >= need + TS:
            bb = self._audio.astype(np.complex128)
            start, cfo = self._sync(bb[:need + TS])
            if start is None:
                self._drop(need // 2)
                self._rx_ring = []    # long deinterleaver continuity
                continue
            res = self._demod_super(bb, start, cfo)
            if res is None:
                self._drop(start + TS)
                self._rx_ring = []
                continue
            out.extend(res)
            self._drop(start + FRAMES_PER_SUPER * SYMS_PER_FRAME * TS)
        return out

    def _drop(self, n: int) -> None:
        n = max(int(n), 1)
        self._audio = self._audio[n:]
        self._n0 += n

    # -- synchronisation --------------------------------------------------
    def _sync(self, bb: np.ndarray):
        """Guard correlation -> (superframe start sample, fractional
        CFO in carrier spacings) or (None, 0)."""
        n = len(bb) - TU - TS
        g = bb[:n + TU] * np.conj(bb[TU:n + TU + TU])
        # moving sum over the guard length
        cs = np.cumsum(np.concatenate([[0], g[:n + GUARD]]))
        mov = cs[GUARD:] - cs[:-GUARD]
        # fold over the symbol period: peaks every TS
        m = (len(mov) // TS) * TS
        if m < 3 * TS:
            return None, 0.0
        fold = np.abs(mov[:m].reshape(-1, TS)).sum(axis=0)
        e = np.abs(bb[:m]) ** 2
        if fold.max() < 1e-6 or fold.max() < 2.0 * np.median(fold):
            return None, 0.0
        sym_off = int(np.argmax(fold))
        # fractional CFO from guard-correlation phase at the peaks
        pk = mov[sym_off::TS]
        cfo = -np.angle(np.sum(pk)) / (2 * np.pi)
        # find the superframe boundary: try each symbol slot, decode
        # FAC of the frame starting there (cheap: 1 frame of FFTs)
        for cand in range(FRAMES_PER_SUPER * SYMS_PER_FRAME):
            s0 = sym_off + cand * TS
            if s0 + SYMS_PER_FRAME * TS + TU > len(bb):
                break
            fac = self._try_fac(bb, s0, cfo)
            if fac is not None:
                # frame_idx tells where we are in the superframe
                start = s0 - fac["frame_idx"] * SYMS_PER_FRAME * TS
                if start >= 0:
                    self.fac = fac
                    return start, cfo
        return None, 0.0

    def _fft_symbol(self, bb, s0, sym, cfo):
        seg = bb[s0 + sym * TS + GUARD: s0 + sym * TS + GUARD + TU]
        if len(seg) < TU:
            return None
        t = np.arange(len(seg))
        seg = seg * np.exp(-2j * np.pi * cfo * t / TU)
        return np.fft.fft(seg) / np.sqrt(TU)

    def _estimate_channel(self, spec, ssym):
        """LS estimate on this symbol's pilot cells (scattered + time
        + frequency references), linear interpolation across
        carriers.  Pilot values repeat per frame, so ``ssym`` may be
        any superframe symbol with the right frame phase."""
        ks, ref = pilot_cells(ssym)
        h = spec[ks % TU] / ref
        k_all = np.arange(KMIN, KMAX + 1)
        hr = np.interp(k_all, ks, np.real(h))
        hi = np.interp(k_all, ks, np.imag(h))
        return dict(zip(k_all.tolist(), hr + 1j * hi))

    def _try_fac(self, bb, s0, cfo) -> dict | None:
        cells = []
        for sym in range(SYMS_PER_FRAME):
            ks = fac_cells_of(sym)
            if len(ks) == 0:
                continue
            spec = self._fft_symbol(bb, s0, sym, cfo)
            if spec is None:
                return None
            # pilots depend only on the frame symbol; row 15+sym has
            # the same pilot cells for any frame
            hmap = self._estimate_channel(spec, SYMS_PER_FRAME + sym)
            for k in ks:
                hh = hmap[int(k)]
                if abs(hh) < 1e-9:
                    return None
                cells.append(spec[k % TU] / hh)
        return fac_cells_decode(np.asarray(cells))

    def _demod_super(self, bb, start, cfo):
        sdc_cells, facs, msc_all = [], [], []
        for f in range(FRAMES_PER_SUPER):
            s0 = start + f * SYMS_PER_FRAME * TS
            fac = self._try_fac(bb, s0, cfo)
            if fac is None:
                return None
            facs.append(fac)
            for sym in range(SYMS_PER_FRAME):
                ssym = f * SYMS_PER_FRAME + sym
                spec = self._fft_symbol(bb, s0, sym, cfo)
                if spec is None:
                    return None
                hmap = self._estimate_channel(spec, ssym)
                for k in data_cells(sym, f, want_sdc=True):
                    sdc_cells.append(spec[k % TU] / hmap[int(k)])
                for k in data_cells(sym, f, want_sdc=False):
                    msc_all.append(spec[k % TU] / hmap[int(k)])
        out = [("drm_fac", facs[0])]
        info = sdc_parse(SDC_MLC.decode(np.asarray(sdc_cells)))
        stream_len = None
        if info is not None:
            out.append(("drm_sdc_info", info))
            if info.get("label") is not None:
                out.append(("drm_sdc", info["label"]))
            if info.get("streams"):
                stream_len = sum(info["streams"][0])
        msc_mlc = (MSC_MLC_16 if facs[0]["msc_qam"] == 16
                   else MSC_MLC_64)
        # continuous MSC stream: 3 multiplex frames of N_MUX cells,
        # dummy cells at the superframe end dropped; each frame
        # cell-DEinterleaved (ETSI 7.6, short D=1 or long D=5 per
        # the FAC flag) before MLC decoding
        cells = np.asarray(msc_all)[:FRAMES_PER_SUPER * N_MUX]
        chunks = [cells[f * N_MUX:(f + 1) * N_MUX]
                  for f in range(FRAMES_PER_SUPER)]
        if facs[0].get("interleaver_short", True):
            self._rx_ring = []
            deints = []
            for chunk in chunks:
                deint = np.empty_like(chunk)
                deint[_MSC_CELL_PERM] = chunk
                deints.append(deint)
        else:
            # long: c_m[perm[i]] = r_{m+(i mod 5)}[i]
            self._rx_ring.extend(chunks)
            del self._rx_ring[:-(_LONG_D + FRAMES_PER_SUPER)]
            deints = []
            n_ready = len(self._rx_ring) - _LONG_D + 1
            for m in range(max(0, n_ready - FRAMES_PER_SUPER),
                           n_ready):
                rmat = np.stack(self._rx_ring[m:m + _LONG_D])
                deint = np.empty_like(rmat[0])
                deint[_MSC_CELL_PERM] = rmat[_LONG_SRC,
                                             np.arange(N_MUX)]
                deints.append(deint)
        seen = set()
        for deint in deints:
            bits = msc_mlc.decode(deint)
            if self.msc_audio:
                from . import drm_audio
                data = np.packbits(
                    bits[:len(bits) - len(bits) % 8]).tobytes()
                if stream_len:
                    data = data[:stream_len]
                n_au = audio_frames_per_super(
                    info.get("audio") if info else None)
                frames = drm_audio.parse_super_frame(data, n_au)
                if frames is not None:
                    for au, ok in frames:
                        if ok and au:
                            out.append(("drm_audio_frame", au))
                continue
            msc = self._frame_payload(bits)
            if msc is not None and msc not in seen:
                seen.add(msc)
                out.append(("drm_msc", msc))
        return out

    @staticmethod
    def _frame_payload(bits: np.ndarray) -> bytes | None:
        """length+CRC-16 framed byte stream -> payload or None."""
        data = np.packbits(bits[:len(bits) - len(bits) % 8]).tobytes()
        if len(data) < 4:
            return None
        ln = int.from_bytes(data[:2], "big")
        if len(data) < ln + 4:
            return None
        if crc16_ccitt(data[:ln + 2]) != int.from_bytes(
                data[ln + 2:ln + 4], "big"):
            return None
        return data[2:ln + 2]


@ext_register
class DrmExt(Extension):
    name = "DRM"

    def start(self, **params):
        self.rx = DrmRx()

    def process_block(self, taps) -> list:
        re, im = host_iq(taps.iq_post_agc, self.rx_chan)
        iq = re + 1j * im
        out = []
        for tag, payload in self.rx.feed(iq.astype(np.complex64)):
            if tag == "drm_fac":
                out.append((tag, repr(payload).encode()))
            else:
                out.append((tag, payload))
        return out
