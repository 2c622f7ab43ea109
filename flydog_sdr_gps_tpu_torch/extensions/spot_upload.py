"""Spot-upload wire formats: wsprnet.org POST and the PSKReporter
UDP (IPFIX-style) protocol.

Reference: the WSPR autorun uploader builds a wsprnet.org GET with
the spot fields (`extensions/wspr/wspr_main.cpp:524-531`) and the
FT8/FT4 autorun uploader speaks PSKReporter's documented
IPFIX-derived UDP protocol to report.pskreporter.info:4739
(`extensions/FT8/PSKReporter.cpp` — message header, receiver
option-template 0x1138/0x1139 and sender template 0x1140 under
enterprise 30351, length-prefixed strings, 4-byte set padding).

Transport-free: builders return URLs/bytes; `server/autorun.py`
sends them only when egress is enabled, and the unit tests parse the
built datagrams structurally (no network).
"""

from __future__ import annotations

import secrets
import struct
import time


# ---------------------------------------------------------------------------
# wsprnet.org
# ---------------------------------------------------------------------------

def wsprnet_url(rcall: str, rgrid: str, rx_freq_mhz: float,
                when: time.struct_time, snr_db: float, dt_s: float,
                drift: int, tx_freq_mhz: float, tx_call: str,
                tx_grid: str, dbm: str,
                base: str = "http://wsprnet.org/post") -> str:
    """The reference's WSPR_SPOT query, field for field
    (`wspr_main.cpp:524-528`)."""
    from urllib.parse import urlencode
    q = dict(function="wspr", rcall=rcall, rgrid=rgrid,
             rqrg=f"{rx_freq_mhz:.6f}",
             date=f"{when.tm_year % 100:02d}{when.tm_mon:02d}"
                  f"{when.tm_mday:02d}",
             time=f"{when.tm_hour:02d}{when.tm_min:02d}",
             sig=f"{snr_db:.0f}", dt=f"{dt_s:.1f}", drift=int(drift),
             tqrg=f"{tx_freq_mhz:.6f}", tcall=tx_call, tgrid=tx_grid,
             dbm=dbm, version="1.4A+TPU")
    return f"{base}?{urlencode(q)}"


# ---------------------------------------------------------------------------
# PSKReporter
# ---------------------------------------------------------------------------

PSKREPORTER_HOST = "report.pskreporter.info"
PSKREPORTER_PORT = 4739
_ENTERPRISE = 30351
_RX_TMPL, _RX_ANT_TMPL, _TX_TMPL = 0x1138, 0x1139, 0x1140
_STR = 0xFFFF


def _field(elem: int, length: int, enterprise: bool = True) -> bytes:
    out = struct.pack(">HH", elem, length)
    if enterprise:
        out += struct.pack(">I", _ENTERPRISE)
    return out


def _pstr(s: str) -> bytes:
    b = s.encode("ascii", "replace")[:255]
    return bytes([len(b)]) + b


def _pad4(b: bytearray) -> None:
    while len(b) % 4:
        b.append(0)


class PskReporter:
    """Datagram builder with the reference's send discipline: the
    template descriptors ride the first few packets, the receiver
    record precedes every spot batch, sequence number and a random
    per-boot identifier persist across packets."""

    def __init__(self, rcall: str, rgrid: str,
                 antenna: str | None = None,
                 client: str = "flydog_sdr_gps_tpu"):
        self.rcall = rcall
        self.rgrid = rgrid
        self.antenna = antenna
        self.client = client
        self.seq = 0
        self.rand_id = secrets.randbits(32)
        self.desc_remaining = 3        # PR_INFO_DESC_RPT

    # -- templates ----------------------------------------------------------
    def _rx_descriptor(self) -> bytes:
        fields = [_field(0x8002, _STR), _field(0x8004, _STR)]
        if self.antenna:
            fields.append(_field(0x8009, _STR))
        fields.append(_field(0x8008, _STR))
        tmpl = _RX_ANT_TMPL if self.antenna else _RX_TMPL
        body = bytearray(struct.pack(">HHH", tmpl, len(fields), 0))
        for f in fields:
            body += f
        out = bytearray(struct.pack(">HH", 3, 0)) + body
        _pad4(out)
        struct.pack_into(">H", out, 2, len(out))
        return bytes(out)

    def _tx_descriptor(self) -> bytes:
        fields = (_field(0x8001, _STR) + _field(0x8005, 4)
                  + _field(0x8006, 1) + _field(0x800A, _STR)
                  + _field(0x8003, _STR) + _field(0x800B, 1)
                  + _field(150, 4, enterprise=False))
        out = bytearray(struct.pack(">HHHH", 2, 0, _TX_TMPL, 7))
        out += fields
        _pad4(out)
        struct.pack_into(">H", out, 2, len(out))
        return bytes(out)

    # -- data sets ----------------------------------------------------------
    def _rx_record(self) -> bytes:
        out = bytearray(struct.pack(
            ">HH", _RX_ANT_TMPL if self.antenna else _RX_TMPL, 0))
        out += _pstr(self.rcall) + _pstr(self.rgrid)
        if self.antenna:
            out += _pstr(self.antenna)
        out += _pstr(self.client)
        _pad4(out)
        struct.pack_into(">H", out, 2, len(out))
        return bytes(out)

    def _tx_record(self, spot: dict) -> bytes:
        out = bytearray(struct.pack(">HH", _TX_TMPL, 0))
        out += _pstr(spot["call"])
        out += struct.pack(">I", int(spot["freq_hz"]))
        out += struct.pack(">b", max(-128, min(127,
                                               int(spot["snr_db"]))))
        out += _pstr(spot["mode"])
        out += _pstr(spot.get("grid", ""))
        out += bytes([1])                      # informationSource=auto
        out += struct.pack(">I", int(spot["time"]))
        _pad4(out)
        struct.pack_into(">H", out, 2, len(out))
        return bytes(out)

    def datagram(self, spots: list[dict],
                 now: float | None = None) -> bytes:
        """One upload packet: header + (descriptors while fresh) +
        receiver record + one sender record per spot."""
        body = bytearray()
        if self.desc_remaining > 0:
            body += self._tx_descriptor() + self._rx_descriptor()
            self.desc_remaining -= 1
        body += self._rx_record()
        for s in spots:
            body += self._tx_record(s)
        hdr = struct.pack(">HHIII", 10, 16 + len(body),
                          int(now if now is not None else time.time()),
                          self.seq, self.rand_id)
        self.seq += 1
        return hdr + bytes(body)


# ---------------------------------------------------------------------------
# autorun glue
# ---------------------------------------------------------------------------

class SpotUploader:
    """`AutorunManager.upload` callable: routes harvested spots to
    the right wire format.  Transports are injected (egress-gated in
    this environment; a deployment passes real HTTP/UDP senders)."""

    def __init__(self, rcall: str, rgrid: str, http_send=None,
                 udp_send=None, antenna: str | None = None):
        self.rcall, self.rgrid = rcall, rgrid
        self.http_send = http_send      # callable(url)
        self.udp_send = udp_send        # callable(bytes, (host, port))
        self.reporter = PskReporter(rcall, rgrid, antenna=antenna)
        self.sent = 0

    def __call__(self, spot: dict) -> None:
        ext = spot.get("ext", "").upper()
        text = spot.get("text", "")
        toks = text.split()
        if ext == "WSPR" and self.http_send is not None and \
                len(toks) >= 3:
            # wspr decode text: "<call> <grid> <dbm>"-leading tokens
            url = wsprnet_url(
                self.rcall, self.rgrid, spot.get("dial_khz", 0) / 1e3,
                time.gmtime(spot.get("t", time.time())),
                snr_db=float(spot.get("snr", 0)), dt_s=0.0, drift=0,
                tx_freq_mhz=spot.get("dial_khz", 0) / 1e3,
                tx_call=toks[0], tx_grid=toks[1], dbm=toks[2])
            self.http_send(url)
            self.sent += 1
        elif ext in ("FT8", "FT4") and self.udp_send is not None:
            # decode text: "[CQ] <call> <grid...> <audio_freq>"
            if toks and toks[0] in ("CQ", "QRZ", "DE"):
                call = toks[1] if len(toks) > 1 else ""
            else:
                call = toks[0] if toks else ""
            if not call:
                return
            grid = next((t for t in toks[1:] if len(t) == 4
                         and t[:2].isalpha() and t[2:].isdigit()), "")
            try:
                af = float(toks[-1])
            except (ValueError, IndexError):
                af = 0.0
            pkt = self.reporter.datagram([dict(
                call=call, grid=grid,
                freq_hz=int(spot.get("dial_khz", 0) * 1000 + af),
                snr_db=int(spot.get("snr", 0)), mode=ext,
                time=int(spot.get("t", time.time())))])
            self.udp_send(pkt, (PSKREPORTER_HOST, PSKREPORTER_PORT))
            self.sent += 1
