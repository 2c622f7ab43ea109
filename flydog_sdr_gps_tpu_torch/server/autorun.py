"""Autorun: background decoders occupying idle rx channels.

Reference: `rx/rx_util.cpp` arun_* — the server starts WSPR/FT8
decoder instances on channels no user is occupying
(`extensions/wspr/wspr_main.cpp:473-480` autorun tasks,
`extensions/FT8/FT8.cpp` autorun), surrenders the channel the moment a
real user needs it, and uploads decoded spots to wsprnet/PSKReporter
(`extensions/FT8/PSKReporter.cpp`).

Port of :mod:`flydog_sdr_gps_tpu.server.autorun`.  Each autorun unit
is an extension instance (`extensions/wspr.py`, `extensions/ft8.py`)
fed from the same per-block taps every connection shares (the server's
``HostTaps``) — an idle channel costs nothing extra on the device (all
channels advance in the one block step regardless); the decoder front
ends run in torch on the engine's device once a capture.

Spot upload is EGRESS-GATED (this environment has no network egress):
the upload hook logs and stores; a deployment passes
`extensions.spot_upload.SpotUploader` (real wsprnet query +
PSKReporter IPFIX datagrams, structurally tested offline) as a real
wsprnet/PSKReporter client.
"""

from __future__ import annotations

import time

from .. import extensions as ext_mod
from ..ops import demod
from ..utils.log import lprintf


class AutorunUnit:
    """One background decoder slot (an arun_* instance).

    ``slots`` holds one or more (ext_name, freq_khz) pairs; with more
    than one the unit ALTERNATES between them after each completed
    capture cycle (e.g. FT8 and FT4 time-sharing one rx channel, like
    WSJT-X's 'hound' alternation)."""

    def __init__(self, slots: list[tuple[str, float]]):
        self.slots = slots
        self.slot_idx = 0
        self.rx_chan: int | None = None
        self.ext = None

    @property
    def ext_name(self) -> str:
        return self.slots[self.slot_idx][0]

    @property
    def freq_khz(self) -> float:
        return self.slots[self.slot_idx][1]

    def __repr__(self):
        return (f"AutorunUnit({self.ext_name}@{self.freq_khz}kHz, "
                f"ch={self.rx_chan})")


def _parse_freq_khz(f: str) -> float:
    f = f.strip().upper()
    mult = 1.0
    if f.endswith("M"):
        f, mult = f[:-1], 1e3
    freq_khz = float(f) * mult
    if freq_khz >= 100e3:          # given in Hz
        freq_khz /= 1e3
    return freq_khz


def _resolve_ext(name: str) -> str:
    # tolerate case-insensitive extension names
    for reg in ext_mod.ext_list():
        if reg.lower() == name.strip().lower():
            return reg
    raise ValueError(f"autorun: unknown extension {name!r}")


def parse_spec(spec: str) -> list[tuple[str, float]]:
    """"wspr:7038.6" / "FT8:14074" -> [(registered ext name, kHz)].

    Alternating form: "FT8/FT4:14074/14080" time-shares one channel
    between the listed decoders (paired with the listed dials).
    """
    name, _, f = spec.partition(":")
    names = [_resolve_ext(n) for n in name.split("/")]
    freqs = [_parse_freq_khz(x) for x in f.split("/")]
    if len(freqs) == 1:
        freqs = freqs * len(names)
    if len(freqs) != len(names):
        raise ValueError(f"autorun: {len(names)} exts need "
                         f"{len(names)} dials in {spec!r}")
    return list(zip(names, freqs))


class AutorunManager:
    """Claims idle channels for decoders; yields them to users."""

    def __init__(self, server, specs: list[str], upload=None):
        self.server = server
        self.units = [AutorunUnit(parse_spec(s)) for s in specs]
        self.spots: list[dict] = []      # ring of decoded spots
        self.upload = upload             # egress-gated by default
        self.uploads_gated = 0

    @property
    def channels(self) -> set[int]:
        return {u.rx_chan for u in self.units if u.rx_chan is not None}

    # -- channel claim / release -----------------------------------------
    def tick(self) -> None:
        """Claim a free channel for any parked unit (called per block;
        the reference re-arms autorun instances the same way after a
        user leaves, `rx_util.cpp` arun_restart)."""
        eng = self.server.engine
        for unit in self.units:
            if unit.rx_chan is not None:
                continue
            used = {c.rx_chan for c in self.server.conns.values()
                    if c.rx_chan is not None} | self.channels
            ch = next((i for i in range(eng.params.num_channels)
                       if i not in used), None)
            if ch is None:
                return
            unit.rx_chan = ch
            eng.ctl[ch].in_use = True
            eng.set_channel(ch, freq_hz=unit.freq_khz * 1e3,
                            mode=demod.MODE_USB,
                            passband=(300.0, 2700.0))
            unit.ext = ext_mod.ext_create(unit.ext_name, eng, ch)
            unit.ext.start()
            lprintf("autorun: %s on ch%d @ %.4f kHz",
                    unit.ext_name, ch, unit.freq_khz)

    def release_one(self) -> bool:
        """Surrender one autorun channel to a user (reference: autorun
        yields immediately on user demand)."""
        for unit in self.units:
            if unit.rx_chan is not None:
                self._park(unit)
                return True
        return False

    def _rotate(self, unit: AutorunUnit) -> None:
        """Switch an alternating unit to its next (ext, dial) slot."""
        if unit.ext is not None:
            unit.ext.stop()
        unit.slot_idx = (unit.slot_idx + 1) % len(unit.slots)
        eng = self.server.engine
        eng.set_channel(unit.rx_chan, freq_hz=unit.freq_khz * 1e3,
                        mode=demod.MODE_USB, passband=(300.0, 2700.0))
        unit.ext = ext_mod.ext_create(unit.ext_name, eng, unit.rx_chan)
        unit.ext.start()
        lprintf("autorun: ch%d alternates to %s @ %.4f kHz",
                unit.rx_chan, unit.ext_name, unit.freq_khz)

    def _park(self, unit: AutorunUnit) -> None:
        lprintf("autorun: %s yields ch%d", unit.ext_name, unit.rx_chan)
        if unit.ext is not None:
            unit.ext.stop()
        self.server.engine.ctl[unit.rx_chan].in_use = False
        unit.rx_chan, unit.ext = None, None

    def stop(self) -> None:
        for unit in self.units:
            if unit.rx_chan is not None:
                self._park(unit)

    # -- data plane --------------------------------------------------------
    def process_block(self, taps) -> None:
        """Feed every running unit; harvest decode messages as spots."""
        for unit in self.units:
            if unit.ext is None:
                continue
            msgs = unit.ext.process_block(taps)
            if msgs and len(unit.slots) > 1:
                # a capture cycle completed (status/decodes emitted):
                # rotate to the alternate decoder/dial on this channel
                self._rotate(unit)
            for tag, payload in msgs:
                if not tag.endswith("_decode"):
                    continue
                spot = dict(
                    t=time.time(), ext=unit.ext_name,
                    dial_khz=unit.freq_khz,
                    text=payload.decode("utf-8", "ignore"))
                self.spots.append(spot)
                self.spots = self.spots[-500:]
                lprintf("autorun spot: %s %.4f kHz: %s", unit.ext_name,
                        unit.freq_khz, spot["text"])
                if self.upload is not None:
                    try:
                        self.upload(spot)
                    except Exception as e:  # noqa: BLE001 — an
                        # upload bug must not take down the serving
                        # block loop
                        lprintf("spot upload failed: %s", e)
                else:
                    # wsprnet/PSKReporter upload requires egress;
                    # gated off in this environment (like services.py)
                    self.uploads_gated += 1
