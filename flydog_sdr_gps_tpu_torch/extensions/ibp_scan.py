"""IBP_scan extension — International Beacon Project monitor.

Reference: `extensions/IBP_scan/` — steps the channel through the five
IBP beacon frequencies in sync with the 10-second/18-slot transmission
schedule and reports S-meter per (beacon, band) so propagation can be
mapped.
"""

from __future__ import annotations

import time

from . import Extension, ext_register
from .taps import host_smeter

IBP_FREQS_KHZ = (14100.0, 18110.0, 21150.0, 24930.0, 28200.0)
IBP_CALLS = ("4U1UN", "VE8AT", "W6WX", "KH6RS", "ZL6B", "VK6RBP",
             "JA2IGY", "RR9O", "VR2B", "4S7B", "ZS6DN", "5Z4B",
             "4X6TU", "OH2B", "CS3B", "LU4AA", "OA4B", "YV5B")
SLOT_S = 10.0


@ext_register
class IbpScanExt(Extension):
    name = "IBP_scan"

    def start(self, **params):
        self.band = int(params.get("band", 0)) % len(IBP_FREQS_KHZ)
        self.scan_bands = bool(int(params.get("scan", 0)))
        self._last_slot = -1
        self.readings: list[dict] = []
        self._tune()

    def _tune(self):
        self.engine.set_channel(self.rx_chan,
                                freq_hz=IBP_FREQS_KHZ[self.band] * 1e3)

    def process_block(self, taps) -> list:
        now = time.time()
        slot = int(now // SLOT_S) % len(IBP_CALLS)
        out = []
        dbm = host_smeter(taps.smeter_dbm, self.rx_chan)
        if slot != self._last_slot:
            self._last_slot = slot
            if self.scan_bands:
                self.band = (self.band + 1) % len(IBP_FREQS_KHZ)
                self._tune()
            reading = dict(call=IBP_CALLS[slot],
                           freq_khz=IBP_FREQS_KHZ[self.band],
                           dbm=round(dbm, 1), t=int(now))
            self.readings.append(reading)
            self.readings = self.readings[-180:]
            out.append(("ibp", (f"{reading['call']} "
                                f"{reading['freq_khz']:.0f} "
                                f"{reading['dbm']:.1f}").encode()))
        return out
