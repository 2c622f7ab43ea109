"""GPS-disciplined ADC clock recovery.

Reference (`init/clk.cpp:117-275` `clock_correction()`): each position
solution yields (GPS time, 48-bit ADC tick count); the ratio of tick
deltas to GPS time deltas measures the true ADC clock.  Outliers are
rejected against the previous estimate, then a 32-period modified
moving average smooths to well under 1 ppm; the corrected clock
retunes every DDC NCO (`rx/rx_sound.cpp:334-344`).
"""

from __future__ import annotations

import dataclasses

from ...numerology import ADC_CLOCK_NOM


@dataclasses.dataclass
class ClockDiscipline:
    nominal_hz: float = ADC_CLOCK_NOM
    mma_periods: int = 32           # init/clk.cpp:152-199
    outlier_ppm: float = 50.0       # reject beyond crystal tolerance

    adc_clock_hz: float = 0.0
    _mma: float = 0.0
    _count: int = 0
    _last_gps_t: float | None = None
    _last_ticks: int | None = None

    def __post_init__(self):
        self.adc_clock_hz = self.nominal_hz

    def update(self, gps_time_s: float, ticks48: int) -> float:
        """Feed one (GPS time, tick count) pair; returns current clock."""
        if self._last_gps_t is not None:
            dt = gps_time_s - self._last_gps_t
            dticks = (ticks48 - self._last_ticks) % (1 << 48)
            if dt > 0:
                meas = dticks / dt
                # Outliers are judged against the current estimate once
                # we have one (`init/clk.cpp:205-263` windows against
                # the previous value); before that accept anything
                # within a broad crystal tolerance of nominal.
                ref = self._mma if self._count else self.nominal_hz
                limit = self.outlier_ppm if self._count else 500.0
                err_ppm = abs(meas - ref) / ref * 1e6
                if err_ppm < limit:
                    if self._count == 0:
                        self._mma = meas
                    else:
                        n = min(self._count, self.mma_periods)
                        self._mma += (meas - self._mma) / (n + 1)
                    self._count += 1
                    self.adc_clock_hz = self._mma
        self._last_gps_t = gps_time_s
        self._last_ticks = ticks48
        return self.adc_clock_hz

    @property
    def locked(self) -> bool:
        return self._count >= 4

    @property
    def correction_ppm(self) -> float:
        return (self.adc_clock_hz - self.nominal_hz) / \
            self.nominal_hz * 1e6
