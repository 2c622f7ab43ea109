"""System numerology — the frequency plan and channel counts of the receiver.

The port's own copy of :mod:`flydog_sdr_gps_tpu.numerology` (standard
library only; the port imports nothing of the reference package).

These mirror the reference's generated constants (`verilog/kiwi.gen.vh`,
produced by the e_cpu assembler from `kiwi.config`) that define WHAT the
system does; the HOW (CIC bit growth, SPI buffer sizes, ...) is replaced
by the accelerator design and intentionally not reproduced.

Reference sources:
- ADC: 125 MHz, 16-bit           (`init/clk.h:29`, kiwi.gen.vh ADC_BITS=16)
- audio rates / decimations      (kiwi.gen.vh SND_RATE_*, RX_DECIM_*)
- firmware configs rx4/rx8/rx3/rx14 (`main.cpp:346-395`)
- NCO: 48-bit phase accumulator  (`verilog/rx/rx.v:44`)
- waterfall: 8192-pt FFT, zoom 0..14 (kiwi.gen.vh NWF_FFT, MAX_ZOOM)
- GPS: 12 channels, 16.368 Msps 1-bit IF, fc=4.092 MHz (`gps/gps.h:41-46`)
"""

from __future__ import annotations

import dataclasses

# --- ADC / RF front end ----------------------------------------------------
ADC_CLOCK_NOM = 125.000_000e6   # nominal ADC clock, Hz (init/clk.h:29)
ADC_CLOCK_TYP = 124.982_400e6   # typical GPS-corrected value (init/clk.h:31)
ADC_BITS = 16
UI_SRATE_30M = 30.0e6           # displayed RF span (rx/rx_init.cpp:150)
UI_SRATE_32M = 32.0e6

# --- NCO -------------------------------------------------------------------
PHASE_BITS = 48                 # verilog/rx/rx.v:44; rx/rx_sound_cmd.cpp:86-87

# --- audio DDC -------------------------------------------------------------
SND_RATE_12K = 12_000           # nominal; true rate = adc_clock / RX_DECIM
SND_RATE_20K = 20_250
RX_DECIM_12K = 10_416           # = 1736(CIC1) * 3(CIC2) * 2(FIR)  [12 kHz]
RX_DECIM_20K = 6_172            # 20.25 kHz firmware
# Audio network block: reference FastFIR emits 512-sample bursts
# (rx/CuteSDR/cuteSDR.h:12-14); we use the same audio block quantum.
AUDIO_BLOCK = 512

# --- waterfall -------------------------------------------------------------
WF_FFT = 8192                   # kiwi.gen.vh NWF_FFT
WF_OUT_PX = 1024                # pixels per row sent to client
MAX_ZOOM = 14                   # decimation 2**zoom, 1..16384
WF_SPEEDS_FPS = (1, 10, 17, 23)  # rx/rx_waterfall.cpp:71-72 (slow..fast)

# --- GPS -------------------------------------------------------------------
GPS_FS = 16.368e6               # 1-bit IF sample rate (gps/gps.h:41-46)
GPS_FC = 4.092e6                # IF center frequency
GPS_ACQ_FS = 4.092e6            # decimate-by-4 rate used for acquisition
GPS_ACQ_FFT = 16384             # gps/gps.h:66-81 (FFT_LEN = 65536/4)
GPS_MAX_CHANS = 12              # kiwi.gen.vh GPS_MAX_CHANS
GPS_RX14_CHANS = 10
L1_CODELEN = 1023               # C/A code chips
E1B_CODELEN = 4092              # Galileo E1B memory code chips
CA_CHIP_RATE = 1.023e6
E1B_CHIP_RATE = 1.023e6         # BOC(1,1) on E1B; 4092 chips / 4 ms
GALILEO_PRN_BASE = 210          # internal PRN offset for E1B SV ids
                                # (Navstar 1-32, SBAS 120-140, QZSS
                                # 193-199; Galileo E1B 1-36 -> 211-246)
GPS_DOPPLER_MAX = 5_000.0       # Hz search range (gps/search.cpp)
GPS_DOPPLER_STEP = 250.0        # Hz bin width -> 41 bins
MAX_NAV_BITS = 128

# --- firmware-style configurations ----------------------------------------
@dataclasses.dataclass(frozen=True)
class RxConfig:
    """One 'bitstream' configuration of the reference (`main.cpp:346-395`)."""
    name: str
    rx_chans: int               # audio DDC channels
    wf_chans: int               # waterfall DDC channels
    snd_rate: int               # nominal audio sample rate, Hz
    rx_decim: int               # total audio decimation from ADC rate
    gps_chans: int = GPS_MAX_CHANS


RX4_WF4 = RxConfig("rx4.wf4", 4, 4, SND_RATE_12K, RX_DECIM_12K)
RX8_WF2 = RxConfig("rx8.wf2", 8, 2, SND_RATE_12K, RX_DECIM_12K)
RX3_WF3 = RxConfig("rx3.wf3", 3, 3, SND_RATE_20K, RX_DECIM_20K)
RX14_WF0 = RxConfig("rx14.wf0", 14, 0, SND_RATE_12K, RX_DECIM_12K,
                    gps_chans=GPS_RX14_CHANS)

CONFIGS = {c.name: c for c in (RX4_WF4, RX8_WF2, RX3_WF3, RX14_WF0)}

# --- accelerator-native decimation plans -----------------------------------
# The reference reaches 12 kHz via CIC1(R=1736) -> CIC2(R=3) -> FIR(R=2).
# A CIC is a hardware trick to avoid multipliers; on an accelerator
# multipliers are the cheap resource, so we use a two-stage polyphase-FIR
# plan with the same TOTAL decimation (and strictly better passband
# flatness / alias rejection).  10416 = 336 * 31; 6172 = 4 * 1543 handled
# as 1543 * 4.
DECIM_PLAN_12K = (336, 31)
DECIM_PLAN_20K = (1543, 4)
