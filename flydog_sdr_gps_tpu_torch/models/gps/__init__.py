"""GPS/GNSS subsystem of the port: acquisition, tracking, nav decode, PVT,
clock.

Port of :mod:`flydog_sdr_gps_tpu.models.gps` (SURVEY.md section 2.6):
- FFT acquisition (`gps/search.cpp`) -> ``torch.fft`` over the whole
  (satellite, Doppler) plane on the card (``acquisition``, ``galileo``).
- FPGA correlator bank + e_cpu tracking ISR (`verilog/gps/demod.v`,
  `e_cpu/kiwi.gps.asm`) -> the CUDA kernel ``gps_track_f32``, one block
  a row, the 1 ms epochs in a loop inside it (``tracking``).
- The synthetic sky (``scene``): per-epoch coefficients on the host in
  float64, the per-sample synthesis on the card.
- Nav decode / ephemeris / position solve / clock discipline
  (``ephemeris``, ``galileo``, ``solver``, ``clock``, ``cacode``,
  ``e1b_codes``): host numpy, the port's own copies of the reference's
  modules.
- ``manager``: the `gps_main()` state machine around all of it.
"""

from . import cacode  # noqa: F401
