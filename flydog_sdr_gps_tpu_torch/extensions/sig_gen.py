"""sig_gen extension — built-in signal generator control.

Reference: `extensions/sig_gen/sig_gen.cpp` + the FPGA DDS generator
(`verilog/rx/gen.v`, `receiver.v:149-180`): substitutes a programmable
tone for the ADC input on channel 0 for self-test and S-meter /
waterfall calibration (0 dBm at 0 dB attn, `rx_waterfall.cpp:893-903`).

Here: drives the engine's synthetic source — add/replace a tone
at a commanded frequency/level.  Works with both host and device
sources.
"""

from __future__ import annotations

from . import Extension, ext_register


@ext_register
class SigGenExt(Extension):
    name = "sig_gen"

    def start(self, **params):
        self.freq = float(params.get("freq", 10.0e6))
        self.amp = float(params.get("amp", 0.5))

    def command(self, cmd: dict) -> list:
        if "freq" in cmd:
            self.freq = float(cmd["freq"])
        if "amp" in cmd:
            self.amp = float(cmd["amp"])
        src = self.engine.source
        if hasattr(src, "tones"):
            src.tones = [(self.freq, self.amp)]
            return [("gen", b"ok")]
        return [("gen", b"unsupported source")]
