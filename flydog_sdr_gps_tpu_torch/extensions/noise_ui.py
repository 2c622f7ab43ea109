"""noise_blank / noise_filter extensions — UI control surfaces.

Reference: `extensions/noise_blank/` and `extensions/noise_filter/`
are thin client UIs that flip the per-channel NB/NR processing in the
sound path (`rx/rx_sound.cpp:910-948`); the DSP lives in `ops/noise`.
"""

from __future__ import annotations

from . import Extension, ext_register


@ext_register
class NoiseBlankExt(Extension):
    name = "noise_blank"

    def command(self, cmd: dict) -> list:
        if "nb_algo" in cmd or "enable" in cmd:
            on = str(cmd.get("enable", "1")) in ("1", "true")
            self.engine.set_channel(self.rx_chan, nb_on=on)
            return [("nb", b"1" if on else b"0")]
        return []


@ext_register
class NoiseFilterExt(Extension):
    name = "noise_filter"

    def command(self, cmd: dict) -> list:
        if "nr_algo" in cmd or "enable" in cmd:
            on = str(cmd.get("enable", "1")) in ("1", "true")
            self.engine.set_channel(self.rx_chan, nr_on=on)
            return [("nr", b"1" if on else b"0")]
        return []
