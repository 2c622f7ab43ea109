"""Client-side / preset extensions.

Several reference extensions have no server-side DSP at all — their
`ext_register()` entry just names a JS bundle (`extensions/ext.cpp`
registry): **colormap**, **iframe**, **prefs**, **devl**, **example**,
and **waterfall** (the scope view).  **digi_modes** is a preset layer
over the FSK machinery; **s4285** (MIL-STD PSK modem) and **DRM**
register here as placeholders pending their decoder families.

They are registered here so the EXT-stream inventory matches the
reference's; each serves whatever tiny server behavior it has
(preference storage, preset application).
"""

from __future__ import annotations

import json

from . import Extension, ext_register
from .fsk import FskExt


# waterfall palettes (the reference ships these in the colormap
# extension's JS, `web/extensions/colormap/`; control points follow
# the well-known public schemes — kiwi/CuteSDR default, greyscale,
# and a linear "turbo-like" ramp); the client interpolates to 256
_COLORMAPS = {
    "default": [[0, 0, 0], [0, 0, 96], [0, 64, 160], [0, 160, 96],
                [192, 192, 0], [224, 64, 0], [255, 64, 64],
                [255, 255, 255]],
    "grey": [[0, 0, 0], [255, 255, 255]],
    "inverted grey": [[255, 255, 255], [0, 0, 0]],
    "linear": [[16, 16, 64], [48, 48, 160], [0, 160, 208],
               [64, 208, 96], [240, 224, 48], [255, 96, 32],
               [255, 255, 255]],
    "night": [[0, 0, 0], [32, 0, 48], [96, 0, 96], [192, 48, 64],
              [255, 160, 64], [255, 255, 192]],
}


@ext_register
class ColormapExt(Extension):
    """Waterfall palette chooser: serves named colormap control-point
    tables; the client rebuilds its LUT from the selection."""
    name = "colormap"

    def command(self, cmd: dict) -> list:
        if "list" in cmd:
            return [("colormap_list",
                     json.dumps(sorted(_COLORMAPS)).encode())]
        if "get" in cmd:
            name = str(cmd.get("get", "default"))
            table = _COLORMAPS.get(name, _COLORMAPS["default"])
            return [("colormap", json.dumps(
                {"name": name, "stops": table}).encode())]
        return []


@ext_register
class IframeExt(Extension):
    """Client-side only (admin-configured embedded page)."""
    name = "iframe"

    def command(self, cmd: dict) -> list:
        if "get" in cmd:
            url = ""
            cfg = getattr(self.engine, "cfg", None)
            if cfg is not None:
                url = cfg.string("iframe_url", "")
            return [("iframe", url.encode())]
        return []


@ext_register
class PrefsExt(Extension):
    """Per-user preference storage (`extensions/prefs`)."""
    name = "prefs"

    _store: dict = {}

    def command(self, cmd: dict) -> list:
        if "set" in cmd and "key" in cmd:
            self._store[cmd["key"]] = cmd.get("value", "")
            return [("prefs", b"ok")]
        if "get" in cmd and "key" in cmd:
            return [("prefs",
                     str(self._store.get(cmd["key"], "")).encode())]
        if "export" in cmd:
            return [("prefs", json.dumps(self._store).encode())]
        return []


@ext_register
class ExampleExt(Extension):
    """The reference's skeleton extension (`extensions/example`)."""
    name = "example"

    def command(self, cmd: dict) -> list:
        return [("example", b"pong")] if "ping" in cmd else []


@ext_register
class DevlExt(Extension):
    """Developer scratch extension (`extensions/devl`): exposes the
    event-trace ring and the last spans for live profiling."""
    name = "devl"

    def command(self, cmd: dict) -> list:
        if "trace" in cmd:
            from ..utils.trace import get_trace
            tr, n = get_trace(), int(cmd.get("n", 50))
            dump = "\n".join(tr.dump(n) + tr.dump_spans(n))
            return [("trace", dump.encode())]
        return []


@ext_register
class WaterfallScopeExt(Extension):
    """`extensions/waterfall` — integrate/average scope over the
    channel spectrum (the reference's WF ext adds averaging and
    peak-hold over the same data).  Serves averaged audio-FFT rows
    on the standard "fft" tag (the client's spectrum panel renders
    them); ``avg=N`` sets the integration depth, ``peak=1`` switches
    to peak-hold."""
    name = "waterfall"

    def start(self, **params):
        from .audio_fft import AudioFFTExt
        self._fft = AudioFFTExt(self.engine, self.rx_chan)
        self._fft.start(navg=int(params.get("avg", 8)))
        self._peak = params.get("peak", "0") in ("1", "true")
        self._hold = None

    def process_block(self, taps) -> list:
        import numpy as np
        out = []
        for tag, payload in self._fft.process_block(taps):
            row = np.frombuffer(payload, "<f4")
            if self._peak:
                self._hold = (row if self._hold is None
                              else np.maximum(self._hold, row))
                row = self._hold
            out.append(("fft", row.astype("<f4").tobytes()))
        return out

    def command(self, cmd: dict) -> list:
        if "avg" in cmd or "peak" in cmd:
            self.start(**cmd)
            return [("waterfall", b"ok")]
        return []


@ext_register
class DigiModesExt(FskExt):
    """`extensions/digi_modes` — preset center/shift/baud bundles over
    the FSK demodulator (CW/RTTY/SITOR/ALE presets on the client)."""
    name = "digi_modes"

    PRESETS = {
        "rtty45": dict(center=1000.0, shift=170.0, baud=45.45),
        "rtty50": dict(center=1000.0, shift=170.0, baud=50.0),
        "rtty75": dict(center=1000.0, shift=450.0, baud=75.0),
        "sitorb": dict(center=1000.0, shift=170.0, baud=100.0),
    }

    def command(self, cmd: dict) -> list:
        preset = cmd.get("preset")
        if preset in self.PRESETS:
            self.start(**self.PRESETS[preset])
            return [("digi", preset.encode())]
        return super().command(cmd)
