"""Extension framework — signal-decoder plug-ins on channel taps.

Reference (`extensions/ext.h:55-90`, `ext.cpp`): extensions register
at startup (`ext_register()`), then per channel subscribe to sample
taps — raw pre-FIR IQ, post-FIR/post-AGC IQ, demodulated audio,
S-meter, audio FFT — invoked inline from the sound loop
(`rx/rx_sound.cpp:490-497,577-578,666-672,1105-1111`); the client side
talks to them over the EXT WebSocket stream.

Design: the block pipeline already returns every tap for ALL channels
(`models.rx_channel.RxTaps`), so an extension is just a consumer
object: ``process_block(taps) -> list of (tag, payload)`` messages for
its client.  Extensions take either kind of taps: the engine's
``RxTaps`` (device tensors) or the server's ``HostTaps`` (host rows of
the subscribed channels).  The decoders with device work (FFT, wspr,
FT8, FT4, and the waterfall scope over FFT) run their front ends in
torch on the engine's device; the other decoders are host code that
reads one column of a tap a block (:mod:`.taps`).  The registry lists
the reference's extensions in the reference's order; a client that asks
for a name neither package registers gets no reply.
"""

from __future__ import annotations

from typing import Type

_registry: dict[str, Type["Extension"]] = {}


class Extension:
    """Base class; subclasses set ``name`` and override hooks."""

    name = "example"

    def __init__(self, engine, rx_chan: int):
        self.engine = engine
        self.rx_chan = rx_chan

    # -- lifecycle -------------------------------------------------------
    def start(self, **params) -> None:
        """Client attached ('SET ext_switch_to_client=...')."""

    def stop(self) -> None:
        """Client detached."""

    def command(self, cmd: dict) -> list:
        """Handle a client SET; return [(tag, payload_bytes), ...]."""
        return []

    # -- data plane ------------------------------------------------------
    def process_block(self, taps) -> list:
        """Called once per engine block with the full RxTaps; return
        outbound messages [(tag, payload), ...]."""
        return []


def ext_register(cls: Type[Extension]) -> Type[Extension]:
    """Decorator — mirror of the reference's `ext_register()`."""
    _registry[cls.name] = cls
    return cls


def ext_list() -> list[str]:
    return sorted(_registry)


def ext_create(name: str, engine, rx_chan: int) -> Extension:
    return _registry[name](engine, rx_chan)


# built-in extensions (import order = registration order)
from . import s_meter        # noqa: E402,F401
from . import iq_display     # noqa: E402,F401
from . import audio_fft      # noqa: E402,F401
from . import cw_decoder     # noqa: E402,F401
from . import sig_gen        # noqa: E402,F401
from . import wspr           # noqa: E402,F401
from . import ft8            # noqa: E402,F401
from . import ft4            # noqa: E402,F401
from . import tdoa           # noqa: E402,F401
from . import noise_ui       # noqa: E402,F401
from . import fsk            # noqa: E402,F401
from . import navtex         # noqa: E402,F401
from . import timecode       # noqa: E402,F401
from . import ibp_scan       # noqa: E402,F401
from . import fax            # noqa: E402,F401
from . import misc_ui        # noqa: E402,F401
from . import sstv           # noqa: E402,F401
from . import loran_c        # noqa: E402,F401
from . import ale_2g         # noqa: E402,F401
from . import s4285          # noqa: E402,F401
from . import hfdl           # noqa: E402,F401
from . import drm            # noqa: E402,F401
