"""KiwiSDR-protocol server layer of the port (WebSocket streams + REST)
and the shared waterfall subsystem."""

from .kiwi_server import KiwiServer
from . import packets

__all__ = ["KiwiServer", "packets"]
