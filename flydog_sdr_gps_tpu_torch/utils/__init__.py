"""Config, logging, and event-trace utilities."""

from .cfg import Config
from .log import LogRing, lprintf
from .trace import EventTrace
