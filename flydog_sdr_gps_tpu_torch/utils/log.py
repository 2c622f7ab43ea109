"""Logging: lprintf-style ring buffer + stdout/syslog mirror.

Reference: `support/printf.cpp:1-524` — `lprintf` writes to an
in-shmem ring of the last N_LOG_SAVE=256 lines (served to the admin
log tab) and mirrors to syslog; per-connection variants prefix the
channel/ip.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

N_LOG_SAVE = 256      # support/shmem.h:54-66


class LogRing:
    def __init__(self, depth: int = N_LOG_SAVE, mirror=sys.stderr):
        self.ring = collections.deque(maxlen=depth)
        self.mirror = mirror
        self._lock = threading.Lock()

    def write(self, msg: str, prefix: str = "") -> None:
        stamp = time.strftime("%H:%M:%S")
        line = f"{stamp} {prefix}{msg}"
        with self._lock:
            self.ring.append(line)
        if self.mirror:
            print(line, file=self.mirror, flush=True)

    def tail(self, n: int = 50) -> list[str]:
        with self._lock:
            return list(self.ring)[-n:]


_global = LogRing()


def lprintf(fmt: str, *args) -> None:
    _global.write(fmt % args if args else fmt)


def rcprintf(chan: int, fmt: str, *args) -> None:
    """Per-connection prefixed log (`rcprintf`, printf.cpp)."""
    _global.write(fmt % args if args else fmt, prefix=f"rx{chan}: ")


def get_log() -> LogRing:
    return _global
