"""DX label database — frequency annotations served to clients.

Reference: `init/dx.cpp:1-882` — `dx.json` holds an array of labels
(freq kHz, mode, ident, notes, optional filter params), kept sorted by
frequency, edited live from the UI ("SET DX_UPD ..."), plus the
built-in EiBi shortwave-schedule database (`pkgs/EiBi`).

Same storage model: a JSON file of entries, sorted queries by range,
add/update/delete with a change sequence for client resync.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import threading


@dataclasses.dataclass
class DxLabel:
    freq_khz: float
    mode: str = "am"
    ident: str = ""
    notes: str = ""
    low_cut: int = 0
    high_cut: int = 0
    offset: int = 0

    def to_json(self) -> list:
        # reference stores [freq, mode, ident, notes, {opts}]
        return [self.freq_khz, self.mode, self.ident, self.notes,
                {"lo": self.low_cut, "hi": self.high_cut,
                 "o": self.offset}]

    @classmethod
    def from_json(cls, row) -> "DxLabel":
        opts = row[4] if len(row) > 4 and isinstance(row[4], dict) else {}
        return cls(freq_khz=float(row[0]), mode=str(row[1]),
                   ident=str(row[2]),
                   notes=str(row[3]) if len(row) > 3 else "",
                   low_cut=int(opts.get("lo", 0)),
                   high_cut=int(opts.get("hi", 0)),
                   offset=int(opts.get("o", 0)))


class DxDatabase:
    def __init__(self, path: str | None = None):
        self.path = path
        self.labels: list[DxLabel] = []
        self.seq = 0
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            self.load()

    def load(self) -> None:
        with open(self.path) as f:
            doc = json.load(f)
        rows = doc.get("dx", doc) if isinstance(doc, dict) else doc
        with self._lock:
            self.labels = sorted((DxLabel.from_json(r) for r in rows),
                                 key=lambda l: l.freq_khz)
            self.seq += 1

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            doc = {"dx": [l.to_json() for l in self.labels]}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    # -- queries / edits -------------------------------------------------
    def in_range(self, lo_khz: float, hi_khz: float) -> list[DxLabel]:
        """Labels within [lo, hi] kHz — the waterfall-span query the
        client issues on every zoom/pan (`rx/rx_cmd.cpp` CMD_MARKER)."""
        with self._lock:
            keys = [l.freq_khz for l in self.labels]
            i = bisect.bisect_left(keys, lo_khz)
            j = bisect.bisect_right(keys, hi_khz)
            return list(self.labels[i:j])

    def upsert(self, label: DxLabel) -> None:
        with self._lock:
            self.labels = [l for l in self.labels
                           if not (abs(l.freq_khz - label.freq_khz) < 1e-6
                                   and l.ident == label.ident)]
            bisect.insort(self.labels, label,
                          key=lambda l: l.freq_khz)
            self.seq += 1

    # -- gid-addressed ops (the wire protocol addresses labels by their
    #    index in frequency-sorted order — `rx/rx_cmd.cpp` DX_UPD g=) --
    def in_range_gid(self, lo_khz: float, hi_khz: float
                     ) -> list[tuple[int, DxLabel]]:
        """(gid, label) pairs within [lo, hi] kHz."""
        with self._lock:
            keys = [l.freq_khz for l in self.labels]
            i = bisect.bisect_left(keys, lo_khz)
            j = bisect.bisect_right(keys, hi_khz)
            return [(g, self.labels[g]) for g in range(i, j)]

    def update_gid(self, gid: int, label: DxLabel) -> None:
        """gid < 0 or out of range adds; otherwise replaces in place
        (then re-sorts, since the edit may move the frequency)."""
        with self._lock:
            if 0 <= gid < len(self.labels):
                self.labels[gid] = label
                self.labels.sort(key=lambda l: l.freq_khz)
            else:
                bisect.insort(self.labels, label,
                              key=lambda l: l.freq_khz)
            self.seq += 1

    def delete_gid(self, gid: int) -> int:
        with self._lock:
            if 0 <= gid < len(self.labels):
                del self.labels[gid]
                self.seq += 1
                return 1
            return 0

    def delete(self, freq_khz: float, ident: str = "") -> int:
        with self._lock:
            before = len(self.labels)
            self.labels = [
                l for l in self.labels
                if not (abs(l.freq_khz - freq_khz) < 1e-6 and
                        (not ident or l.ident == ident))]
            removed = before - len(self.labels)
            if removed:
                self.seq += 1
            return removed


def filter_match(label: DxLabel, ident_sub: str, notes_sub: str,
                 case: bool = False, wild: bool = False,
                 grep: bool = False) -> bool:
    """DX label filter ("SET DX_FILTER i= n= c= w= g=",
    `rx/rx_cmd.cpp:1063-1110`): substring by default, shell wildcard
    when ``wild``, regex when ``grep``; ``case`` selects sensitivity.
    Empty patterns match everything.
    """
    import fnmatch
    import re

    def one(pat: str, text: str) -> bool:
        if not pat:
            return True
        if not case:
            pat, text = pat.lower(), text.lower()
        if grep:
            try:
                return re.search(pat, text) is not None
            except re.error:
                return False
        if wild:
            return fnmatch.fnmatchcase(text, pat if "*" in pat or
                                       "?" in pat else f"*{pat}*")
        return pat in text

    return one(ident_sub, label.ident) and one(notes_sub, label.notes)
