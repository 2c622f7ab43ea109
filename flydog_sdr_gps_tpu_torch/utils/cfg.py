"""JSON configuration layer — kiwi.json / admin.json semantics.

Reference: `init/cfg.cpp` (1580 LoC jsmn-based tokenizer + accessors,
API `init/cfg.h:164-210`): two JSON documents (user config `kiwi.json`,
admin config `admin.json`) with typed accessors, defaults, live edits
from the admin UI, and a change sequence number broadcast to clients
so they can reload (`rx/rx_waterfall.cpp:871-876`).

Here: plain-JSON files with dotted-path typed accessors and the same
update/save/seq semantics.  Defaults merge from a dist template like
`unix_env/kiwi.config/dist.kiwi.json`.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from typing import Any

DEFAULTS: dict[str, Any] = {
    "index_html_params": {"RX_PHOTO_TITLE": "TPU SDR"},
    "rx_name": "flydog_sdr_gps_tpu",
    "rx_location": "", "rx_asl": 0, "rx_gps": "(0, 0)",
    "rx_antenna": "",
    "freq_offset": 0.0,
    "init": {"freq": 7100.0, "mode": "lsb", "zoom": 4,
             "max_dB": -10, "min_dB": -110},
    "max_freq": 0,                     # 0: 30 MHz, 1: 32 MHz
    "sb_cal": 0, "S_meter_cal": -13,
    "waterfall_cal": -13,
    "adc_clk_corr": 1,
    "chan_no_pwd": 0,
    "ext_api_nchans": -1,
    "inactivity_timeout_mins": 0,
    "ip_limit_mins": 0,
    "snr_meas_interval_hrs": 1,
}


class Config:
    """One JSON config document with typed accessors + seq tracking."""

    def __init__(self, path: str | None = None,
                 defaults: dict | None = None):
        self.path = path
        self._lock = threading.Lock()
        self.doc: dict = copy.deepcopy(
            DEFAULTS if defaults is None else defaults)
        self.seq = 0
        if path and os.path.exists(path):
            self.load()

    # -- file io --------------------------------------------------------
    def load(self) -> None:
        with open(self.path) as f:
            incoming = json.load(f)
        with self._lock:
            _deep_merge(self.doc, incoming)
            self.seq += 1

    def save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(self.doc, f, indent=1)
        os.replace(tmp, self.path)

    # -- accessors (cfg_string / cfg_int / cfg_bool analogues) ----------
    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self.doc
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def string(self, dotted: str, default: str = "") -> str:
        return str(self.get(dotted, default))

    def int(self, dotted: str, default: int = 0) -> int:
        try:
            return int(self.get(dotted, default))
        except (TypeError, ValueError):
            return default

    def float(self, dotted: str, default: float = 0.0) -> float:
        try:
            return float(self.get(dotted, default))
        except (TypeError, ValueError):
            return default

    def bool(self, dotted: str, default: bool = False) -> bool:
        v = self.get(dotted, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes")
        return bool(v)

    def set(self, dotted: str, value: Any) -> None:
        with self._lock:
            node = self.doc
            parts = dotted.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
            self.seq += 1


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
