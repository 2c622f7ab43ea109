"""EiBi shortwave-schedule database loader.

Reference: `pkgs/EiBi/` ships the EiBi HF broadcast/utility schedule
(semicolon CSV, one row per transmission:
``kHz;Time(UTC);Days;ITU;Station;Lng;Target;Remarks;P;Start;Stop``),
preprocessed by `pkgs/EiBi/eibi_proc.cpp` into `EiBi.h` and merged
into the DX label layer by `init/dx.cpp:768-800` (dx_eibi_init).

Here the CSV parses directly into :class:`~.dx.DxLabel` rows; a
converted snapshot ships as ``flydog_sdr_gps_tpu_torch/data/eibi.json``
(DATA, not code: the EiBi list is Eike Bierwirth's freely
redistributable schedule, via the reference's
`pkgs/EiBi/sked-current.csv`) so a fresh install shows thousands of
real station labels instead of three synthetic ones.
"""

from __future__ import annotations

import json
import os

from .dx import DxDatabase, DxLabel

DATA_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "eibi.json")


# band table from the reference's `pkgs/EiBi/eibi_proc.cpp:116-160`
# (itself derived from dist.config.js, widened to fit EiBi data)
_BCAST_BANDS = (
    (153, 280), (525, 1710), (2300, 2495), (3185, 3400), (3900, 4000),
    (4750, 5060), (5130, 5150), (5850, 6210), (7200, 7800),
    (9300, 9900), (11550, 12150), (13570, 13870), (15000, 15800),
    (17480, 17900), (18900, 19020), (21450, 21850), (25600, 26100))
_MARINE_BANDS = (
    (505, 527), (2172, 2190), (4063, 4438), (6200, 6525),
    (8195, 8815), (12230, 13200), (22000, 22855), (25070, 25121))
_AERO_BANDS = (
    (2850, 3155), (3400, 3500), (3900, 3950), (4650, 4750),
    (5450, 5730), (6525, 6765), (8815, 9040), (10005, 10100),
    (11175, 11400), (13200, 13360), (15010, 15100), (17900, 18030),
    (21924, 22000))


def _band_of(freq_khz: float) -> str:
    for lo, hi in _BCAST_BANDS:
        if lo <= freq_khz <= hi:
            return "bcast"
    for lo, hi in _MARINE_BANDS:
        if lo <= freq_khz <= hi:
            return "marine"
    for lo, hi in _AERO_BANDS:
        if lo <= freq_khz <= hi:
            return "aero"
    return "none"


def classify(freq_khz: float, station: str, lang: str
             ) -> tuple[str, str]:
    """(type, mode) per the reference's explicit EiBi classification
    (`pkgs/EiBi/eibi_proc.cpp:379-459`): ident keywords first, then
    the language-column type markers (-MX/-HF/-CW/-TY/-EC/-TS), then
    band membership; everything left is a USB utility."""
    s = station
    lang = lang.strip()
    band = _band_of(freq_khz)
    if "ALE" in s:
        return "ale", "usb"
    if "RTTY" in s or "FSK" in s:
        return "fsk", "cw"
    if ("STANAG" in s or "Ny" in s or "Navy" in s or "SECURE" in s
            or "Air Force" in s):
        return "milcom", "usb"
    if "Fax" in s:
        return "fax", "usb"
    if "Spy" in s or "Numbers" in s:
        return "spy", "usb"
    if ("Marine" in s or "Maritime" in s or "Coastguard" in s
            or "Harbor" in s):
        return "marine", "usb"
    if "Volmet" in s or "Aero" in s or "Aeradio" in s:
        return "aero", "usb"
    if " Radio" in s and band != "bcast":
        return (("marine", "usb") if band == "marine"
                else ("aero", "usb"))
    if lang == "-MX" or lang == "-EC":
        return "bcast", "am"
    if lang == "-HF":
        return "hfdl", "iq"
    if lang == "-CW":
        return "cw", "cw"
    if lang == "-TY":
        return "fsk", "cw"
    if lang == "-TS":
        # time stations: narrow AM except the LF carriers the
        # timecode extension reads as CW-class signals
        if freq_khz <= 162:
            if "DCF77" in s or "RBU" in s:
                return "time", "cw"
            return "time", "cwn"
        if "RWM" in s:
            return "time", "cwn"
        return "time", "amn"
    if "Marker" in s:
        return "util", "usb"
    if band == "bcast" or "Voice of" in s:
        return "bcast", "am"
    if band == "marine":
        return "marine", "usb"
    return "util", "usb"


def _mode_of(station: str, remarks: str, freq_khz: float = 10000.0,
             lang: str = "") -> str:
    """Back-compat shim over :func:`classify`."""
    return classify(freq_khz, station, lang)[1]


def parse_csv(path: str, max_rows: int | None = None) -> list[DxLabel]:
    """Parse an EiBi kiwi-format CSV into labels (header skipped)."""
    out = []
    # current files are UTF-8; older seasons were latin-1
    with open(path, "rb") as f:
        raw = f.read()
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        text = raw.decode("latin-1")
    import io
    with io.StringIO(text) as f:
        for ln in f:
            parts = ln.rstrip("\n").split(";")
            if len(parts) < 5:
                continue
            try:
                freq = float(parts[0])
            except ValueError:
                continue                      # header row
            time_utc, days = parts[1], parts[2]
            station = parts[4].strip()
            lang = parts[5].strip() if len(parts) > 5 else ""
            target = parts[6].strip() if len(parts) > 6 else ""
            notes = time_utc
            if days:
                notes += " " + days
            if target:
                notes += " → " + target
            _dtype, mode = classify(freq, station, lang)
            out.append(DxLabel(freq_khz=freq, mode=mode,
                               ident=station, notes=notes))
            if max_rows and len(out) >= max_rows:
                break
    out.sort(key=lambda l: l.freq_khz)
    return out


def convert_csv_to_json(csv_path: str, json_path: str = DATA_JSON
                        ) -> int:
    labels = parse_csv(csv_path)
    os.makedirs(os.path.dirname(json_path), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump({"dx": [l.to_json() for l in labels]}, f,
                  separators=(",", ":"))
    return len(labels)


def load_builtin(db: DxDatabase) -> int:
    """Merge the shipped snapshot into ``db`` (keeps user labels);
    returns the number of EiBi labels added (0 if no snapshot)."""
    if not os.path.exists(DATA_JSON):
        return 0
    with open(DATA_JSON) as f:
        rows = json.load(f)["dx"]
    labels = [DxLabel.from_json(r) for r in rows]
    with db._lock:
        db.labels = sorted(db.labels + labels,
                           key=lambda l: l.freq_khz)
        db.seq += 1
    return len(labels)
