"""In-process listeners and the general traffic generator.

A traffic mix (``traffic/<name>.json``) lists groups of SND listeners,
each as the SET commands a KiwiSDR client sends, and the W/F sockets.
:func:`expand` turns it into one command list a socket, and
:func:`tuning_of` reads back from those commands what the reference
needs to know of a lane (its tuning, its wire format, its NR), with the
protocol's own semantics.  :class:`Sock` is the socket: it stamps the
arrival of every packet on the host's monotonic clock.
"""

from __future__ import annotations

import time

from .reference import design as dz

AUTH = "SET auth t=kiwi p="


class Sock:
    """What a connection asks of a socket (``send_bytes``, ``closed``,
    ``close``), keeping (arrival time, bytes) of every packet."""

    def __init__(self):
        self.sent: list[tuple[float, bytes]] = []
        self.closed = False

    async def send_bytes(self, data) -> None:
        self.sent.append((time.monotonic(), bytes(data)))

    async def close(self) -> None:
        self.closed = True

    def of(self, tag: bytes) -> list[tuple[float, bytes]]:
        return [(t, p) for t, p in self.sent if p[:len(tag)] == tag]


def _freq(spec, i: int) -> float:
    if isinstance(spec, list):
        return float(spec[0]) + i * float(spec[1])
    return float(spec)


def expand(mix: dict) -> tuple[list[dict], list[dict]]:
    """([{"what", "cmds"}] a SND listener, [{"zoom", "centre_hz",
    "cmds"}] a W/F socket) of a mix."""
    snd = []
    for g in mix["listeners"]:
        for i in range(int(g.get("count", 1))):
            tune = (f"SET mod={g['mod']} low_cut={g['low_cut']} "
                    f"high_cut={g['high_cut']} "
                    f"freq={_freq(g['freq_khz'], i):.3f}")
            cmds = [AUTH, tune]
            comp = g.get("compression")
            if comp == "alternate":
                comp = i % 2
            if comp is not None:
                cmds.append(f"SET compression={int(comp)}")
            if g.get("little_endian"):
                cmds.append("SET little-endian")
            cmds += list(g.get("extra", []))
            snd.append(dict(what=f"{g['what']} {i}" if g.get("count", 1) > 1
                            else g["what"], cmds=cmds))
    wfs = []
    speed = int(mix.get("wf_speed", 4))
    for w in mix.get("waterfall", []):
        z = int(w["zoom"])
        start = 0 if z == 0 else dz.wf_start_bin(z, float(w["centre_hz"]))
        wfs.append(dict(zoom=z, start=start,
                        centre_hz=dz.wf_centre(z, start),
                        cmds=[AUTH, f"SET zoom={z} start={start}",
                              f"SET wf_speed={speed}"]))
    return snd, wfs


def parse_set(text: str) -> dict:
    parts = text.split()[1:]
    out = {"_cmd": parts[0].split("=")[0] if parts else ""}
    for tok in parts:
        k, _, v = tok.partition("=")
        out[k] = v if _ else True
    return out


def tuning_of(cmds: list[str]) -> dict:
    """The lane a listener's commands ask for: frequency (Hz), mode,
    passband, wire format ("s16", "adpcm" or "iq"), byte order and NR
    switches, as the protocol defines each command."""
    st = dict(freq_khz=7100.0, mode="lsb", passband=None, compression=True,
              little_endian=False, nr_algo=0, nr_notch=False, nr_den=False,
              nr_spectral=False)
    for text in cmds:
        p = parse_set(text)
        cmd = p["_cmd"]
        if cmd == "mod":
            st["mode"] = p.get("mod", "usb")
            st["passband"] = (float(p.get("low_cut", -4000)),
                              float(p.get("high_cut", 4000)))
            st["freq_khz"] = float(p.get("freq", st["freq_khz"]))
        elif cmd == "compression":
            st["compression"] = p.get("compression", "1") in ("1", "true")
        elif cmd == "little-endian":
            st["little_endian"] = True
        elif cmd == "nr":
            if "algo" in p:
                st["nr_algo"] = int(p["algo"])
                st["nr_notch"] = st["nr_den"] = st["nr_spectral"] = False
            elif "type" in p and "en" in p:
                en = p["en"] in ("1", "true")
                if int(p["type"]) == 1:
                    st["nr_notch"] = en
                elif st["nr_algo"] == 3:
                    st["nr_spectral"] = en
                else:
                    st["nr_den"] = en
    mode = st["mode"]
    kind = ("iq" if mode in ("iq", "drm")
            else "adpcm" if st["compression"] else "s16")
    return dict(freq_hz=st["freq_khz"] * 1e3, mode=mode,
                passband=st["passband"] or dz.default_passband(mode),
                kind=kind, little_endian=st["little_endian"],
                nr_notch=st["nr_notch"], nr_den=st["nr_den"],
                nr_spectral=st["nr_spectral"])
