"""FAX extension — HF WEFAX (radiofax) image decode.

Reference: `extensions/FAX/` — weather-chart broadcasts: FM subcarrier
(black 1500 Hz, white 2300 Hz) at 120 lines/minute, IOC 576; start
tone 300 Hz, phasing lines with a white pulse, then image lines.

This implementation: quadrature FM discriminator on the audio tap,
line-rate slicing with phasing alignment on the per-line sync pulse,
8-bit pixel rows streamed to the client.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column


@ext_register
class FaxExt(Extension):
    name = "FAX"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.lpm = float(params.get("lpm", 120.0))
        self.f_black = float(params.get("black", 1500.0))
        self.f_white = float(params.get("white", 2300.0))
        self.px_per_line = int(params.get("px", 512))
        self.line_samples = int(round(self.fs * 60.0 / self.lpm))
        self._carry = np.zeros(0, np.float64)
        self._phase_off: int | None = None
        self._last = 0.0 + 0.0j
        self.lines = 0

    def command(self, cmd: dict) -> list:
        """FAX panel controls (reference
        `web/extensions/FAX/FAX.js`): LPM select, pixel shift
        (manual phasing trim), re-phase."""
        out = []
        if "lpm" in cmd:
            try:
                self.lpm = float(cmd["lpm"])
            except ValueError:
                return out
            self.line_samples = int(round(self.fs * 60.0 / self.lpm))
            self._carry = np.zeros(0, np.float64)
            self._phase_off = None
            out.append(("fax_status", f"lpm={self.lpm:g}".encode()))
        if "shift" in cmd and self._phase_off is not None:
            try:
                px = int(cmd["shift"])
            except ValueError:
                return out
            self._phase_off = (self._phase_off
                               + px * self.line_samples
                               // self.px_per_line) % self.line_samples
            out.append(("fax_status", b"shifted"))
        if "rephase" in cmd:
            self._phase_off = None
            out.append(("fax_status", b"rephasing"))
        return out

    def _freq_track(self, audio: np.ndarray) -> np.ndarray:
        """Instantaneous frequency via analytic quadrature pair."""
        t = np.arange(len(audio)) / self.fs
        f_mid = 0.5 * (self.f_black + self.f_white)
        z = audio * np.exp(-2j * np.pi * f_mid * t)
        # lowpass by short box filter to kill the 2*f image
        k = max(2, int(self.fs / f_mid))
        z = np.convolve(z, np.ones(k) / k, mode="same")
        zp = np.concatenate([[self._last], z[:-1]])
        self._last = z[-1]
        d = z * np.conj(zp)
        inst = np.angle(d) * self.fs / (2 * np.pi) + f_mid
        return inst

    def process_block(self, taps) -> list:
        audio = np.concatenate([
            self._carry,
            host_column(taps.audio, self.rx_chan, np.float64)])
        out = []
        while len(audio) >= self.line_samples:
            line, audio = (audio[:self.line_samples],
                           audio[self.line_samples:])
            inst = self._freq_track(line)
            # start-tone detection (WEFAX: the subcarrier alternates
            # black/white at 300 Hz for IOC 576, 675 Hz for IOC 288,
            # for ~5 s before the phasing lines): count luminance
            # alternations per second
            sm = np.convolve(inst, np.ones(5) / 5, "same")
            sgn = sm > 0.5 * (self.f_black + self.f_white)
            alt = int(np.sum(sgn[1:] != sgn[:-1])) * self.lpm / 60.0 \
                / 2.0
            if 250.0 <= alt <= 350.0 or 600.0 <= alt <= 750.0:
                ioc = 576 if alt < 500 else 288
                self._phase_off = None     # re-phase after start tone
                out.append(("fax_status",
                            f"start_tone ioc={ioc}".encode()))
                self.lines += 1
                continue
            # map frequency -> luminance 0..255
            lum = np.clip((inst - self.f_black)
                          / (self.f_white - self.f_black), 0, 1)
            # phasing: align on the white sync pulse (start of line)
            if self._phase_off is None:
                # sync pulse = ~5% white burst in a black bar; the
                # pulse may straddle the arbitrary line-slice
                # boundary, so smooth CIRCULARLY (a linear convolve
                # mis-centers a wrapped pulse by up to half its width)
                k = max(8, self.line_samples // 64)
                ker = np.zeros(len(lum))
                ker[:k // 2] = 1.0 / k
                ker[-(k - k // 2):] = 1.0 / k
                smoothed = np.real(np.fft.ifft(
                    np.fft.fft(lum) * np.fft.fft(ker)))
                # the pulse gives a flat-topped maximum: take the
                # CIRCULAR centroid of the near-max region (argmax
                # alone lands anywhere on the plateau)
                w = smoothed >= 0.9 * smoothed.max()
                ang = 2 * np.pi * np.arange(len(lum)) / len(lum)
                c = np.sum(w * np.exp(1j * ang))
                self._phase_off = int(round(
                    (np.angle(c) % (2 * np.pi)) / (2 * np.pi)
                    * len(lum))) % len(lum)
            lum = np.roll(lum, -self._phase_off)
            # decimate to px_per_line pixels (mean pooling)
            n = (len(lum) // self.px_per_line) * self.px_per_line
            row = lum[:n].reshape(self.px_per_line, -1).mean(axis=1)
            px = (row * 255).astype(np.uint8)
            self.lines += 1
            out.append(("fax_line", px.tobytes()))
        self._carry = audio
        return out
