"""FFT extension — audio/IQ spectrum + integration display.

Reference: `extensions/FFT/fft.cpp` + the SND-loop audio FFT tap
(`rx/rx_sound.cpp:175-220` specAF_FFT, 1024-pt).  Port of
:mod:`flydog_sdr_gps_tpu.extensions.audio_fft`: a Hann-windowed
spectrum of the last 1024 post-AGC IQ samples (:func:`spectrum`) in
torch on the engine's device, the dB row and its averaging on the host
as the reference makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import windows
from . import Extension, ext_register
from .capture import SideStream, engine_device

FFT_N = 1024
WINDOW = windows.window(windows.HANNING, FFT_N)


def spectrum(z: torch.Tensor) -> torch.Tensor:
    """(FFT_N,) complex64 -> (FFT_N,) float32 power, Hann-windowed,
    fftshifted (negative frequencies first), re^2 + im^2."""
    win = torch.as_tensor(WINDOW, device=z.device)
    s = torch.fft.fftshift(torch.fft.fft(z * win))
    return torch.view_as_real(s).square().sum(-1)


def iq_column(iq, ch: int, device: torch.device) -> torch.Tensor:
    """One channel's post-AGC IQ of a block as a complex64 tensor of its
    own on ``device``, from either kind of taps: the engine's (a (B, C)
    complex64 tensor) or the server's ``HostTaps`` (``.re``/``.im``
    host rows).  Never a view of the tap."""
    if isinstance(iq, torch.Tensor):
        return iq[:, ch].to(device).clone()
    re = torch.as_tensor(np.asarray(iq.re[:, ch], np.float32))
    im = torch.as_tensor(np.asarray(iq.im[:, ch], np.float32))
    return torch.complex(re, im).to(device)


@ext_register
class AudioFFTExt(Extension):
    name = "FFT"

    def start(self, **params):
        self.navg = int(params.get("navg", 1))
        self._buf = None
        self._side = SideStream()
        self._acc = np.zeros(FFT_N, np.float64)
        self._count = 0

    def process_block(self, taps) -> list:
        iq = taps.iq_post_agc
        on_card = isinstance(iq, torch.Tensor)
        dev = engine_device(self.engine, iq if on_card else None)
        with self._side.on(dev, after_current=on_card):
            z = iq_column(iq, self.rx_chan, dev)
            if self._buf is None:
                self._buf = z
                return []
            buf = torch.cat([self._buf, z])[-FFT_N:]
            self._buf = buf
            if buf.shape[0] < FFT_N:
                return []
            p = spectrum(buf).cpu().numpy()
        self._acc += p
        self._count += 1
        if self._count < self.navg:
            return []
        row = 10.0 * np.log10(self._acc / self._count + 1e-30)
        self._acc[:] = 0
        self._count = 0
        return [("fft", row.astype("<f4").tobytes())]
