"""flydog_sdr_gps_tpu_torch — the receiver's main path in PyTorch + CUDA.

A port of :mod:`flydog_sdr_gps_tpu` (the JAX reference, which stays
unchanged beside it) to PyTorch on an NVIDIA Hopper card.  It mirrors
the reference's layout and module names:

- ``ops``      — NCO, DDC channelizer, the stage-2 kernels, IIR, S-meter,
                 FastFIR, AGC, demods, noise blanking / reduction.
- ``models``   — the receiver block program (``rx_channel``).
- ``runtime``  — sample sources and the streaming engine.
- ``convert``  — JAX reference state/tuning (as numpy) -> port tensors.
- ``csrc``     — hand-written CUDA kernels, built at first use by
                 ``_build`` (plain ``nvcc``, loaded with ``ctypes``).

The package imports ``torch`` and never ``jax``.  Host-only modules of
the reference that import no jax (``numerology``, ``ops.filters``,
``ops.windows``) are imported from it rather than copied.

Conventions kept from the reference at every public function: signals
are time-major ``(N, C)``; 48-bit NCO phases are exact.  What changes:
complex data is ``complex64`` (not split re/im), a phase is one
``int64`` word (not three 16-bit limbs), FFTs are ``torch.fft``.
Every constructor takes an explicit ``device``; tensors on the CPU run
each kernel's plain PyTorch version, CUDA tensors run the kernel.
"""

__version__ = "0.1.0"
