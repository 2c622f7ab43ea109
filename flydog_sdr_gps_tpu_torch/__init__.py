"""flydog_sdr_gps_tpu_torch — the receiver's main path in PyTorch + CUDA.

A port of :mod:`flydog_sdr_gps_tpu` (the JAX reference, which stays
unchanged beside it) to PyTorch on an NVIDIA Hopper card.  It mirrors
the reference's layout and module names:

- ``ops``      — NCO, DDC channelizer, the stage-2 kernels, IIR, S-meter,
                 FastFIR, AGC, demods, noise blanking / reduction,
                 filter and window design.
- ``models``   — the receiver block program (``rx_channel``) and the
                 waterfall (``waterfall``).
- ``runtime``  — sample sources and the streaming engine (block loop,
                 the serving path's packed gather and fetch,
                 checkpointing).
- ``server``   — the KiwiSDR-protocol server (``kiwi_server``: SND and
                 W/F WebSocket streams, the REST endpoints, the admin
                 socket, the embedded web UI), its packet framing,
                 background services and the shared waterfall
                 subsystem (``wf_service``).
- ``extensions`` — the extension base, the registry and the two
                 host-only extensions (S-meter, IQ display).
- ``utils``    — config, log ring, event trace, password hashing, the
                 DX label database and the EiBi schedule.
- ``run_server`` — ``python -m flydog_sdr_gps_tpu_torch.run_server``.
- ``convert``  — JAX reference state/tuning (as numpy) -> port tensors.
- ``csrc``     — hand-written CUDA kernels, built at first use by
                 ``_build`` (plain ``nvcc``, loaded with ``ctypes``).

The package imports ``torch`` and never ``jax``, and nothing of the
reference package: ``numerology``, ``ops.filters``, ``ops.windows``,
``ops.adpcm``, ``runtime.native``, ``utils``, ``extensions`` and the
host-only modules of ``server`` are its own copies of the reference's
modules of those names.

Conventions kept from the reference at every public function: signals
are time-major ``(N, C)``; 48-bit NCO phases are exact.  What changes:
complex data is ``complex64`` (not split re/im), a phase is one
``int64`` word (not three 16-bit limbs), FFTs are ``torch.fft``.
``StreamEngine``, ``DeviceSceneSource`` and ``WfSubsystem`` run on the
card (``device="cuda"``) unless the caller asks for the CPU; tensors on the CPU run each
kernel's plain PyTorch version, CUDA tensors run the kernel.
"""

__version__ = "0.1.0"
