"""IMA-ADPCM 4:1 audio compression (host-side codec).

Reference: `rx/csdr/ima_adpcm.cpp:1-214` — each SND/WF packet payload
is optionally IMA-ADPCM compressed (4 bits/sample); the browser decodes
in JS.  The codec is standard IMA (DVI) ADPCM: 89-entry step table,
per-stream (predictor, step index) state that the Kiwi protocol resets
at mode changes and signals via sequence flags.

The encoder is inherently sequential per stream, so it lives on the
HOST side of the framework (the card emits float audio; compression is
part of the network egress path).  A C implementation is provided in
`runtime/native/` for production rates; this numpy version is the
reference/fallback and is used by tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)

INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                        -1, -1, -1, -1, 2, 4, 6, 8], np.int32)


@dataclasses.dataclass
class AdpcmState:
    predictor: int = 0
    index: int = 0


def encode(samples: np.ndarray, state: AdpcmState) -> np.ndarray:
    """Encode int16 samples -> packed uint8 nibbles (low nibble first).

    ``len(samples)`` must be even.  Mutates ``state`` in place (stream
    continuity across packets, as the reference keeps per-connection
    codec state).
    """
    try:
        from ..runtime.native import adpcm_native
        if adpcm_native is not None:
            return adpcm_native.encode(samples, state)
    except ImportError:
        pass
    return _encode_py(samples, state)


def _encode_py(samples: np.ndarray, state: AdpcmState) -> np.ndarray:
    samples = np.asarray(samples, np.int32)
    out = np.zeros(len(samples) // 2, np.uint8)
    pred, idx = state.predictor, state.index
    for i, s in enumerate(samples):
        step = int(STEP_TABLE[idx])
        diff = int(s) - pred
        nib = 0
        if diff < 0:
            nib = 8
            diff = -diff
        if diff >= step:
            nib |= 4
            diff -= step
        if diff >= step >> 1:
            nib |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            nib |= 1
            diff -= step >> 2
        # reconstruct predictor exactly as the decoder will
        delta = step >> 3
        if nib & 1: delta += step >> 2
        if nib & 2: delta += step >> 1
        if nib & 4: delta += step
        pred = pred - delta if (nib & 8) else pred + delta
        pred = max(-32768, min(32767, pred))
        idx = max(0, min(88, idx + int(INDEX_TABLE[nib])))
        if i & 1:
            out[i >> 1] |= nib << 4
        else:
            out[i >> 1] = nib
    state.predictor, state.index = pred, idx
    return out


def encode_batch(samples_2d: np.ndarray,
                 states_2d: np.ndarray) -> np.ndarray:
    """Encode k independent channel streams in one call.

    ``samples_2d``: (k, n) int16; ``states_2d``: (k, 2) int32
    [predictor, index] per stream, mutated in place.  Returns
    (k, n//2) packed nibbles.  This is the serving fan-out fast path:
    one encode per CHANNEL shared by all its listeners/campers, like
    the reference (`rx/rx_sound.cpp:1121-1139`, `c2s_sound_camp`).
    """
    try:
        from ..runtime.native import adpcm_native
        if adpcm_native is not None:
            return adpcm_native.encode_batch(samples_2d, states_2d)
    except ImportError:
        pass
    samples_2d = np.asarray(samples_2d, np.int16)
    out = np.zeros((samples_2d.shape[0], samples_2d.shape[1] // 2),
                   np.uint8)
    for i in range(samples_2d.shape[0]):
        st = AdpcmState(int(states_2d[i, 0]), int(states_2d[i, 1]))
        out[i] = _encode_py(samples_2d[i], st)
        states_2d[i, 0], states_2d[i, 1] = st.predictor, st.index
    return out


def encode_u8(samples: np.ndarray, state: AdpcmState) -> np.ndarray:
    """u8-domain IMA variant used by waterfall rows
    (`rx/csdr/ima_adpcm.cpp:200-214` encode_ima_adpcm_u8_e8):
    identical quantizer, predictor clamped to [0, 255]."""
    samples = np.asarray(samples, np.int32)
    out = np.zeros(len(samples) // 2, np.uint8)
    pred, idx = state.predictor, state.index
    for i, s in enumerate(samples):
        step = int(STEP_TABLE[idx])
        diff = int(s) - pred
        nib = 0
        if diff < 0:
            nib = 8
            diff = -diff
        if diff >= step:
            nib |= 4
            diff -= step
        if diff >= step >> 1:
            nib |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            nib |= 1
        delta = step >> 3
        if nib & 1: delta += step >> 2
        if nib & 2: delta += step >> 1
        if nib & 4: delta += step
        pred = pred - delta if (nib & 8) else pred + delta
        pred = max(0, min(255, pred))
        idx = max(0, min(88, idx + int(INDEX_TABLE[nib])))
        if i & 1:
            out[i >> 1] |= nib << 4
        else:
            out[i >> 1] = nib
    state.predictor, state.index = pred, idx
    return out


def decode_u8(data: np.ndarray, state: AdpcmState) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    out = np.zeros(len(data) * 2, np.uint8)
    pred, idx = state.predictor, state.index
    for i in range(len(out)):
        nib = (data[i >> 1] >> 4) if (i & 1) else (data[i >> 1] & 0xF)
        step = int(STEP_TABLE[idx])
        delta = step >> 3
        if nib & 1: delta += step >> 2
        if nib & 2: delta += step >> 1
        if nib & 4: delta += step
        pred = pred - delta if (nib & 8) else pred + delta
        pred = max(0, min(255, pred))
        idx = max(0, min(88, idx + int(INDEX_TABLE[nib])))
        out[i] = pred
    state.predictor, state.index = pred, idx
    return out


def decode(data: np.ndarray, state: AdpcmState) -> np.ndarray:
    """Decode packed nibbles -> int16 samples (for tests / monitoring)."""
    try:
        from ..runtime.native import adpcm_native
        if adpcm_native is not None:
            return adpcm_native.decode(data, state)
    except ImportError:
        pass
    return _decode_py(data, state)


def _decode_py(data: np.ndarray, state: AdpcmState) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    out = np.zeros(len(data) * 2, np.int16)
    pred, idx = state.predictor, state.index
    for i in range(len(out)):
        nib = (data[i >> 1] >> 4) if (i & 1) else (data[i >> 1] & 0xF)
        step = int(STEP_TABLE[idx])
        delta = step >> 3
        if nib & 1: delta += step >> 2
        if nib & 2: delta += step >> 1
        if nib & 4: delta += step
        pred = pred - delta if (nib & 8) else pred + delta
        pred = max(-32768, min(32767, pred))
        idx = max(0, min(88, idx + int(INDEX_TABLE[nib])))
        out[i] = pred
    state.predictor, state.index = pred, idx
    return out
