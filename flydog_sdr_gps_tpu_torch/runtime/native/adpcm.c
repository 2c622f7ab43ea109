/* IMA-ADPCM codec — native implementation of rx/csdr/ima_adpcm.cpp's
 * wire behavior (4 bits/sample, 89-entry step table).
 *
 * Compiled at import time by runtime/native/__init__.py (cc -> .so,
 * loaded via ctypes).  The Python fallback in ops/adpcm.py is the
 * reference implementation; this exists because encoding is a serial
 * per-sample loop that must keep up with hundreds of audio channels
 * on the host (12 kHz * N channels).
 */

#include <stdint.h>

static const int16_t step_table[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

static const int8_t index_table[16] = {
    -1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8};

/* state: int32 state[2] = {predictor, index}; updated in place. */

void adpcm_encode(const int16_t *in, uint8_t *out, int n, int32_t *state)
{
    int pred = state[0], idx = state[1];
    for (int i = 0; i < n; i++) {
        int step = step_table[idx];
        int diff = (int)in[i] - pred;
        int nib = 0;
        if (diff < 0) { nib = 8; diff = -diff; }
        if (diff >= step)      { nib |= 4; diff -= step; }
        if (diff >= step >> 1) { nib |= 2; diff -= step >> 1; }
        if (diff >= step >> 2) { nib |= 1; }
        /* reconstruct exactly as the decoder will */
        int delta = step >> 3;
        if (nib & 1) delta += step >> 2;
        if (nib & 2) delta += step >> 1;
        if (nib & 4) delta += step;
        pred += (nib & 8) ? -delta : delta;
        if (pred > 32767) pred = 32767;
        if (pred < -32768) pred = -32768;
        idx += index_table[nib];
        if (idx < 0) idx = 0;
        if (idx > 88) idx = 88;
        if (i & 1) out[i >> 1] |= (uint8_t)(nib << 4);
        else       out[i >> 1] = (uint8_t)nib;
    }
    state[0] = pred; state[1] = idx;
}

/* Batched encode: k independent channel streams of n samples each
 * (in: k rows x n, row-major; out: k rows x n/2; states: k x 2).
 * One call per served block encodes EVERY channel that has at least
 * one compressed listener — the reference encodes once per channel
 * and fans the buffer out to campers (`rx/rx_sound.cpp:1121-1139`,
 * `c2s_sound_camp`); per-connection encodes scale with listeners,
 * this scales with channels. */
void adpcm_encode_batch(const int16_t *in, uint8_t *out, int n, int k,
                        int32_t *states)
{
    for (int c = 0; c < k; c++)
        adpcm_encode(in + (int64_t)c * n, out + (int64_t)c * (n / 2),
                     n, states + 2 * (int64_t)c);
}

void adpcm_decode(const uint8_t *in, int16_t *out, int n_samples,
                  int32_t *state)
{
    int pred = state[0], idx = state[1];
    for (int i = 0; i < n_samples; i++) {
        int nib = (i & 1) ? (in[i >> 1] >> 4) : (in[i >> 1] & 0xF);
        int step = step_table[idx];
        int delta = step >> 3;
        if (nib & 1) delta += step >> 2;
        if (nib & 2) delta += step >> 1;
        if (nib & 4) delta += step;
        pred += (nib & 8) ? -delta : delta;
        if (pred > 32767) pred = 32767;
        if (pred < -32768) pred = -32768;
        idx += index_table[nib];
        if (idx < 0) idx = 0;
        if (idx > 88) idx = 88;
        out[i] = (int16_t)pred;
    }
    state[0] = pred; state[1] = idx;
}
