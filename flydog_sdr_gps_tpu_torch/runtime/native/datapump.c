/* Native data pump — ring buffer + wire-format conversion.
 *
 * Host-side equivalent of the reference host data pump
 * (rx/data_pump.cpp): the FPGA delivers packed 24-bit IQ over SPI
 * DMA; the host converts s24 -> float with a fixed rescale and
 * optional I/Q swap (data_pump.cpp:145-208), tracks sequence numbers
 * (SND_SEQ_CHECK, :56-143) and recovers from overruns (:245-269).
 *
 * Here the same responsibilities sit between an ingest thread
 * (file/network ADC replay) and the block dispatch loop:
 *  - dp_ring_*: single-producer single-consumer lock-free ring of
 *    fixed-size float32 blocks (the reference's rx_dpump_t ring,
 *    N_DPBUF=32, data_pump.h:36-57).
 *  - dp_s24_to_f32 / dp_s16_to_f32: packed little-endian sample
 *    formats -> float32 full scale, optional IQ swap.
 *  - dp_f32_to_s16be: outbound SND IQ packets are big-endian s16
 *    (rx_sound.cpp:1039-1216).
 *  - dp_seq_check: sequence-gap accounting.
 *
 * Built at first use by runtime/native/__init__.py; numpy fallbacks in
 * runtime/source.py keep the package functional without a compiler.
 */

#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* conversions                                                          */
/* ------------------------------------------------------------------ */

/* n samples of packed signed 24-bit little-endian -> float32 * scale.
 * iq_swap: swap each (I,Q) pair (sideband polarity,
 * data_pump.cpp:168-208); n must be even when set. */
void dp_s24_to_f32(const uint8_t *in, float *out, int64_t n,
                   float scale, int iq_swap)
{
    for (int64_t i = 0; i < n; i++) {
        /* assemble in unsigned, then sign-extend 24 -> 32 without
         * the UB of left-shifting a negative signed value */
        uint32_t u = (uint32_t)in[3 * i] |
                     ((uint32_t)in[3 * i + 1] << 8) |
                     ((uint32_t)in[3 * i + 2] << 16);
        int32_t v = (int32_t)(u << 8) / 256;
        out[i] = (float)v * scale;
    }
    if (iq_swap) {
        for (int64_t i = 0; i + 1 < n; i += 2) {
            float t = out[i];
            out[i] = out[i + 1];
            out[i + 1] = t;
        }
    }
}

void dp_s16_to_f32(const int16_t *in, float *out, int64_t n,
                   float scale, int iq_swap)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = (float)in[i] * scale;
    if (iq_swap) {
        for (int64_t i = 0; i + 1 < n; i += 2) {
            float t = out[i];
            out[i] = out[i + 1];
            out[i + 1] = t;
        }
    }
}

/* float32 (+-1 full scale) -> big-endian s16 with saturation */
void dp_f32_to_s16be(const float *in, uint8_t *out, int64_t n,
                     float scale)
{
    for (int64_t i = 0; i < n; i++) {
        float v = in[i] * scale;
        int32_t s = (int32_t)(v >= 0 ? v + 0.5f : v - 0.5f);
        if (s > 32767) s = 32767;
        if (s < -32768) s = -32768;
        out[2 * i] = (uint8_t)((s >> 8) & 0xFF);
        out[2 * i + 1] = (uint8_t)(s & 0xFF);
    }
}

/* sequence check: state[0]=expected seq (-1 = uninitialized),
 * state[1]=total gaps.  The first packet initializes the expectation
 * (joining mid-stream is not a loss).  Returns this packet's gap. */
int64_t dp_seq_check(int64_t *state, int64_t seq)
{
    int64_t gap = 0;
    if (state[0] != -1) {
        gap = seq - state[0];
        if (gap < 0) gap = 0;           /* restart */
        state[1] += gap;
    }
    state[0] = seq + 1;
    return gap;
}

/* ------------------------------------------------------------------ */
/* SPSC ring of fixed-size float32 blocks                               */
/* ------------------------------------------------------------------ */

typedef struct {
    float *buf;
    int64_t block;                      /* floats per block */
    int64_t nblocks;                    /* power of two */
    _Atomic int64_t head;               /* next write slot */
    _Atomic int64_t tail;               /* next read slot */
    _Atomic int64_t overruns;
} dp_ring;

dp_ring *dp_ring_new(int64_t block, int64_t nblocks)
{
    /* round nblocks up to a power of two */
    int64_t cap = 1;
    while (cap < nblocks) cap <<= 1;
    dp_ring *r = calloc(1, sizeof(dp_ring));
    if (!r) return NULL;
    r->buf = malloc(sizeof(float) * (size_t)(block * cap));
    if (!r->buf) { free(r); return NULL; }
    r->block = block;
    r->nblocks = cap;
    return r;
}

void dp_ring_free(dp_ring *r)
{
    if (r) { free(r->buf); free(r); }
}

int64_t dp_ring_fill(const dp_ring *r)
{
    return atomic_load(&((dp_ring *)r)->head)
         - atomic_load(&((dp_ring *)r)->tail);
}

int64_t dp_ring_overruns(const dp_ring *r)
{
    return atomic_load(&((dp_ring *)r)->overruns);
}

/* producer: push one block.  When full the NEW block is dropped and
 * counted — the producer never touches tail, preserving the SPSC
 * invariant (a drop-oldest push would race the consumer's in-flight
 * memcpy of that slot).  A consumer wanting only the freshest data
 * drains with repeated pops (the reference's latency reset,
 * data_pump.cpp:245-269, skips to the freshest buffer the same way).
 * Returns 1 if the block was dropped. */
int dp_ring_push(dp_ring *r, const float *src)
{
    int64_t head = atomic_load_explicit(&r->head, memory_order_relaxed);
    int64_t tail = atomic_load_explicit(&r->tail, memory_order_acquire);
    if (head - tail >= r->nblocks) {
        atomic_fetch_add(&r->overruns, 1);
        return 1;
    }
    memcpy(r->buf + (head & (r->nblocks - 1)) * r->block, src,
           sizeof(float) * (size_t)r->block);
    atomic_store_explicit(&r->head, head + 1, memory_order_release);
    return 0;
}

/* consumer: pop one block into dst; returns 0 if empty */
int dp_ring_pop(dp_ring *r, float *dst)
{
    int64_t tail = atomic_load_explicit(&r->tail, memory_order_relaxed);
    int64_t head = atomic_load_explicit(&r->head, memory_order_acquire);
    if (head == tail)
        return 0;
    memcpy(dst, r->buf + (tail & (r->nblocks - 1)) * r->block,
           sizeof(float) * (size_t)r->block);
    atomic_store_explicit(&r->tail, tail + 1, memory_order_release);
    return 1;
}
