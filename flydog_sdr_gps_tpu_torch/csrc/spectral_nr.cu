// The spectral noise reduction's frame recurrences, between the two FFTs.
//
// Replaces two lax.scan recurrences of the JAX reference's ops/noise.py:
// spectral_nr_block
//   :150  the EMA of the power spectrum over the frames of a block
//         (sm <- sm + alpha (|X|^2 - sm)), whose block minimum feeds the
//         minimum-statistics noise estimate;
//   :172  the MMSE-LSA gain with the decision-directed a-priori SNR
//         (the "mmse" gain rule).
// Per (bin, channel) and block, in the reference's order: psd = |X|^2;
// the EMA over the nfr frames; the block minimum of that sequence; the
// ring of min_window block minima shifted by one with this block's
// appended; est = floor_bias * min(ring); the gain of every frame by
// "subtract" (sqrt(max(1 - os est / max(sm_i, 1e-12), floor^2))) or by
// "mmse" (a recurrence over the frames through xhat2); X * g.
//
// What bounds it on an H100 is bytes: the one-sided spectrum in and out
// (16 x 129 x C complex64 each way), the ring's min_window - 1 newest
// planes in (the oldest is dropped unread) and min_window planes out, the
// EMA (and for "mmse" xhat2) in and out; about 15 operations a frame, bin and
// channel, against which the bytes weigh about 25 times more at C=4096.
//
// Design: one thread a (bin, channel).  torch.fft leaves the bins
// adjacent and the state keeps the channels adjacent, so a block owns a
// tile of 32 bins x 8 channels and meets each in its own layout: the
// spectrum in and X * g out as runs of 32 neighbouring bins a warp
// (256 bytes), the state as runs of 8 neighbouring channels (32 bytes,
// one sector), the two layouts joined through shared memory.  The
// state's threads copy the ring out of place (the oldest entry dropped)
// and take the minimum of what stays; the spectrum's threads walk the
// frames twice.  Pass one keeps the first kKeep frames' spectra in
// registers and forms the EMA and its block minimum.  Pass two
// recomputes the EMA from the block's starting value (the same
// operations on the same values, so the same sums to the bit), forms
// each frame's gain and writes X * g, bins adjacent, for the inverse FFT.
// A block of more than kKeep frames reads the later frames' spectra a
// second time.  The two gain rules are two template instances.
//
// Numerics follow the plain version (ops/noise.py:spectral_nr_gains_plain)
// as PyTorch rounds it: every operation rounded on its own (__f*_rn, so
// nvcc contracts nothing into a fused multiply-add), the constants as the
// plain version's operations see them (float32 of the Python values,
// passed in by the wrapper, or cast from double here), accurate logf,
// expf and sqrtf (no fast-math), clamps that let a NaN through as
// torch.clamp does, and a minimum that a NaN wins, as torch.amin.  The
// minimum is exact in any order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBins = 32;           // a block's tile: 32 bins x 8 channels
constexpr int kChans = 8;
constexpr int kThreads = kBins * kChans;
constexpr int kKeep = 16;           // frames whose spectrum stays in registers

struct Consts {
  float alpha;                      // smooth_alpha
  float bias;                       // floor_bias
  float os;                         // over_subtract
  float floor2;                     // gain_floor ** 2 (a Python double)
  float gfloor;                     // gain_floor
  float a;                          // float32(dd_alpha)
  float oma;                        // 1 - a, taken in double
};

// torch.clamp(v, min=lo) / clamp(v, lo, hi): a NaN passes
__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.amin: a NaN wins, whatever the order
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float abs2(float2 z) {
  return __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
}

__device__ __forceinline__ float ema(float sm, float p, float alpha) {
  return __fadd_rn(sm, __fmul_rn(alpha, __fsub_rn(p, sm)));
}

// E1(v), Abramowitz-Stegun 5.1.53 / 5.1.56, as the plain version's
// _expint_e1 evaluates the branch that torch.where keeps
__device__ float expint_e1(float v) {
  if (v <= 1.0f) {
    float p = __fmul_rn(v, (float)0.00107857);
    p = __fmul_rn(v, __fadd_rn(p, (float)-0.00976004));
    p = __fmul_rn(v, __fadd_rn(p, (float)0.05519968));
    p = __fmul_rn(v, __fadd_rn(p, (float)-0.24991055));
    p = __fmul_rn(v, __fadd_rn(p, (float)0.99999193));
    const float lg = -logf(at_least(v, (float)1e-12));
    return __fadd_rn(__fsub_rn(lg, (float)0.57721566), p);
  }
  const float num = __fadd_rn(__fmul_rn(v, __fadd_rn(v, (float)2.334733)),
                              (float)0.250621);
  const float den = __fadd_rn(__fmul_rn(v, __fadd_rn(v, (float)3.330657)),
                              (float)1.681534);
  return __fdiv_rn(
      __fmul_rn(__fdiv_rn(expf(-v), at_least(v, (float)1e-12)), num), den);
}

// the gain of one frame by spectral subtraction
__device__ __forceinline__ float subtract_gain(float num, float sm,
                                               const Consts& k) {
  return sqrtf(at_least(
      __fsub_rn(1.0f, __fdiv_rn(num, at_least(sm, (float)1e-12))),
      k.floor2));
}

// the gain of one frame by the MMSE-LSA rule; advances xh
__device__ __forceinline__ float mmse_gain(float psd, float lam, float& xh,
                                           const Consts& k) {
  const float gam = at_least(__fdiv_rn(psd, lam), (float)1e-6);
  float xi = __fadd_rn(__fdiv_rn(__fmul_rn(k.a, xh), lam),
                       __fmul_rn(k.oma, at_least(__fsub_rn(gam, 1.0f), 0.0f)));
  xi = at_least(xi, (float)1e-6);
  const float opx = __fadd_rn(1.0f, xi);
  const float v = clip(__fdiv_rn(__fmul_rn(gam, xi), opx), (float)1e-6, 50.0f);
  float g = __fmul_rn(__fdiv_rn(xi, opx),
                      expf(__fmul_rn(0.5f, expint_e1(v))));
  g = clip(g, k.gfloor, 1.0f);
  xh = __fmul_rn(__fmul_rn(__fmul_rn(g, g), gam), lam);
  return g;
}

template <bool kMmse>
__global__ void __launch_bounds__(kThreads)
spectral_nr_kernel(const float2* __restrict__ spec, long long frame_stride,
                   long long chan_stride, float2* __restrict__ out,
                   const float* __restrict__ sm_in, float* __restrict__ sm_out,
                   const float* __restrict__ ring_in,
                   float* __restrict__ ring_out,
                   const float* __restrict__ xh_in, float* __restrict__ xh_out,
                   int nfr, int hb, int C, int mw, Consts k) {
  // the state of the tile, [bin][channel]; 9 apart so that a warp's
  // column of 32 bins meets 32 banks
  __shared__ float t_sm[kBins][kChans + 1], t_xh[kBins][kChans + 1],
      t_min[kBins][kChans + 1];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kBins, c0 = blockIdx.y * kChans;
  const size_t plane = (size_t)hb * C;

  // the state's layout: 8 neighbouring channels (32 bytes) of a bin
  const int sb = tid / kChans, sc = tid % kChans;
  const bool s_ok = b0 + sb < hb && c0 + sc < C;
  const size_t is = (size_t)(b0 + sb) * C + c0 + sc;
  if (s_ok) {
    // the ring of block minima, out of place, and the minimum of the
    // entries that stay
    float rmin = CUDART_INF_F;
    for (int r = 0; r + 1 < mw; ++r) {
      const float v = ring_in[(r + 1) * plane + is];
      ring_out[r * plane + is] = v;
      rmin = nan_min(rmin, v);
    }
    t_min[sb][sc] = rmin;
    t_sm[sb][sc] = sm_in[is];
    if (kMmse) t_xh[sb][sc] = xh_in[is];
  }
  __syncthreads();

  // the spectrum's layout: 32 neighbouring bins of a channel
  const int bx = tid % kBins, cy = tid / kBins;
  const int b = b0 + bx, c = c0 + cy;
  if (b < hb && c < C) {
    const float2* x = spec + (size_t)c * chan_stride + b;
    float2* y = out + (size_t)c * hb + b;
    float2 z[kKeep];

    // pass one: the EMA over the frames and its block minimum
    const float sm0 = t_sm[bx][cy];
    float sm = sm0, bmin = CUDART_INF_F;
#pragma unroll
    for (int f = 0; f < kKeep; ++f) {
      if (f < nfr) {
        z[f] = x[(size_t)f * frame_stride];
        sm = ema(sm, abs2(z[f]), k.alpha);
        bmin = nan_min(bmin, sm);
      }
    }
    for (int f = kKeep; f < nfr; ++f) {
      sm = ema(sm, abs2(x[(size_t)f * frame_stride]), k.alpha);
      bmin = nan_min(bmin, sm);
    }
    const float est = __fmul_rn(k.bias, nan_min(t_min[bx][cy], bmin));
    t_sm[bx][cy] = sm;
    t_min[bx][cy] = bmin;

    // pass two: the gains and X * g
    if constexpr (kMmse) {
      const float lam = at_least(est, (float)1e-12);
      float xh = t_xh[bx][cy];
#pragma unroll
      for (int f = 0; f < kKeep; ++f) {
        if (f < nfr) {
          const float g = mmse_gain(abs2(z[f]), lam, xh, k);
          y[(size_t)f * plane] = make_float2(__fmul_rn(z[f].x, g),
                                             __fmul_rn(z[f].y, g));
        }
      }
      for (int f = kKeep; f < nfr; ++f) {
        const float2 zf = x[(size_t)f * frame_stride];
        const float g = mmse_gain(abs2(zf), lam, xh, k);
        y[(size_t)f * plane] = make_float2(__fmul_rn(zf.x, g),
                                           __fmul_rn(zf.y, g));
      }
      t_xh[bx][cy] = xh;
    } else {
      const float num = __fmul_rn(k.os, est);
      sm = sm0;
#pragma unroll
      for (int f = 0; f < kKeep; ++f) {
        if (f < nfr) {
          sm = ema(sm, abs2(z[f]), k.alpha);
          const float g = subtract_gain(num, sm, k);
          y[(size_t)f * plane] = make_float2(__fmul_rn(z[f].x, g),
                                             __fmul_rn(z[f].y, g));
        }
      }
      for (int f = kKeep; f < nfr; ++f) {
        const float2 zf = x[(size_t)f * frame_stride];
        sm = ema(sm, abs2(zf), k.alpha);
        const float g = subtract_gain(num, sm, k);
        y[(size_t)f * plane] = make_float2(__fmul_rn(zf.x, g),
                                           __fmul_rn(zf.y, g));
      }
    }
  }
  __syncthreads();

  // the new state, in the state's layout
  if (s_ok) {
    sm_out[is] = t_sm[sb][sc];
    ring_out[(mw - 1) * plane + is] = t_min[sb][sc];
    if (kMmse) xh_out[is] = t_xh[sb][sc];
  }
}

}  // namespace

// spec: (nfr, hb, C) complex64 with the bins adjacent, channels
// chan_stride and frames frame_stride complex values apart (torch.fft's
// layout); out: (nfr, C, hb) complex64 contiguous (the bins adjacent);
// sm and xh: (hb, C) float32; ring: (mw, hb, C) float32.  xh_in / xh_out
// are read and written only by the "mmse" rule.
extern "C" int spectral_nr_c64(const void* spec, long long frame_stride,
                               long long chan_stride, void* out,
                               const void* sm_in, void* sm_out,
                               const void* ring_in, void* ring_out,
                               const void* xh_in, void* xh_out, int nfr,
                               int hb, int C, int mw, int mmse, float alpha,
                               float bias, float os, float floor2,
                               float gfloor, float a, float oma,
                               void* stream) {
  if (nfr <= 0 || hb <= 0 || C <= 0 || mw <= 0)
    return (int)cudaErrorInvalidValue;
  const Consts k{alpha, bias, os, floor2, gfloor, a, oma};
  const dim3 grid((hb + kBins - 1) / kBins, (C + kChans - 1) / kChans);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* sp = static_cast<const float2*>(spec);
  float2* o = static_cast<float2*>(out);
  const float* si = static_cast<const float*>(sm_in);
  float* so = static_cast<float*>(sm_out);
  const float* ri = static_cast<const float*>(ring_in);
  float* ro = static_cast<float*>(ring_out);
  const float* xi = static_cast<const float*>(xh_in);
  float* xo = static_cast<float*>(xh_out);
  if (mmse)
    spectral_nr_kernel<true><<<grid, kThreads, 0, s>>>(
        sp, frame_stride, chan_stride, o, si, so, ri, ro, xi, xo, nfr, hb, C,
        mw, k);
  else
    spectral_nr_kernel<false><<<grid, kThreads, 0, s>>>(
        sp, frame_stride, chan_stride, o, si, so, ri, ro, xi, xo, nfr, hb, C,
        mw, k);
  return (int)cudaGetLastError();
}
