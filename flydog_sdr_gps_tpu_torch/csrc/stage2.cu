// Stage-2 shared-tap polyphase decimator, with and without the fused
// 48-bit NCO rotator.
//
// Replaces the two Pallas kernels of the JAX reference,
// flydog_sdr_gps_tpu/ops/pallas_kernels.py:
//   stage2_rot_pallas                  -> stage2_rot_c64 (ROTATE=true)
//   stage2_pallas / stage2_pallas_part -> stage2_c64     (ROTATE=false)
//
// out[k, c] = sum_{i<m2} sum_{d<d2} h2[i*d2 + d] * v[(k+i)*d2 + d, c]
// with v = y (stage2_c64) or v[n, c] = y[n, c] * exp(-2*pi*j*(phi0_c +
// n*dphi_c) / 2^48) (stage2_rot_c64).  y is complex64 (Kp, C), Kp =
// (k2 + m2 - 1) * d2; out is complex64 (k2, C).
//
// What bounds it on an H100: the read of y — 2.1 GB a block at C=4096
// (~0.63 ms at 3.35 TB/s) against ~25 GFLOP of tap arithmetic (~0.4 ms
// at 67 TFLOP/s f32).  Design:
// - one thread per channel, 128 channels a block, so each warp reads
//   256 contiguous bytes of a row; blocks also split k into tiles of
//   kTileK outputs (the m2-1 overlap rows are re-read, mostly from L2);
// - each input element is read once and rotated once: the exact phase
//   word is taken once per d2-sample row (uint64 arithmetic, which wraps
//   safely because 2^48 divides 2^64; cycles formed as the reference's
//   nco.limbs_to_cycles_f32 does), and the d2 samples of the row are
//   rotated by a running product with exp(-2*pi*j*dphi);
// - a transposed-form FIR: a row's m2 tap-row dot products go to m2
//   register accumulators, one of which completes per row;
// - the taps ride in the kernel parameters (<= 4 KB), i.e. in the
//   constant bank, so each tap is an FMA operand, not a load.
// (d2, m2) are template parameters for the two decimation plans:
// (31, 24) at 12 kHz and (4, 25) at 20.25 kHz.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTileK = 128;     // outputs per block
constexpr uint64_t kMask48 = (1ull << 48) - 1;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// float32 cycles in [0, 1) of a 48-bit phase word: the reference's
// three-limb sum l2*2^-16 + l1*2^-32 + l0*2^-48 (ops/nco.py:109-114)
__device__ __forceinline__ float word_to_cycles(uint64_t w) {
  const float l0 = (float)(unsigned)(w & 0xFFFFu);
  const float l1 = (float)(unsigned)((w >> 16) & 0xFFFFu);
  const float l2 = (float)(unsigned)((w >> 32) & 0xFFFFu);
  return __fadd_rn(__fadd_rn(__fmul_rn(l2, 1.52587890625e-05f),
                             __fmul_rn(l1, 2.3283064365386963e-10f)),
                   __fmul_rn(l0, 3.552713678800501e-15f));
}

// exp(-2*pi*j*cycles(w))
__device__ __forceinline__ float2 rotator(uint64_t w) {
  float s, c;
  sincospif(2.0f * word_to_cycles(w), &s, &c);
  return make_float2(c, -s);
}

template <int D2, int M2>
struct Taps {
  float h[M2 * D2];
};

template <int D2, int M2, bool ROTATE>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(const float2* __restrict__ y, float2* __restrict__ out,
              const int64_t* __restrict__ phi0,
              const int64_t* __restrict__ dphi,
              const Taps<D2, M2> taps, int C, int k2) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;                              // ragged channel edge
  const int k0 = blockIdx.y * kTileK;
  const int k_end = min(k0 + kTileK, k2);          // ragged k edge

  uint64_t ph0 = 0, dph = 0;
  float2 step = make_float2(1.f, 0.f);
  if (ROTATE) {
    ph0 = (uint64_t)phi0[c];
    dph = (uint64_t)dphi[c];
    step = rotator(dph);
  }

  // acc[j] holds output k = r - (M2 - 1) + j while row r is processed
  float2 acc[M2];
#pragma unroll
  for (int j = 0; j < M2; ++j) acc[j] = make_float2(0.f, 0.f);

  const int r_end = k_end + M2 - 1;
  for (int r = k0; r < r_end; ++r) {
    const float2* row = y + (size_t)r * D2 * C + c;
    float2 z[D2];
#pragma unroll
    for (int d = 0; d < D2; ++d) z[d] = row[(size_t)d * C];
    if (ROTATE) {
      float2 rot = rotator((ph0 + (uint64_t)r * D2 * dph) & kMask48);
#pragma unroll
      for (int d = 0; d < D2; ++d) {
        z[d] = cmul(z[d], rot);
        rot = cmul(rot, step);
      }
    }
#pragma unroll
    for (int i = 0; i < M2; ++i) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int d = 0; d < D2; ++d) {
        sr += taps.h[i * D2 + d] * z[d].x;
        si += taps.h[i * D2 + d] * z[d].y;
      }
      acc[M2 - 1 - i].x += sr;
      acc[M2 - 1 - i].y += si;
    }
    const int k = r - (M2 - 1);
    if (k >= k0) out[(size_t)k * C + c] = acc[0];
#pragma unroll
    for (int j = 0; j < M2 - 1; ++j) acc[j] = acc[j + 1];
    acc[M2 - 1] = make_float2(0.f, 0.f);
  }
}

template <int D2, int M2, bool ROTATE>
cudaError_t launch(const void* y, void* out, const void* phi0,
                   const void* dphi, const float* h2, int C, int k2,
                   cudaStream_t stream) {
  Taps<D2, M2> taps;
  for (int i = 0; i < M2 * D2; ++i) taps.h[i] = h2[i];
  const dim3 grid((C + kThreads - 1) / kThreads,
                  (k2 + kTileK - 1) / kTileK);
  stage2_kernel<D2, M2, ROTATE><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(y), static_cast<float2*>(out),
      static_cast<const int64_t*>(phi0), static_cast<const int64_t*>(dphi),
      taps, C, k2);
  return cudaGetLastError();
}

template <bool ROTATE>
int dispatch(const void* y, void* out, const void* phi0, const void* dphi,
             const void* h2, int C, int k2, int d2, int m2, void* stream) {
  if (C <= 0 || k2 <= 0) return (int)cudaErrorInvalidValue;
  const float* h = static_cast<const float*>(h2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d2 == 31 && m2 == 24)
    return (int)launch<31, 24, ROTATE>(y, out, phi0, dphi, h, C, k2, s);
  if (d2 == 4 && m2 == 25)
    return (int)launch<4, 25, ROTATE>(y, out, phi0, dphi, h, C, k2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int stage2_rot_c64(const void* y, void* out, const void* phi0,
                              const void* dphi, const void* h2, int C,
                              int k2, int d2, int m2, void* stream) {
  return dispatch<true>(y, out, phi0, dphi, h2, C, k2, d2, m2, stream);
}

extern "C" int stage2_c64(const void* y, void* out, const void* h2, int C,
                          int k2, int d2, int m2, void* stream) {
  return dispatch<false>(y, out, nullptr, nullptr, h2, C, k2, d2, m2,
                         stream);
}
