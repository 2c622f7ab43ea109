// Per-channel time loops of the audio back half.
//
// Replace two lax.scan recurrences of the JAX reference:
//   agc_envelope_f32  <- ops/agc.py:_envelope_scan (lax.scan, :72-91)
//   sam_pll_c64       <- ops/demod.py:sam_demod    (lax.scan, :183-195)
//
// Both are sequential in time and independent across channels: one
// thread per channel loops over the N samples of the block, carrying
// its state in registers.  What bounds them on an H100: the dependent
// chain of N steps per thread (C=4096 channels are only 4096 threads,
// a few warps per SM), not bytes — (N, C) float32/complex64 in and out
// is 34-67 MB a block.  Design: 64-thread blocks to spread the channels
// over more SMs; loads coalesced across channels ((N, C) time-major);
// the AGC loop loads kUnroll samples ahead of its dependent chain.
// The arithmetic follows the reference scan step by step (same clip,
// same +-pi wrap, NaN propagated as jnp.clip/jnp.where would).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ void agc_step(float m, float& env, int& hang,
                                         float atk, float dec, int hang_n) {
  const bool rising = m > env;
  const float env_up = env + atk * (m - env);
  const float env_dn = hang > 0 ? env : env + dec * (m - env);
  env = rising ? env_up : env_dn;
  hang = rising ? hang_n : max(hang - 1, 0);
}

__global__ void __launch_bounds__(kThreads)
agc_envelope_kernel(const float* __restrict__ mag_db,
                    float* __restrict__ env_seq, float* __restrict__ env_io,
                    int* __restrict__ hang_io, int N, int C, float atk,
                    float dec, int hang_n) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float env = env_io[c];
  int hang = hang_io[c];
  int n = 0;
  for (; n + kUnroll <= N; n += kUnroll) {
    float m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m[u] = mag_db[(size_t)(n + u) * C + c];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      agc_step(m[u], env, hang, atk, dec, hang_n);
      env_seq[(size_t)(n + u) * C + c] = env;
    }
  }
  for (; n < N; ++n) {
    agc_step(mag_db[(size_t)n * C + c], env, hang, atk, dec, hang_n);
    env_seq[(size_t)n * C + c] = env;
  }
  env_io[c] = env;
  hang_io[c] = hang;
}

__global__ void __launch_bounds__(kThreads)
sam_pll_kernel(const float2* __restrict__ z, float2* __restrict__ v,
               float* __restrict__ phase_io, float* __restrict__ freq_io,
               int N, int C, float g1, float g2, float fmax) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float kPi = 3.14159265358979323846f;
  const float kTwoPi = 6.28318530717958647692f;
  float phase = phase_io[c];
  float freq = freq_io[c];
  for (int n = 0; n < N; ++n) {
    const float2 zn = z[(size_t)n * C + c];
    float s, co;
    sincosf(phase, &s, &co);
    // v = zn * (cos(phase) - j*sin(phase))
    const float vr = zn.x * co - zn.y * (-s);
    const float vi = zn.x * (-s) + zn.y * co;
    const float err = atan2f(vi, vr);
    float f2 = freq + g2 * err;
    if (!isnan(f2)) f2 = fminf(fmaxf(f2, -fmax), fmax);
    float p2 = phase + f2 + g1 * err;
    p2 = p2 > kPi ? p2 - kTwoPi : (p2 < -kPi ? p2 + kTwoPi : p2);
    v[(size_t)n * C + c] = make_float2(vr, vi);
    phase = p2;
    freq = f2;
  }
  phase_io[c] = phase;
  freq_io[c] = freq;
}

}  // namespace

extern "C" int agc_envelope_f32(const void* mag_db, void* env_seq,
                                void* env, void* hang, int N, int C,
                                float atk, float dec, int hang_n,
                                void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  agc_envelope_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mag_db), static_cast<float*>(env_seq),
      static_cast<float*>(env), static_cast<int*>(hang), N, C, atk, dec,
      hang_n);
  return (int)cudaGetLastError();
}

extern "C" int sam_pll_c64(const void* z, void* v, void* phase, void* freq,
                           int N, int C, float g1, float g2, float fmax,
                           void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  sam_pll_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(z), static_cast<float2*>(v),
      static_cast<float*>(phase), static_cast<float*>(freq), N, C, g1, g2,
      fmax);
  return (int)cudaGetLastError();
}
