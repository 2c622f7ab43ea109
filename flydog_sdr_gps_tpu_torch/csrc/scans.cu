// Per-channel time loops of the audio back half.
//
// Replace two lax.scan recurrences of the JAX reference:
//   agc_envelope_f32  <- ops/agc.py:_envelope_scan (lax.scan, :72-91)
//   sam_pll_c64       <- ops/demod.py:sam_demod    (lax.scan, :183-195)
//
// Both are sequential in time and independent across channels.  What
// bounds them on an H100 is the dependent chain of N steps per channel,
// not bytes: (N, C) float32/complex64 in and out is 34-67 MB a block,
// 0.02-0.04 ms at 3.35 TB/s, while N = 2048 dependent steps cost
// N * (chain latency) whatever the card's width.
//
// agc_envelope_f32: the same plan as the PLL below, for a chain that
// needs no arithmetic outside it.  A block owns 32 channels (one
// 128-byte line a row) and walks the block in tiles of kAgcRows time
// rows through a ring of five tiles in shared memory.  One serial warp,
// a lane a channel, runs the step (compare, subtract, FMA, two selects;
// the hang counter beside it) over tile t with env and hang in
// registers, reading mag_db from shared memory and leaving env in its
// place.  The mover warps keep cp.async copies of tiles t+1 .. t+3 in
// flight (16 bytes a copy where C % 4 == 0, else 4) and write tile t-1
// out as coalesced rows, so neither a load from nor a store to device
// memory is ever waited for by the chain; one barrier a tile.  The
// chain's floor is about 20 clocks a step, 0.024 ms for 2048 steps.
//
// sam_pll_c64: the design takes everything off the chain that does not
// feed back.  Only (phase, freq) do.  The reference's step is
//   v = z[n] * exp(-j*phase);  err = atan2(Im v, Re v);
//   freq = clip(freq + g2*err);  phase = wrap(phase + freq + g1*err)
// and err equals arg(z[n]) - phase wrapped to [-pi, pi], where arg(z[n])
// depends on no state.  A block owns 32 channels and walks the block in
// tiles of kPllRows time rows through a ring of three tiles in shared
// memory; in every round, between two barriers,
//   (a) the worker warps load tile t from device memory (coalesced rows
//       of 32 channels) and store z and arg(z) to shared memory,
//   (b) the one serial warp, a lane a channel, runs the short chain
//       (subtract, wrap, FMA, clamp, add: eight dependent operations)
//       over tile t-1, reading arg(z) from shared memory and leaving
//       phase[n] in its place,
//   (c) the worker warps compute v[n] = z[n]*exp(-j*phase[n]) for tile
//       t-2 and write it out as coalesced rows.
// So no device-memory access and no transcendental function is left on
// the chain.  Its floor is about 36 clocks a step (eight operations of
// 4-5 clocks), 0.04 ms for 2048 steps; with a step's other
// instructions, the barriers and stage (a)'s load latency the kernel
// takes about 80.
// This is algebraically, not bitwise, the reference's step, so a sample
// for which the two differ is marked in (a) and handled in (b) as the
// reference would: an exactly zero sample (an unused channel) gives
// atan2 of signed zeros, 0 or +-pi by the signs of cos and sin of the
// phase, which (b) forms from the sign rules of IEEE products and sums;
// a sample whose largest component is not in [1e-30, 1e30] (tiny, huge,
// infinite or NaN) takes the reference's formula itself.  Clip, +-pi
// wrap and NaN propagate as jnp.clip/jnp.where would.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- AGC envelope ------------------------------------------------------------

constexpr int kAgcCh = 32;      // channels per block = lanes of the serial warp
constexpr int kAgcRows = 64;    // time rows per tile
constexpr int kAgcAhead = 3;    // tiles whose copies are in flight
constexpr int kAgcRing = kAgcAhead + 2;   // + the tile in the chain, + the
                                          // tile being written out
constexpr int kAgcTile = kAgcRows * kAgcCh;

__device__ __forceinline__ void agc_step(float m, float& env, int& hang,
                                         float atk, float dec, int hang_n) {
  const bool rising = m > env;
  const float env_up = env + atk * (m - env);
  const float env_dn = hang > 0 ? env : env + dec * (m - env);
  env = rising ? env_up : env_dn;
  hang = rising ? hang_n : max(hang - 1, 0);
}

// VEC floats a copy (4 needs C % 4 == 0); MOVERS warps beside the serial one.
template <int VEC, int MOVERS>
__global__ void __launch_bounds__(32 + 32 * MOVERS)
agc_envelope_kernel(const float* __restrict__ mag_db,
                    float* __restrict__ env_seq, float* __restrict__ env_io,
                    int* __restrict__ hang_io, int N, int C, float atk,
                    float dec, int hang_n) {
  __shared__ __align__(16) float tiles[kAgcRing][kAgcTile];
  constexpr int kPerRow = kAgcCh / VEC;
  constexpr int kCopies = kAgcRows * kPerRow;
  constexpr int kMovers = 32 * MOVERS;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kAgcCh;
  const bool serial = tid < 32;
  const int mt = tid - 32;                  // index among the movers
  const int ntiles = (N + kAgcRows - 1) / kAgcRows;
  const bool live = serial && c0 + tid < C;

  float env = 0.f;
  int hang = 0;
  if (live) {
    env = env_io[c0 + tid];
    hang = hang_io[c0 + tid];
  }

  // start the copies of tile t; always one commit group a call
  auto load = [&](int t) {
    if (t < ntiles) {
      float* dst = tiles[t % kAgcRing];
      for (int e = mt; e < kCopies; e += kMovers) {
        const int row = e / kPerRow, q = e % kPerRow;
        const int n = t * kAgcRows + row, c = c0 + q * VEC;
        if (n < N && c < C) {
          const float* src = mag_db + (size_t)n * C + c;
          if (VEC == 4) cp_async16(dst + row * kAgcCh + q * 4, src);
          else cp_async4(dst + row * kAgcCh + q, src);
        }
      }
    }
    cp_async_commit();
  };
  // write tile t, which the chain has passed, as coalesced rows
  auto store = [&](int t) {
    const float* src = tiles[t % kAgcRing];
    for (int e = mt; e < kCopies; e += kMovers) {
      const int row = e / kPerRow, q = e % kPerRow;
      const int n = t * kAgcRows + row, c = c0 + q * VEC;
      if (n < N && c < C) {
        float* dst = env_seq + (size_t)n * C + c;
        if (VEC == 4)
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(
              src + row * kAgcCh + q * 4);
        else
          *dst = src[row * kAgcCh + q];
      }
    }
  };

  if (!serial) {
    for (int t = 0; t < kAgcAhead; ++t) load(t);
    cp_async_wait<kAgcAhead - 1>();          // tile 0 has landed
  }
  __syncthreads();
  for (int t = 0; t < ntiles + 1; ++t) {
    if (serial) {
      if (t < ntiles) {
        float* tp = tiles[t % kAgcRing] + tid;
        const int rows = min(kAgcRows, N - t * kAgcRows);
        if (rows == kAgcRows) {
#pragma unroll 16
          for (int r = 0; r < kAgcRows; ++r) {
            agc_step(tp[r * kAgcCh], env, hang, atk, dec, hang_n);
            tp[r * kAgcCh] = env;
          }
        } else {
          for (int r = 0; r < rows; ++r) {
            agc_step(tp[r * kAgcCh], env, hang, atk, dec, hang_n);
            tp[r * kAgcCh] = env;
          }
        }
      }
    } else {
      load(t + kAgcAhead);
      if (t >= 1) store(t - 1);
      cp_async_wait<kAgcAhead - 1>();        // tile t + 1 has landed
    }
    __syncthreads();
  }

  if (live) {
    env_io[c0 + tid] = env;
    hang_io[c0 + tid] = hang;
  }
}

// --- SAM PLL ---------------------------------------------------------------

constexpr int kPllCh = 32;        // channels per block = lanes of the serial warp
constexpr int kPllRows = 64;      // time rows per tile
constexpr int kPllRing = 3;       // tiles in shared memory
constexpr int kPllWorkers = 512;  // threads of the parallel stages (a), (c)
constexpr int kPllThreads = kPllWorkers + 32;
constexpr int kPllTile = kPllRows * kPllCh;
constexpr int kPllPerWorker = kPllTile / kPllWorkers;
constexpr int kPllSmem = kPllRing * kPllTile * (int)(sizeof(float2) + sizeof(float));
static_assert(kPllTile % kPllWorkers == 0, "a tile is shared out evenly");

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
// marks left by stage (a) in place of arg(z), which is at most pi
constexpr float kMarkZero = 8.0f;    // + signbit(re) + 2*signbit(im)
constexpr float kMarkDirect = 16.0f;

__device__ __forceinline__ float wrap_pi(float x) {
  return x > kPi ? x - kTwoPi : (x < -kPi ? x + kTwoPi : x);
}

// v = z * (cos(phase) - j*sin(phase)), as the reference forms it
__device__ __forceinline__ float2 derotate(float2 z, float phase) {
  float s, co;
  sincosf(phase, &s, &co);
  return make_float2(z.x * co - z.y * (-s), z.x * (-s) + z.y * co);
}

// arg(z), or the mark of a sample the chain must treat as the reference
__device__ __forceinline__ float arg_or_mark(float2 z) {
  if (z.x == 0.f && z.y == 0.f)
    return kMarkZero + (signbit(z.x) ? 1.f : 0.f) + (signbit(z.y) ? 2.f : 0.f);
  const float m = fmaxf(fabsf(z.x), fabsf(z.y));   // NaN only if both are
  if (!(m >= 1e-30f && m <= 1e30f) || isnan(z.x) || isnan(z.y))
    return kMarkDirect;
  return atan2f(z.y, z.x);
}

// The reference's own err: atan2 of the derotated sample.
__device__ __noinline__ float direct_err(float2 z, float phase) {
  const float2 v = derotate(z, phase);
  return atan2f(v.y, v.x);
}

// The reference's err for an exactly zero sample, without a branch.
// re(v) and im(v) are sums of two signed-zero products, and a sum of
// zeros is -0 only if both are; atan2(+-0, +0) = +-0 and atan2(+-0, -0)
// = +-pi.  The signs of sinf and cosf follow from a phase in [-pi_f,
// pi_f]: float pi and pi/2 lie just above pi and pi/2.
__device__ __forceinline__ float zero_err(float mark, float phase) {
  const bool sx = mark == kMarkZero + 1.f || mark == kMarkZero + 3.f;
  const bool sy = mark >= kMarkZero + 2.f;
  const bool ss = signbit(phase) != (fabsf(phase) == kPi);   // sin < 0
  const bool sc = fabsf(phase) >= kHalfPi;                   // cos < 0
  const bool re_neg = (sx != sc) && (sy != ss);     // x*co - y*(-s)
  const bool im_neg = (sx == ss) && (sy != sc);     // x*(-s) + y*co
  const float mag = re_neg ? kPi : 0.f;
  return im_neg ? -mag : mag;
}

// Stage (b): the chain over one tile, a lane a channel.  ``next`` is the
// phase before its wrap (|next| < 4), so that the wrap is off the chain:
// err needs only next, and the wrapped phase is needed two operations
// later.  MARKED is false for a tile in which stage (a) marked no sample.
template <bool MARKED>
__device__ __forceinline__ void pll_chain(const float2* zt, float* at,
                                          int rows, float g1, float g2,
                                          float fmax, float& next,
                                          float& freq) {
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    const float a = at[r * kPllCh];
    const float phase = wrap_pi(next);
    float err = wrap_pi(a - next);
    if (MARKED) {
      err = a >= kMarkZero ? zero_err(a, phase) : err;
      // rare: the formula itself, also for a zero sample at a phase
      // outside [-pi_f, pi_f] (a caller's state, or NaN)
      if (a >= kMarkDirect || (a >= kMarkZero && !(fabsf(phase) <= kPi)))
        err = direct_err(zt[r * kPllCh], phase);
    }
    at[r * kPllCh] = phase;
    float f2 = freq + g2 * err;
    const float clipped = fminf(fmaxf(f2, -fmax), fmax);
    freq = isnan(f2) ? f2 : clipped;
    next = (phase + g1 * err) + freq;
  }
}

__global__ void __launch_bounds__(kPllThreads)
sam_pll_kernel(const float2* __restrict__ z, float2* __restrict__ v,
               float* __restrict__ phase_io, float* __restrict__ freq_io,
               int N, int C, float g1, float g2, float fmax) {
  extern __shared__ float2 pll_smem[];
  float2* zs = pll_smem;                                  // [ring][tile]
  float* ap = reinterpret_cast<float*>(zs + kPllRing * kPllTile);
  // ap: arg(z) or mark, then phase[n]

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kPllCh;
  const bool serial = tid >= kPllWorkers;
  const int lane = tid & 31;
  const int tiles = (N + kPllRows - 1) / kPllRows;

  float next = 0.f, freq = 0.f;
  if (serial && c0 + lane < C) {
    next = phase_io[c0 + lane];
    freq = freq_io[c0 + lane];
  }

  int marked = 0;          // stage (a) of the last round marked a sample
  for (int round = 0; round < tiles + 2; ++round) {
    int marks = 0;
    if (serial) {
      const int t = round - 1;
      if (t >= 0 && t < tiles) {
        const float2* zt = zs + (t % kPllRing) * kPllTile + lane;
        float* at = ap + (t % kPllRing) * kPllTile + lane;
        const int rows = min(kPllRows, N - t * kPllRows);
        if (marked)
          pll_chain<true>(zt, at, rows, g1, g2, fmax, next, freq);
        else
          pll_chain<false>(zt, at, rows, g1, g2, fmax, next, freq);
      }
    } else {
      // (a) for tile `round`: start the loads, so that (c) below runs
      // while they are in flight
      float2 zin[kPllPerWorker];
      const bool load = round < tiles;
      if (load) {
#pragma unroll
        for (int j = 0; j < kPllPerWorker; ++j) {
          const int e = tid + j * kPllWorkers;
          const int n = round * kPllRows + e / kPllCh;
          const int c = c0 + e % kPllCh;
          zin[j] = (n < N && c < C) ? z[(size_t)n * C + c]
                                    : make_float2(1.f, 0.f);
        }
      }
      // (c) for tile round - 2
      const int t = round - 2;
      if (t >= 0) {
        const float2* zt = zs + (t % kPllRing) * kPllTile;
        const float* pt = ap + (t % kPllRing) * kPllTile;
#pragma unroll
        for (int j = 0; j < kPllPerWorker; ++j) {
          const int e = tid + j * kPllWorkers;
          const int n = t * kPllRows + e / kPllCh;
          const int c = c0 + e % kPllCh;
          if (n < N && c < C) v[(size_t)n * C + c] = derotate(zt[e], pt[e]);
        }
      }
      if (load) {
        float2* zt = zs + (round % kPllRing) * kPllTile;
        float* at = ap + (round % kPllRing) * kPllTile;
#pragma unroll
        for (int j = 0; j < kPllPerWorker; ++j) {
          const int e = tid + j * kPllWorkers;
          const float a = arg_or_mark(zin[j]);
          zt[e] = zin[j];
          at[e] = a;
          marks |= a >= kMarkZero;
        }
      }
    }
    marked = __syncthreads_or(marks);
  }

  if (serial && c0 + lane < C) {
    phase_io[c0 + lane] = wrap_pi(next);
    freq_io[c0 + lane] = freq;
  }
}

}  // namespace

extern "C" int agc_envelope_f32(const void* mag_db, void* env_seq,
                                void* env, void* hang, int N, int C,
                                float atk, float dec, int hang_n,
                                void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (C + kAgcCh - 1) / kAgcCh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(mag_db);
  float* out = static_cast<float*>(env_seq);
  float* e = static_cast<float*>(env);
  int* h = static_cast<int*>(hang);
  // 16-byte copies need rows that start on 16 bytes
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    agc_envelope_kernel<4, 3><<<blocks, 128, 0, st>>>(in, out, e, h, N, C, atk,
                                                      dec, hang_n);
  else
    agc_envelope_kernel<1, 7><<<blocks, 256, 0, st>>>(in, out, e, h, N, C, atk,
                                                      dec, hang_n);
  return (int)cudaGetLastError();
}

extern "C" int sam_pll_c64(const void* z, void* v, void* phase, void* freq,
                           int N, int C, float g1, float g2, float fmax,
                           void* stream) {
  if (N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sam_pll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPllSmem);
  if (err != cudaSuccess) return (int)err;
  sam_pll_kernel<<<(C + kPllCh - 1) / kPllCh, kPllThreads, kPllSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(z), static_cast<float2*>(v),
      static_cast<float*>(phase), static_cast<float*>(freq), N, C, g1, g2,
      fmax);
  return (int)cudaGetLastError();
}
