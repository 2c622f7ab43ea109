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
// What bounds it on an H100: the read of y, 2.1 GB a block at C=4096
// (0.63 ms at 3.35 TB/s), with the tap arithmetic close behind (12.5 G
// FMA, 0.37 ms at the card's peak and 0.42 ms at its real clock).  The
// kernel nears the byte bound only if loads and FMAs overlap and the FMA
// pipe is fed from registers.  The design:
// - one thread per channel, 128 channels a block, so each warp moves 256
//   contiguous bytes of a row at a time;
// - samples reach the thread through a ring of kStages stages in shared
//   memory, filled with cp.async (8 bytes a thread: aligned for any C).
//   A stage is kChunk samples of each of kRows consecutive rows.  Each
//   thread copies the samples of its own channel and no other thread
//   reads them, so the ring needs no barrier: a thread waits for its
//   oldest copy group, consumes the stage and refills it.  36 KB a
//   block is in flight, and no sample waits in a register (a row held
//   in registers costs 62 of them, and the thread stalls on the row's
//   loads before every row);
// - the taps sit transposed in shared memory, [d][m2]: for a sample
//   index d the m2 taps that meet it are read with a few broadcast
//   128-bit loads into registers and then used for the kRows rows of the
//   stage, 2*m2*kRows FMAs whose operands are all registers.  (As FMA
//   operands from the constant bank, 3 KB of taps overrun the small
//   cache that feeds such operands, and the FMA pipe waits on it:
//   measured, 0.9 ms a block without any rotation;)
// - a transposed-form FIR: row r adds into the m2 accumulators of the
//   outputs r-m2+1 .. r; m2+kRows-1 complex accumulators live in
//   registers, kRows of which complete per group of rows;
// - each block walks a long run of outputs: the grid is one wave of two
//   blocks an SM (four fit), each channel tile's k range split evenly
//   among them, so there is no partial second wave, and at C=4096 a run
//   is 256 outputs whose m2-1 overlap rows cost 9 % more reads and FMAs
//   (18 % at runs of 128 outputs; shorter runs with more blocks an SM,
//   and longer runs with one, both measured slower);
// - each input element is rotated once: the exact phase word is taken
//   once per d2-sample row (uint64 arithmetic, which wraps safely
//   because 2^48 divides 2^64; cycles formed as the reference's
//   nco.limbs_to_cycles_f32 does), and the d2 samples of the row are
//   rotated by a running product with exp(-2*pi*j*dphi).
// (d2, m2) are template parameters for the two decimation plans:
// (31, 24) at 12 kHz and (4, 25) at 20.25 kHz.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kRows = 3;        // rows per group: the reuse of a tap load
constexpr int kChunk = 4;       // samples of each row in a stage
constexpr int kStages = 4;      // stages in the ring
constexpr int kMinRun = 32;     // fewest outputs a block walks
constexpr int kWave = 2;        // blocks per SM the grid is cut for
constexpr uint64_t kMask48 = (1ull << 48) - 1;

__device__ __forceinline__ void cp_async8(float2* smem, const float2* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
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

// shared memory of a block: the taps [D2][kPad], then the ring
template <int D2, int M2>
struct Smem {
  static constexpr int kPad = (M2 + 3) / 4 * 4;           // floats a tap row
  static constexpr int kStage = kRows * kChunk * kThreads;  // float2 a stage
  static constexpr int kBytes = D2 * kPad * (int)sizeof(float) +
                                kStages * kStage * (int)sizeof(float2);
};

template <int D2, int M2, bool ROTATE>
__global__ void __launch_bounds__(kThreads)
stage2_kernel(const float2* __restrict__ y, float2* __restrict__ out,
              const int64_t* __restrict__ phi0,
              const int64_t* __restrict__ dphi,
              const Taps<D2, M2> taps, int C, int k2, int run) {
  using S = Smem<D2, M2>;
  constexpr int kPad = S::kPad;
  constexpr int kChunks = (D2 + kChunk - 1) / kChunk;    // stages a group
  extern __shared__ float4 smem[];
  float* ht = reinterpret_cast<float*>(smem);
  float2* ring = reinterpret_cast<float2*>(ht + D2 * kPad);
  for (int e = threadIdx.x; e < D2 * kPad; e += kThreads) {
    const int d = e / kPad, i = e % kPad;
    ht[e] = i < M2 ? taps.h[i * D2 + d] : 0.f;
  }
  __syncthreads();

  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int k0 = blockIdx.y * run;
  if (c >= C) return;                              // ragged channel edge
  const int k_end = min(k0 + run, k2);             // ragged k edge
  const int r_end = k_end + M2 - 1;
  // unit u: chunk u % kChunks of the row group u / kChunks
  const int units = (r_end - k0 + kRows - 1) / kRows * kChunks;
  float2* mine = ring + threadIdx.x;

  // copy unit u of this thread's channel into its ring stage (a copy
  // group of its own, empty past the end so that the count stays in step)
  auto fetch = [&](int u) {
    if (u < units) {
      const int r = k0 + u / kChunks * kRows, d0 = u % kChunks * kChunk;
      float2* dst = mine + u % kStages * S::kStage;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int dd = 0; dd < kChunk; ++dd)
          if (d0 + dd < D2 && r + rr < r_end)
            cp_async8(dst + (rr * kChunk + dd) * kThreads,
                      y + ((size_t)(r + rr) * D2 + d0 + dd) * C + c);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) fetch(s);

  uint64_t ph0 = 0, dph = 0;
  float2 step = make_float2(1.f, 0.f);
  if (ROTATE) {
    ph0 = (uint64_t)phi0[c];
    dph = (uint64_t)dphi[c];
    step = rotator(dph);
  }

  // acc[j] holds output k = r - (M2 - 1) + j while the group of rows
  // r .. r + kRows - 1 is processed.  A row past r_end is never copied:
  // what its stage holds goes only into outputs past k_end, which are
  // never written.
  float2 acc[M2 + kRows - 1];
#pragma unroll
  for (int j = 0; j < M2 + kRows - 1; ++j) acc[j] = make_float2(0.f, 0.f);

  int u = 0;
  for (int r = k0; r < r_end; r += kRows) {
    float2 rot[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      rot[rr] = ROTATE ? rotator((ph0 + (uint64_t)(r + rr) * D2 * dph)
                                 & kMask48)
                       : make_float2(1.f, 0.f);
#pragma unroll 1
    for (int q = 0; q < kChunks; ++q, ++u) {
      cp_async_wait<kStages - 1>();                // unit u has landed
      const float2* stage = mine + u % kStages * S::kStage;
#pragma unroll
      for (int dd = 0; dd < kChunk; ++dd) {
        const int d = q * kChunk + dd;
        if (d < D2) {
          float h[kPad];
#pragma unroll
          for (int i = 0; i < kPad; i += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(ht + d * kPad + i);
            h[i] = t.x, h[i + 1] = t.y, h[i + 2] = t.z, h[i + 3] = t.w;
          }
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            float2 z = stage[(rr * kChunk + dd) * kThreads];
            if (ROTATE) {
              z = cmul(z, rot[rr]);
              rot[rr] = cmul(rot[rr], step);
            }
#pragma unroll
            for (int i = 0; i < M2; ++i) {
              acc[M2 - 1 - i + rr].x += h[i] * z.x;
              acc[M2 - 1 - i + rr].y += h[i] * z.y;
            }
          }
        }
      }
      fetch(u + kStages);                          // refill the stage
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int k = r + rr - (M2 - 1);
      if (k >= k0 && k < k_end) out[(size_t)k * C + c] = acc[rr];
    }
#pragma unroll
    for (int j = 0; j < M2 - 1; ++j) acc[j] = acc[j + kRows];
#pragma unroll
    for (int j = M2 - 1; j < M2 + kRows - 1; ++j)
      acc[j] = make_float2(0.f, 0.f);
  }
  cp_async_wait<0>();
}

template <int D2, int M2, bool ROTATE>
cudaError_t launch(const void* y, void* out, const void* phi0,
                   const void* dphi, const float* h2, int C, int k2,
                   cudaStream_t stream) {
  Taps<D2, M2> taps;
  for (int i = 0; i < M2 * D2; ++i) taps.h[i] = h2[i];
  const auto kernel = stage2_kernel<D2, M2, ROTATE>;
  constexpr int smem = Smem<D2, M2>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess) return err;
  // one wave of kWave blocks an SM, shared out among the channel tiles,
  // each block walking an equal run of outputs
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) return err;
  const int ctiles = (C + kThreads - 1) / kThreads;
  const int runs = std::max(1, sms * kWave / ctiles);
  const int run = std::max(kMinRun, (k2 + runs - 1) / runs);
  const dim3 grid(ctiles, (k2 + run - 1) / run);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float2*>(y), static_cast<float2*>(out),
      static_cast<const int64_t*>(phi0), static_cast<const int64_t*>(dphi),
      taps, C, k2, run);
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
