// The LMS autonotch -> denoiser chain of the audio back half.
//
// Replaces the lax.scan of the JAX reference's ops/noise.py:
// lms_chain_block (:296; the single stage is lms_block, :260).  Per
// channel and sample, two normalised-LMS stages in a row:
//   ref  = the 64 oldest samples of the stage's 80-sample delay line
//   pred = sum(w * ref);  err = x - pred;  norm = sum(ref^2) + 1e-3
//   w    = decay*w + (mu/norm)*err*ref          (where the stage is on)
//   out  = err (notch) or pred (denoiser) where on, else x
// and the line takes x.  A stage that is off passes its input through
// and does not adapt, but its delay line still advances.
//
// What bounds the function on an H100 is operations, not bytes (5 a tap,
// stage and sample against (N, C) float32 in and out); what bounded the
// first kernel was neither: the latency of one sample's chain (predict,
// reduce over lanes, step, update the weights the next sample reads),
// walked 2 * N times in a row by every warp.
//
// Design.
//   A warp a stage.  A block owns 32 neighbouring channels.  Its first
//   half of warps runs the notch, the second half the denoiser, one run
//   of 16 samples behind: denoiser warp p takes what notch warp p left
//   in shared memory, and the two meet once a run at a named barrier of
//   their own (bar.sync id, 64), never at __syncthreads.  The two
//   stages' chains overlap instead of following each other.
//   The weights off the chain.  L = 4 lanes share a channel, lane j
//   holding taps 16 j .. 16 j + 15 of the stage's weights in registers.
//   Inside a group of B = 2 samples the recurrence is unrolled exactly
//   (in real numbers):
//     pred[b] = decay^b (w0.h_b) + sum_{k<b} decay^(b-1-k) g[k] (h_k.h_b)
//     g[k]    = mu / (h_k.h_k + 1e-3) * (x[k] - pred[k])
//     w_B     = decay^B w0 + sum_k decay^(B-1-k) g[k] h_k
//   with w0 the weights at the group's start.  The B products w0.h_b
//   are taken side by side and reduced over the lanes together; the
//   window products h_k.h_b at lag d slide by one sample a step (one
//   product in, one out) and are summed directly at the start of every
//   run, so no error builds up beyond 16 steps; every lane keeps them,
//   so the scalar part of the chain needs no broadcast.  The weights
//   are read once and written once a group.
//   No block-wide tiles.  A channel's samples live in a ring of 128
//   floats a stage in shared memory, every sample stored twice, 128
//   apart, so that any window of up to 128 samples is read linearly.
//   The notch warp copies its own channels' inputs from x into the ring
//   with cp.async, two runs ahead; the denoiser warp writes y from
//   registers, every lane its share of a run after the run (a store a
//   sample inside the chain became a divergent branch a sample and cost
//   as much as the arithmetic).
//   Control flow is uniform over a warp (its 8 channels) and the
//   shuffles are full-mask: a stage runs if one of the warp's channels
//   has it on; a channel that has it off takes x instead of the stage's
//   output and never stores the weights.  A warp with the stage off for
//   all its channels only copies.  The step size uses the fast division
//   (2 ulp; the norm is at least 1e-3).
//
// What it still costs (clock64 in a throw-away harness, one pair alone):
// a group of two samples 283 clocks, of which about 170 are the chain
// (the dot products' last adds, two shuffle rounds, the two errors and
// steps) and 112 the issuing of the taps' 96 multiply-adds, which wait for
// the chain's end and feed its start, so nothing overlaps them in one
// warp; a run another 1470 clocks on top of its eight groups (21 loads
// and the direct sums before the chain, the stores, the meeting).  With
// every channel on, a scheduler has two such warps and runs at an IPC of
// 0.57.  Timed and not kept: L = 8 (four warps a
// scheduler, but twice the scalar work a channel), L = 2, B = 4, runs of
// 32, direct sums every fourth run, a rolled loop of groups (the
// unrolled run is 16 KB of code a stage; rolling it made it slower).
//
// Rounding differs from the sample-by-sample loop (algebraic, not
// bitwise): the slid norms and lag products carry up to 32 roundings of
// the largest window energy in the run.  The repo's PERF.md has the
// times, the error against the plain version and the script that took
// them (NVIDIA H100 80GB HBM3).

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 64;
constexpr int kDelay = 16;
constexpr int kLine = kTaps + kDelay;     // samples carried a stage
constexpr int kCh = 32;                   // channels a block
constexpr int kLanes = 4;                 // lanes a channel
constexpr int kPer = kTaps / kLanes;      // taps a lane, neighbours
constexpr int kGroup = 2;                 // samples the chain takes at once
constexpr int kRun = 16;                  // samples between two meetings
constexpr int kRing = 128;                // samples a ring holds
// a channel's ring, stored twice; = 8 mod 32 floats, so that the
// channels of a warp start in different banks
constexpr int kStride = 2 * kRing + 8;
constexpr unsigned kWarp = 0xFFFFFFFFu;
static_assert(kStride % 32 == 8 && kStride % 4 == 0, "bank spread, float4");
static_assert(kLine + 3 * kRun <= kRing, "a window, its run, two ahead");

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// 4 bytes from device memory into shared memory, asynchronously; zeros
// where ``ok`` is false
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// the sum over a channel's lanes, in all of them
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kWarp, v, o);
  return v;
}

// One stage over a run of kRun samples (B > 1: all of them; B == 1: the
// first nrows), for the lanes of a channel; the whole warp calls it
// together.  hist points at the window of the run's first sample: 64
// taps, then the 16 samples between, then the run's inputs at hist[80].
// The notch writes its outputs to both halves of the denoiser's ring at
// out, the denoiser to y at out with a stride of C; ``on`` chooses the
// stage's output over the input.
template <bool NOTCH, int B>
__device__ __forceinline__ void lms_run(const float* hist, float* out, int C,
                                        int nrows, bool on, bool live,
                                        float (&w)[kPer], int sub,
                                        float decay, float mu) {
  constexpr int L = kLanes;
  constexpr int P = kPer;
  constexpr int S = P + kRun;              // samples its windows cover
  static_assert(S % 4 == 0 && P % 2 == 0 && kRun % B == 0, "shares");
  float hl[S];                             // hist[P*sub ..]
  float hx[kDelay + kRun];                 // hist[64 ..]: entering, x
  float lo[kRun + 4];                      // hist[0 ..]: leaving
  {
    const float4* p = reinterpret_cast<const float4*>(hist + P * sub);
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 v = p[q];
      hl[4 * q] = v.x; hl[4 * q + 1] = v.y;
      hl[4 * q + 2] = v.z; hl[4 * q + 3] = v.w;
    }
    const float4* px = reinterpret_cast<const float4*>(hist + kTaps);
#pragma unroll
    for (int q = 0; q < (kDelay + kRun) / 4; ++q) {
      const float4 v = px[q];
      hx[4 * q] = v.x; hx[4 * q + 1] = v.y;
      hx[4 * q + 2] = v.z; hx[4 * q + 3] = v.w;
    }
    const float4* pl = reinterpret_cast<const float4*>(hist);
#pragma unroll
    for (int q = 0; q < (kRun + 4) / 4; ++q) {
      const float4 v = pl[q];
      lo[4 * q] = v.x; lo[4 * q + 1] = v.y;
      lo[4 * q + 2] = v.z; lo[4 * q + 3] = v.w;
    }
  }
  float mine[kRun / L];                    // outputs sub, sub + L, ...
  float dp[B + 1];                         // powers of the leakage
  dp[0] = 1.f;
#pragma unroll
  for (int k = 1; k <= B; ++k) dp[k] = dp[k - 1] * decay;

  // R[d] = h_i . h_(i+d), summed directly for the run's first sample
  float R[B];
#pragma unroll
  for (int d = 0; d < B; ++d) {
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int t = 0; t < P; t += 2) {
      p0 = fmaf(hl[t], hl[t + d], p0);
      p1 = fmaf(hl[t + 1], hl[t + 1 + d], p1);
    }
    R[d] = lanes_sum(p0 + p1);
  }

#pragma unroll
  for (int i0 = 0; i0 < kRun; i0 += B) {
    if (B > 1 || i0 < nrows) {
      // the predictions from the group's first weights, side by side
      float a[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int t = 0; t < P; t += 2) {
          p0 = fmaf(w[t], hl[i0 + b + t], p0);
          p1 = fmaf(w[t + 1], hl[i0 + b + t + 1], p1);
        }
        a[b] = p0 + p1;
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int b = 0; b < B; ++b) a[b] += __shfl_xor_sync(kWarp, a[b], o);
      }
      // the scalar chain, the same in every lane
      float g[B];
      float cr[B][B];                      // cr[k][d] = h_(i0+k) . h_(i0+k+d)
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int i = i0 + b;
        const float step = __fdividef(mu, R[0] + 1e-3f);
#pragma unroll
        for (int d = 1; d < B - b; ++d) cr[b][d] = R[d];
        float pred = dp[b] * a[b];
#pragma unroll
        for (int k = 0; k < b; ++k)
          pred = fmaf(dp[b - 1 - k] * cr[k][b - k], g[k], pred);
        const float xi = hx[kDelay + i];
        const float err = xi - pred;
        g[b] = step * err;
        const float v = on ? (NOTCH ? err : pred) : xi;
        if (sub == i % L) mine[i / L] = v;   // a select, not a branch
        // the window moves on by one sample
#pragma unroll
        for (int d = 0; d < B; ++d)
          R[d] = fmaf(hx[i], hx[i + d], fmaf(-lo[i], lo[i + d], R[d]));
      }
      float G[B];
#pragma unroll
      for (int b = 0; b < B; ++b) G[b] = dp[B - 1 - b] * g[b];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        float v = dp[B] * w[t];
#pragma unroll
        for (int b = 0; b < B; ++b) v = fmaf(G[b], hl[i0 + b + t], v);
        w[t] = v;
      }
    }
  }
  // every lane stores its share of the run's outputs: a store a sample
  // inside the chain was a divergent branch a sample
#pragma unroll
  for (int k = 0; k < kRun / L; ++k) {
    const int i = k * L + sub;
    if (NOTCH) {
      out[i] = mine[k];
      out[i + kRing] = mine[k];
    } else if (live && i < nrows) {
      out[(size_t)i * C] = mine[k];
    }
  }
}

__global__ void __launch_bounds__(kCh * kLanes * 2)
lms_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 float* __restrict__ w_notch, float* __restrict__ line_notch,
                 float* __restrict__ w_den, float* __restrict__ line_den,
                 const unsigned char* __restrict__ en_notch,
                 const unsigned char* __restrict__ en_den, int N, int C,
                 float decay_n, float mu_n, float decay_d, float mu_d) {
  extern __shared__ __align__(16) float lms_smem[];
  constexpr int L = kLanes, B = kGroup, CH = kCh, P = kPer;
  constexpr int kWch = 32 / L;             // channels a warp
  constexpr int kPairs = CH / kWch;        // warps a stage
  constexpr int kPre = kRun * kWch / 32;   // inputs a lane copies a run
  static_assert(kPairs <= 15, "a named barrier a pair");

  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const bool den = wi >= kPairs;
  // the two warps of a pair share a scheduler (a warp's scheduler is its
  // number mod 4, and kPairs is 4): on
  // different schedulers one pair alone is a fifth faster, but a card
  // full of pairs 5 % slower
  const int pair = den ? wi - kPairs : wi;
  const int sub = lane % L;
  const int chl = pair * kWch + lane / L;  // channel within the block
  const int cw0 = blockIdx.x * CH + pair * kWch;   // the warp's first
  const int c = blockIdx.x * CH + chl;
  const bool live = c < C;
  const bool on = live && (den ? en_den[c] : en_notch[c]) != 0;
  const bool any = __any_sync(kWarp, on);  // the warp walks one code path
  const float decay = den ? decay_d : decay_n;
  const float mu = den ? mu_d : mu_n;
  float* wsrc = den ? w_den : w_notch;
  float* lsrc = den ? line_den : line_notch;

  float* rings_n = lms_smem;               // [CH][kStride] notch input
  float* rings_d = lms_smem + CH * kStride;  // [CH][kStride] denoiser input
  // the warp's own stage: its channel's ring, and its channels' rings
  float* ring_in = (den ? rings_d : rings_n) + chl * kStride;
  float* wring = (den ? rings_d : rings_n) + pair * kWch * kStride;
  float* ring_out = rings_d + chl * kStride;       // the notch's outputs
  float* xring = rings_n + pair * kWch * kStride;  // the notch's inputs

  float w[P];
#pragma unroll
  for (int t = 0; t < P; ++t)
    w[t] = on ? wsrc[(size_t)(P * sub + t) * C + c] : 0.f;
  // the carried line is samples -80 .. -1 of the ring
  for (int idx = lane; idx < kLine * kWch; idx += 32) {
    const int row = idx / kWch, cc = idx % kWch;
    const float v = cw0 + cc < C ? lsrc[(size_t)row * C + cw0 + cc] : 0.f;
    const int pos = (row - kLine) & (kRing - 1);
    wring[cc * kStride + pos] = v;
    wring[cc * kStride + pos + kRing] = v;
  }

  const int runs = (N + kRun - 1) / kRun;
  // run r of the warp's channels, from x into both halves of their rings
  auto fetch = [&](int r) {
    if (r < runs) {
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int idx = lane + 32 * k;
        const int n = r * kRun + idx / kWch, cc = idx % kWch;
        const bool ok = n < N && cw0 + cc < C;
        const float* src = ok ? x + (size_t)n * C + cw0 + cc : x;
        float* dst = xring + cc * kStride + (n & (kRing - 1));
        copy_async(dst, src, ok);
        copy_async(dst + kRing, src, ok);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // two runs are in flight: a window and the two runs ahead of it fit
  // the ring
  if (!den) {
    fetch(0);
    fetch(1);
  }

  // step t: the notch warp works on run t, the denoiser warp on run t-1
  for (int t = 0; t <= runs; ++t) {
    const int r = den ? t - 1 : t;
    if (r >= 0 && r < runs) {
      const int n0 = r * kRun;
      const int nrows = min(kRun, N - n0);
      const float* hist = ring_in + ((n0 - kLine) & (kRing - 1));
      if (!den) {
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        __syncwarp();
        fetch(r + 2);
        float* out = ring_out + (n0 & (kRing - 1));
        if (!any) {
          for (int i = sub; i < kRun; i += L) {
            const float v = hist[kLine + i];
            out[i] = v;
            out[i + kRing] = v;
          }
        } else if (B > 1 && nrows == kRun) {
          lms_run<true, B>(hist, out, C, nrows, on, live, w, sub, decay,
                              mu);
        } else {
          lms_run<true, 1>(hist, out, C, nrows, on, live, w, sub, decay,
                              mu);
        }
      } else {
        float* out = y + (size_t)n0 * C + c;
        if (!any) {
          for (int i = sub; i < nrows; i += L)
            if (live) out[(size_t)i * C] = hist[kLine + i];
        } else if (B > 1 && nrows == kRun) {
          lms_run<false, B>(hist, out, C, nrows, on, live, w, sub, decay,
                               mu);
        } else {
          lms_run<false, 1>(hist, out, C, nrows, on, live, w, sub, decay,
                               mu);
        }
      }
    }
    pair_sync(1 + pair);
  }


  // carries out: lines always, weights where the stage adapted
  for (int idx = lane; idx < kLine * kWch; idx += 32) {
    const int row = idx / kWch, cc = idx % kWch;
    const int pos = (N - kLine + row) & (kRing - 1);
    if (cw0 + cc < C)
      lsrc[(size_t)row * C + cw0 + cc] = wring[cc * kStride + pos];
  }
#pragma unroll
  for (int t = 0; t < P; ++t)
    if (on) wsrc[(size_t)(P * sub + t) * C + c] = w[t];
}

}  // namespace

// x (N, C) -> y (N, C); weights (64, C) and lines (80, C) are updated in
// place; en_* are (C,) bytes, non-zero = stage on.
extern "C" int lms_chain_f32(const void* x, void* y, void* w_notch,
                             void* line_notch, void* w_den, void* line_den,
                             const void* en_notch, const void* en_den, int N,
                             int C, int taps, int delay, float decay_n,
                             float mu_n, float decay_d, float mu_d,
                             void* stream) {
  if (N <= 0 || C <= 0 || taps != kTaps || delay != kDelay)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = 2 * kCh * kStride * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lms_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lms_chain_kernel<<<(C + kCh - 1) / kCh, kCh * kLanes * 2, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(w_notch), static_cast<float*>(line_notch),
      static_cast<float*>(w_den), static_cast<float*>(line_den),
      static_cast<const unsigned char*>(en_notch),
      static_cast<const unsigned char*>(en_den), N, C, decay_n, mu_n,
      decay_d, mu_d);
  return (int)cudaGetLastError();
}
