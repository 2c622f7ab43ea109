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
// What bounds it on an H100 is operations, not bytes: 7 operations a
// tap, stage and sample (2*64*7*N*C, 7.5 GFLOP a block when every
// channel has both stages on) against (N, C) float32 in and out.  The
// loop is sequential in time, so the parallelism is channels x taps.
//
// Design.  A block owns 32 neighbouring channels, so that a row of the
// (N, C) input is one 128-byte line; eight lanes share a channel, lane
// j holding taps j, j+8, ... of both stages' weights in registers (16
// floats).  The block walks the samples in tiles of kRows rows:
//   (1) all threads copy the tile's rows into shared memory, channel-
//       major, behind each channel's 80 carried samples, so that the
//       delay line is a window hist[n .. n+63] that slides by one a
//       sample and never has to be shifted;
//   (2) each group of eight lanes runs its channel's two stages over
//       the tile in runs of 16 samples, the notch over a run and then
//       the denoiser: the notch's output goes behind the denoiser's 80
//       carried samples and is read 17 steps later at the earliest, so
//       a run's denoiser windows are whole before the run starts.  A
//       lane holds the 72 samples its 16 windows cover in registers,
//       and takes all 16 norms before the chain, which is then eight
//       taps of prediction, three butterfly shuffles and the update.
//       Control flow is uniform over a warp (its four channels), so the
//       shuffles never meet a diverged warp: a stage runs if one of the
//       four has it on, and a channel that has it off takes x instead of
//       the stage's output and never stores the weights.  A warp whose
//       four channels have both stages off only copies;
//   (3) all threads write the tile's output rows, coalesced, and each
//       group moves its last 80 samples to the front.
// Weights are written back only where the stage is on.
//
// The chain is about 240 clocks a stage and sample, and every warp walks
// it at once, so a block of 2048 samples takes about 0.55 ms whether one
// channel has the chain on or all 4096 do (NVIDIA H100 80GB HBM3, 700 W;
// the repo's PERF.md has the numbers and the script that took them).

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 64;
constexpr int kDelay = 16;
constexpr int kLine = kTaps + kDelay;     // samples carried a stage
constexpr int kCh = 32;                   // channels a block
constexpr int kLanes = 8;                 // lanes a channel
constexpr int kPer = kTaps / kLanes;      // taps a lane and stage
constexpr int kThreads = kCh * kLanes;
constexpr int kRows = 64;                 // samples a tile
constexpr unsigned kWarp = 0xFFFFFFFFu;
// strides of a channel's rows in shared memory, = 8 mod 32, so that the
// four channels of a warp read four different sets of eight banks
constexpr int kHist = kLine + kRows + 24;
constexpr int kOut = kRows + 8;
constexpr int kSmem = kCh * (2 * kHist + kOut) * (int)sizeof(float);
static_assert(kHist % 32 == 8 && kOut % 32 == 8, "bank spread");
static_assert(kLine % kLanes == 0 && kRows % kDelay == 0, "even shares");

// One stage over a run of up to kDelay samples, for the eight lanes of a
// channel; the whole warp calls it together.  hist points at the first
// sample's window, xin at the run's inputs, out at where its outputs go
// (written by the group's lane 0): the stage's output where ``on``, else
// the input.
// The run's windows overlap, so a lane reads its kSpan samples of them
// once into registers; the norms, which depend on no weight, are all
// taken before the chain starts.  What is left on the chain a sample:
// four FMAs deep of the prediction, three butterfly shuffles, the error,
// the step size and one FMA a weight.  The step size mu / norm is taken
// with the fast division (2 ulp; norm >= 1e-3): the exact one hides a
// branch, which would keep the sixteen norms from overlapping.
template <bool NOTCH>
__device__ __forceinline__ void lms_run(const float* hist, const float* xin,
                                        float* out, int nrows, bool on,
                                        float (&w)[kPer], int sub,
                                        float decay, float mu) {
  constexpr int kSpan = kDelay + kLanes * (kPer - 1);
  float h[kSpan], x[kDelay], step[kDelay];
#pragma unroll
  for (int m = 0; m < kSpan; ++m) h[m] = hist[sub + m];
#pragma unroll
  for (int i = 0; i < kDelay; ++i) x[i] = xin[i];
#pragma unroll
  for (int i = 0; i < kDelay; ++i) {
    float norm = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      norm = fmaf(h[i + kLanes * j], h[i + kLanes * j], norm);
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      norm += __shfl_xor_sync(kWarp, norm, o);
    step[i] = __fdividef(mu, norm + 1e-3f);
  }
#pragma unroll
  for (int i = 0; i < kDelay; ++i) {
    if (i < nrows) {
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; j += 2) {
        p0 = fmaf(w[j], h[i + kLanes * j], p0);
        p1 = fmaf(w[j + 1], h[i + kLanes * (j + 1)], p1);
      }
      float pred = p0 + p1;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        pred += __shfl_xor_sync(kWarp, pred, o);
      const float err = x[i] - pred;
      const float g = step[i] * err;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        w[j] = decay * w[j] + g * h[i + kLanes * j];
      if (sub == 0) out[i] = on ? (NOTCH ? err : pred) : x[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lms_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                 float* __restrict__ w_notch, float* __restrict__ line_notch,
                 float* __restrict__ w_den, float* __restrict__ line_den,
                 const unsigned char* __restrict__ en_notch,
                 const unsigned char* __restrict__ en_den, int N, int C,
                 float decay_n, float mu_n, float decay_d, float mu_d) {
  extern __shared__ float lms_smem[];
  float* h1 = lms_smem;                      // [kCh][kHist] notch input
  float* h2 = h1 + kCh * kHist;              // [kCh][kHist] denoiser input
  float* ot = h2 + kCh * kHist;              // [kCh][kOut]  output tile

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCh;
  // compute role: a group of eight lanes a channel
  const int g_ch = tid / kLanes;
  const int sub = tid % kLanes;
  const int c = c0 + g_ch;
  const bool live = c < C;
  const bool on_n = live && en_notch[c] != 0;
  const bool on_d = live && en_den[c] != 0;
  // a warp's four channels walk the same code
  const bool any_n = __any_sync(kWarp, on_n);
  const bool any_d = __any_sync(kWarp, on_d);
  float* h1c = h1 + g_ch * kHist;
  float* h2c = h2 + g_ch * kHist;
  float* otc = ot + g_ch * kOut;
  // copy role: a lane a channel, a warp a row
  const int m_ch = tid % kCh;
  const int m_row = tid / kCh;
  constexpr int kRowStep = kThreads / kCh;

  float wn[kPer], wd[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    wn[j] = on_n ? w_notch[(size_t)(sub + kLanes * j) * C + c] : 0.f;
    wd[j] = on_d ? w_den[(size_t)(sub + kLanes * j) * C + c] : 0.f;
  }
  // the carried lines go in front of the first tile
  for (int i = m_row; i < kLine; i += kRowStep) {
    const bool ok = c0 + m_ch < C;
    h1[m_ch * kHist + i] = ok ? line_notch[(size_t)i * C + c0 + m_ch] : 0.f;
    h2[m_ch * kHist + i] = ok ? line_den[(size_t)i * C + c0 + m_ch] : 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += kRows) {
    const int rows = min(kRows, N - n0);
    // (1) the tile's input rows
    for (int r = m_row; r < rows; r += kRowStep)
      h1[m_ch * kHist + kLine + r] =
          c0 + m_ch < C ? x[(size_t)(n0 + r) * C + c0 + m_ch] : 0.f;
    __syncthreads();

    // (2) the two stages over the tile
    if (!any_n && !any_d) {
      for (int r = sub; r < rows; r += kLanes) {
        const float v = h1c[kLine + r];
        h2c[kLine + r] = v;
        otc[r] = v;
      }
    } else {
      // runs of kDelay samples: the notch over the run, then the
      // denoiser, whose windows end before the run's own notch output
      for (int r0 = 0; r0 < rows; r0 += kDelay) {
        const int n = min(kDelay, rows - r0);
        float* y1 = h2c + kLine + r0;
        if (any_n) {
          lms_run<true>(h1c + r0, h1c + kLine + r0, y1, n, on_n, wn, sub,
                        decay_n, mu_n);
        } else {
          for (int i = sub; i < n; i += kLanes) y1[i] = h1c[kLine + r0 + i];
        }
        __syncwarp();
        if (any_d) {
          lms_run<false>(h2c + r0, y1, otc + r0, n, on_d, wd, sub, decay_d,
                         mu_d);
        } else {
          for (int i = sub; i < n; i += kLanes) otc[r0 + i] = y1[i];
        }
      }
    }
    __syncwarp();
    // the last kLine samples move to the front (they may overlap)
    float k1[kLine / kLanes], k2[kLine / kLanes];
#pragma unroll
    for (int i = 0; i < kLine / kLanes; ++i) {
      k1[i] = h1c[rows + sub + kLanes * i];
      k2[i] = h2c[rows + sub + kLanes * i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLine / kLanes; ++i) {
      h1c[sub + kLanes * i] = k1[i];
      h2c[sub + kLanes * i] = k2[i];
    }
    // (3) the tile's output rows
    for (int r = m_row; r < rows; r += kRowStep)
      if (c0 + m_ch < C)
        y[(size_t)(n0 + r) * C + c0 + m_ch] = ot[m_ch * kOut + r];
    __syncthreads();
  }

  // carries out: lines always, weights where the stage adapted
  for (int i = m_row; i < kLine; i += kRowStep) {
    if (c0 + m_ch < C) {
      line_notch[(size_t)i * C + c0 + m_ch] = h1[m_ch * kHist + i];
      line_den[(size_t)i * C + c0 + m_ch] = h2[m_ch * kHist + i];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (on_n) w_notch[(size_t)(sub + kLanes * j) * C + c] = wn[j];
    if (on_d) w_den[(size_t)(sub + kLanes * j) * C + c] = wd[j];
  }
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
  cudaError_t err = cudaFuncSetAttribute(
      lms_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  lms_chain_kernel<<<(C + kCh - 1) / kCh, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(w_notch), static_cast<float*>(line_notch),
      static_cast<float*>(w_den), static_cast<float*>(line_den),
      static_cast<const unsigned char*>(en_notch),
      static_cast<const unsigned char*>(en_den), N, C, decay_n, mu_n,
      decay_d, mu_d);
  return (int)cudaGetLastError();
}
