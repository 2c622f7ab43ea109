// The GPS/Galileo tracking bank: 12 E/P/L correlator rows over 1 ms epochs.
//
// Replaces the lax.scan of the JAX reference:
//   gps_track_f32  <- models/gps/tracking.py:track_epochs (lax.scan, :189-330)
//
// For each row and each epoch in turn: carrier wipe-off of the epoch's
// 16368 IF samples, early/prompt/late replicas from the row's code table
// (C/A tiled to 4092 chips, or the E1B memory code with its BOC(1,1)
// sub-chip sign), the eight sums ie, qe, ip, qp, ip_pre, qp_pre, il, ql,
// the discriminators and the loop updates.  Rows are independent; the
// epochs of a row are a recurrence.
//
// What bounds it on an H100.  Bytes are few: the IF chunk (26.2 MB for
// 400 epochs) and a 0.2 MB code table.  Operations: about 19 a sample and
// row (a sincos, the wipe-off, three replica lookups, six accumulates),
// 0.026 ms for 12 rows x 400 epochs at the float32 peak.  What a kernel
// pays instead is the recurrence: 400 epochs in a row, each a reduction
// over 16368 samples followed by one thread's discriminators and loops,
// whose result the next epoch's samples need.
//
// Design: a thread-block cluster of K = 8 blocks a row (kCluster), 512
// threads a block, the epochs in a loop inside.
// - Each block of a row takes 1/K of every epoch's samples (a range of
//   whole float4s; the ranges cover the epoch, so an epoch that K does
//   not divide leaves the last blocks one float4 short).  Its threads
//   load their next epoch's samples (at most two float4s a thread) into
//   registers while the current epoch runs.
// - The row's code table is copied into shared memory once a launch,
//   extended by a window's 1027 chips so that the chips an epoch spans
//   are a run that never wraps: chip k of the window is
//   ext[base + k], base = (i0 - 1) mod code_len.  Replica sample j of a
//   replica that starts at sub-chip s is ext[base + ((s + j) >> 4)] with
//   BOC sign ((s + j) & 8) ? -1 : 1 (the reference's repeat(16) and
//   dynamic_slice, without building the 16432-wide array).
// - The eight sums: a halving exchange of shuffles in each warp (9
//   shuffles for the eight, not 40), shared memory, warp 0 across the
//   warps; then warp 0 writes its block's eight partial sums into every
//   block of the cluster (distributed shared memory), one cluster barrier
//   an epoch.  Every block's thread 0 then adds the K partials in rank
//   order and runs the discriminators and loops itself: the same
//   operations on the same values, so every block of a row carries the
//   same loop state without a second barrier; the block of rank 0 writes
//   the outputs.  The partials are double-buffered by epoch parity: a
//   block can be one epoch ahead of another, never two, since each
//   epoch's barrier waits for all.
//
// What it still costs (chip_smoke.py --profile, 12 rows x 400 epochs on
// an NVIDIA H100 80GB HBM3 at 700 W): an epoch is about 4,700 clocks, of
// which the sample pass about 1,500; the rest is what the recurrence pays
// once an epoch whatever K is: thread 0's tail about 1,650, the cluster
// barrier (with the blocks' skew) about 1,000, the reductions about 550.
// K = 1, 2 and 4 were slower (2.87, 1.85, 1.37 ms against 1.16 at 8).
// Timed and not kept: 256 threads a block (slower at K = 4, no faster at
// K = 8); thread 0 waiting on an mbarrier that the other blocks arrive on
// remotely instead of the cluster barrier (3 % faster: the arrive's
// release cost what the wait saved).
//
// Numerics follow the plain version (tracking.py:track_epochs_plain),
// which follows the reference; only the order of the sums over samples
// differs from it:
// - the phase t*carr_freq + carr_phase reaches ~25,700 rad: accurate
//   sincosf (no fast intrinsics, no --use_fast_math), one fused
//   multiply-add as the reference's compiler forms it;
// - the loop updates are fmaf where the reference's compiler fuses a
//   product and an add, with its folded constants (tracking.py:
//   loop_constants), and __f*_rn (never contracted) elsewhere;
// - jnp.round is half to even: __float2int_rn;
// - jnp.mod / torch.remainder on floats take the divisor's sign:
//   py_modf (fmodf, then + b when the signs differ), not fmodf;
// - the guards replace a denominator under 1e-9 in magnitude by +1e-9,
//   whatever its sign, as the reference does;
// - ip_prev and qp_prev are written for every row, the other state
//   fields only for active rows.
//
// Built with -DGPS_TRACK_CLOCKS, the kernel also adds clock64()
// differences of the parts of an epoch (thread 0 of rank 0 and thread
// 160 of the last rank of every row) into a device array that
// gps_track_clocks copies out: the split that chip_smoke.py --profile
// prints.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;         // blocks a row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNW = 1027;           // chips spanned by 1 ms + margin
constexpr int kTableRow = 4092;     // code-table floats a row (E1B_CODELEN)
constexpr int kExt = kTableRow + kNW;
constexpr int kFields = 9;          // outputs an epoch and row
constexpr int kMaxQ = 16 * kNW / 4; // float4s of the longest epoch taken
// float4s a thread takes of an epoch, at most
constexpr int kQ = (kMaxQ + kCluster * kThreads - 1) / (kCluster * kThreads);
constexpr float kTwoPi = 6.28318548f;

#ifdef GPS_TRACK_CLOCKS
constexpr int kClk = 7;             // parts of an epoch
constexpr int kMaxRows = 64;        // rows the split keeps
__device__ long long g_clocks[kMaxRows][2][kClk];
#define CLK_START long long clk_last = clock64(), clk[kClk] = {};
#define CLK(k)                                     \
  {                                                \
    const long long t_ = clock64();                \
    clk[k] += t_ - clk_last;                       \
    clk_last = t_;                                 \
  }
#else
#define CLK_START
#define CLK(k)
#endif

__device__ __forceinline__ float py_modf(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

__device__ __forceinline__ int py_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float guard(float v) {
  return fabsf(v) < 1e-9f ? 1e-9f : v;
}

// clamp(min=1e-9) that lets a NaN through, as torch.clamp and
// jnp.maximum do
__device__ __forceinline__ float at_least_1e9(float v) {
  return v < 1e-9f ? 1e-9f : v;
}

__device__ __forceinline__ float sq_sum(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// The eight sums of a warp, reduced over its 32 lanes: lane l ends with
// the total of value l >> 2 (halving exchanges at offsets 16, 8, 4, then
// two xor steps: 9 shuffles where eight butterflies take 40).
__device__ __forceinline__ float warp_sum8(const float (&s)[8], int lane) {
  const unsigned full = 0xffffffffu;
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (u16 ? s[i + 4] : s[i]) +
           __shfl_xor_sync(full, u16 ? s[i] : s[i + 4], 16);
  float b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (u8 ? a[i + 2] : a[i]) +
           __shfl_xor_sync(full, u8 ? a[i] : a[i + 2], 8);
  float c = (u4 ? b[1] : b[0]) + __shfl_xor_sync(full, u4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(full, c, 2);
  c += __shfl_xor_sync(full, c, 1);
  return c;
}

struct Epoch {
  float cph, cf, t_b;
  int base, s_e, s_p, s_l;
};

// one sample's contribution to the eight sums
__device__ __forceinline__ void accumulate(float x, int j, const Epoch& E,
                                           const float* ext, bool boc,
                                           float (&s)[8]) {
  const float ph = fmaf((float)j, E.cf, E.cph);
  float sn, cs;
  sincosf(ph, &sn, &cs);
  const float xi = x * cs;          // I = x*cos
  const float xq = (-x) * sn;       // Q = -x*sin (mix by e^{-j ph})
  const int ae = E.s_e + j, ap = E.s_p + j, al = E.s_l + j;
  float ce = ext[E.base + (ae >> 4)], cpr = ext[E.base + (ap >> 4)],
        cl_ = ext[E.base + (al >> 4)];
  if (boc) {
    if (ae & 8) ce = -ce;
    if (ap & 8) cpr = -cpr;
    if (al & 8) cl_ = -cl_;
  }
  s[0] += xi * ce;
  s[1] += xq * ce;
  s[2] += xi * cpr;
  s[3] += xq * cpr;
  if ((float)j < E.t_b) {
    s[4] += xi * cpr;
    s[5] += xq * cpr;
  }
  s[6] += xi * cl_;
  s[7] += xq * cl_;
}

__device__ __forceinline__ void accumulate4(float4 v, int q, const Epoch& E,
                                            const float* ext, bool boc,
                                            float (&s)[8]) {
  const int j = 4 * q;
  accumulate(v.x, j, E, ext, boc, s);
  accumulate(v.y, j + 1, E, ext, boc, s);
  accumulate(v.z, j + 2, E, ext, boc, s);
  accumulate(v.w, j + 3, E, ext, boc, s);
}

__global__ void __launch_bounds__(kThreads, 1)
gps_track_kernel(const float* __restrict__ raw, const float* __restrict__ table,
                 float* __restrict__ code_phase, float* __restrict__ code_rate,
                 float* __restrict__ carr_phase, float* __restrict__ carr_freq,
                 float* __restrict__ ip_prev, float* __restrict__ qp_prev,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ code_len,
                 const float* __restrict__ boc_flag,
                 const float* __restrict__ corr_half,
                 float* __restrict__ outs, int nch, int n_ep, int n, float g1,
                 float g2, float gf, float gd, float c_inv_n, float c_dop,
                 float c_l1, float c_rate, float fc) {
  constexpr int K = kCluster;
  __shared__ float ext[kExt];
  __shared__ float red[kWarps][8];
  __shared__ float part[2][K][8];   // the cluster's partials, by parity
  __shared__ Epoch ep;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float cl = code_len[row];
  const int cl_int = (int)cl;
  const bool boc = boc_flag[row] > 0.f;
  const bool act = active[row] != 0;
  const int max_start = 16 * kNW - n;   // dynamic_slice clamps its start
  const float n_f = (float)n;
  const size_t plane = (size_t)n_ep * nch;
  const int n4 = n >> 2;
  const int q_lo = (int)((long long)n4 * rank / K);
  const int q_hi = (int)((long long)n4 * (rank + 1) / K);
  const float4* raw4 = reinterpret_cast<const float4*>(raw);

  // the row's code table, extended so that a window never wraps
  const float* tab = table + (size_t)row * kTableRow;
  for (int m = tid; m < cl_int + kNW; m += kThreads) ext[m] = tab[m % cl_int];

  // the loop state lives in thread 0's registers, in every block of the
  // cluster alike
  float cp = 0.f, rate = 0.f, cph = 0.f, cf = 0.f, ipp = 0.f, qpp = 0.f;
  int s_half = 0;
  auto plan = [&]() {                   // thread 0: the epoch's starts
    const int i0 = (int)floorf(cp);
    const float f0 = cp - (float)i0;
    const int s_p = 16 + __float2int_rn(f0 * 16.0f);
    ep.cph = cph;
    ep.cf = cf;
    ep.base = py_mod(i0 - 1, cl_int);
    ep.s_p = min(max(s_p, 0), max_start);
    ep.s_e = min(max(s_p + s_half, 0), max_start);
    ep.s_l = min(max(s_p - s_half, 0), max_start);
    // the prompt splits at the window's internal code-period boundary
    ep.t_b = __fdiv_rn(__fsub_rn(cl, py_modf(cp, cl)), rate);
  };
  if (tid == 0) {
    cp = code_phase[row];
    rate = code_rate[row];
    cph = carr_phase[row];
    cf = carr_freq[row];
    ipp = ip_prev[row];
    qpp = qp_prev[row];
    s_half = __float2int_rn(corr_half[row] * 16.0f);
    plan();
  }
  // every block of the cluster is running (its shared memory can be
  // written) and sees its table and first epoch
  cluster.sync();

  float4 xn[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int q = q_lo + tid + i * kThreads;
    if (q < q_hi) xn[i] = raw4[q];
  }
  CLK_START
  for (int e = 0; e < n_ep; ++e) {
    const Epoch E = ep;
    const float4* x4 = raw4 + (size_t)e * n4;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float4 xc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) xc[i] = xn[i];
    if (e + 1 < n_ep) {
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int q = q_lo + tid + i * kThreads;
        if (q < q_hi) xn[i] = x4[n4 + q];
      }
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int q = q_lo + tid + i * kThreads;
      if (q < q_hi) accumulate4(xc[i], q, E, ext, boc, s);
    }
    CLK(0)
    {
      const float v = warp_sum8(s, lane);
      if ((lane & 3) == 0) red[warp][lane >> 2] = v;
    }
    CLK(1)
    __syncthreads();
    CLK(2)
    const int par = e & 1;
    if (warp == 0) {
      // lanes 4q .. 4q+3 add value q of a quarter of the warps each
      float v = 0.f;
#pragma unroll
      for (int w = lane & 3; w < kWarps; w += 4) v += red[w][lane >> 2];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] = __shfl_sync(0xffffffffu, v, 4 * q);
      // lane r hands this block's partials to the block of rank r
      if (lane < K) {
        float* dst = cluster.map_shared_rank(&part[par][rank][0], lane);
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = s[q];
      }
    }
    CLK(3)
    cluster.sync();
    CLK(4)
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v = part[par][0][q];
#pragma unroll
        for (int r = 1; r < K; ++r) v += part[par][r][q];
        s[q] = v;
      }
      const float ie = s[0], qe = s[1], ip = s[2], qp = s[3];
      const float ip_pre = s[4], qp_pre = s[5], il = s[6], ql = s[7];
      // ---- discriminators ----
      const float e_mag = sqrtf(sq_sum(ie, qe));
      const float l_mag = sqrtf(sq_sum(il, ql));
      const float dll = __fdiv_rn(__fsub_rn(e_mag, l_mag),
                                  at_least_1e9(__fadd_rn(e_mag, l_mag)));
      // E1B rows feed the loops the dominant boundary partial
      const float qp_post = __fsub_rn(qp, qp_pre);
      const float ip_post = __fsub_rn(ip, ip_pre);
      const bool use_pre = sq_sum(ip_pre, qp_pre) >= sq_sum(ip_post, qp_post);
      const float ip_l = boc ? (use_pre ? ip_pre : ip_post) : ip;
      const float qp_l = boc ? (use_pre ? qp_pre : qp_post) : qp;
      // Costas and 2-quadrant FLL discriminators
      const float pll = atanf(__fdiv_rn(qp_l, guard(ip_l)));
      const float cross = __fsub_rn(__fmul_rn(ip_l, qpp), __fmul_rn(qp_l, ipp));
      const float dot = __fadd_rn(__fmul_rn(ip_l, ipp), __fmul_rn(qp_l, qpp));
      const float fll = atanf(__fdiv_rn(cross, guard(dot)));
      // ---- loop updates, as the reference's compiler forms them ----
      const float dfreq = fmaf(g2, pll, -__fmul_rn(gf, fll));
      const float new_cf = fmaf(dfreq, c_inv_n, cf);
      const float new_cph = py_modf(fmaf(g1, pll, fmaf(cf, n_f, cph)), kTwoPi);
      const float carr_dop = fmaf(new_cf, c_dop, -fc);
      const float new_rate = __fmul_rn(fmaf(carr_dop, c_l1, 1.0f), c_rate);
      const float new_cp = py_modf(fmaf(gd, dll, fmaf(rate, n_f, cp)), cl);
      if (rank == 0) {
        const float cn0 = __fdiv_rn(
            sq_sum(ip, qp), at_least_1e9(sq_sum(e_mag, l_mag)));
        const float vals[kFields] = {ip, qp, ip_pre, cp, qp_pre, new_cf, dll,
                                     pll, cn0};
        float* o = outs + (size_t)e * nch + row;
#pragma unroll
        for (int f = 0; f < kFields; ++f) o[f * plane] = vals[f];
      }
      if (act) {
        cp = new_cp;
        rate = new_rate;
        cph = new_cph;
        cf = new_cf;
      }
      ipp = ip_l;
      qpp = qp_l;
      // every thread of the block read this epoch's starts before it
      // arrived at the cluster barrier
      if (e + 1 < n_ep) plan();
    }
    CLK(5)
    __syncthreads();
    CLK(6)
  }
#ifdef GPS_TRACK_CLOCKS
  if (row < kMaxRows) {
    if (rank == 0 && tid == 0)
      for (int k = 0; k < kClk; ++k) g_clocks[row][0][k] = clk[k];
    if (rank == K - 1 && tid == 160)
      for (int k = 0; k < kClk; ++k) g_clocks[row][1][k] = clk[k];
  }
#endif
  if (rank == 0 && tid == 0) {
    code_phase[row] = cp;
    code_rate[row] = rate;
    carr_phase[row] = cph;
    carr_freq[row] = cf;
    ip_prev[row] = ipp;
    qp_prev[row] = qpp;
  }
}

cudaLaunchConfig_t cluster_config(int nch, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// outs: (9, n_ep, nch) float32 in the order ip, qp, ip_pre, code_phase
// (epoch start), qp_pre, carr_freq (new), dll_err, pll_err, cn0.  raw
// must be 16-byte aligned and n a multiple of 4.
extern "C" int gps_track_f32(const void* raw, const void* table,
                             void* code_phase, void* code_rate,
                             void* carr_phase, void* carr_freq, void* ip_prev,
                             void* qp_prev, const void* active,
                             const void* code_len, const void* boc,
                             const void* corr_half, void* outs, int nch,
                             int n_ep, int n, float g1, float g2, float gf,
                             float gd, float c_inv_n, float c_dop, float c_l1,
                             float c_rate, float fc, void* stream) {
  if (nch <= 0 || n_ep <= 0 || n <= 0 || n > 16 * kNW || n % 4 != 0 ||
      reinterpret_cast<uintptr_t>(raw) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config(nch, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gps_track_kernel, (const float*)raw, (const float*)table,
      (float*)code_phase, (float*)code_rate, (float*)carr_phase,
      (float*)carr_freq, (float*)ip_prev, (float*)qp_prev,
      (const uint8_t*)active, (const float*)code_len, (const float*)boc,
      (const float*)corr_half, (float*)outs, nch, n_ep, n, g1, g2, gf, gd,
      c_inv_n, c_dop, c_l1, c_rate, fc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of the kernel's clusters can be resident at once
// (cudaOccupancyMaxActiveClusters) for a bank of nch rows.
extern "C" int gps_track_max_clusters(int nch, void* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(nch, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(static_cast<int*>(out),
                                             gps_track_kernel, &cfg);
}

#ifdef GPS_TRACK_CLOCKS
// the clock64 split of the last launch: (rows, 2, 7) int64, rows <= 64
extern "C" int gps_track_clocks(void* out, int rows) {
  if (rows <= 0 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, g_clocks,
                                   sizeof(long long) * rows * 2 * kClk);
}
#endif
