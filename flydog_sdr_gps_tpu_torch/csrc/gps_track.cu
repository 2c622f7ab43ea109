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
// 400 epochs) and a 0.2 MB code table.  Operations: about 30 a sample and
// row (a sincos, two products for the wipe-off, three replica lookups and
// eight accumulates), 2.4 GOP for 12 rows x 400 epochs, 0.035 ms at the
// float32 peak.  What this simple design pays instead is the recurrence:
// 400 epochs in a row, each a block-wide reduction and one thread's
// discriminators, on 12 of the 132 SMs.
//
// Design (a first, simple kernel): one block a row, 512 threads, a loop
// over the epochs inside the block.  An epoch: thread 0 derives the
// replica starts from the row's code phase; the block copies the row's
// 1027-chip window (the chips 1 ms spans, plus margin) into shared
// memory; a strided pass over the samples, where sample j of a replica
// starting at s is win[(s + j) >> 4] with BOC sign ((s + j) & 15) < 8 ?
// 1 : -1 (the reference's repeat(16) + dynamic_slice, without building
// the 16432-wide array); warp shuffles, then shared memory, reduce the
// eight sums; thread 0 runs the discriminators and loops; a barrier.
//
// Numerics follow the plain version (tracking.py:track_epochs_plain),
// which follows the reference:
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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNW = 1027;           // chips spanned by 1 ms + margin
constexpr int kTableRow = 4092;     // code-table floats a row (E1B_CODELEN)
constexpr int kFields = 9;          // outputs an epoch and row
constexpr float kTwoPi = 6.28318548f;

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

struct Epoch {
  float cph, cf, t_b;
  int i0, s_e, s_p, s_l;
};

__global__ void __launch_bounds__(kThreads)
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
  __shared__ float win[kNW];
  __shared__ float red[kWarps][8];
  __shared__ Epoch ep;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float cl = code_len[row];
  const int cl_int = (int)cl;
  const bool boc = boc_flag[row] > 0.f;
  const bool act = active[row] != 0;
  const int max_start = 16 * kNW - n;   // dynamic_slice clamps its start
  const float n_f = (float)n;
  const float* tab = table + (size_t)row * kTableRow;
  const size_t plane = (size_t)n_ep * nch;

  // the loop state lives in thread 0's registers
  float cp = 0.f, rate = 0.f, cph = 0.f, cf = 0.f, ipp = 0.f, qpp = 0.f;
  int s_half = 0;
  if (tid == 0) {
    cp = code_phase[row];
    rate = code_rate[row];
    cph = carr_phase[row];
    cf = carr_freq[row];
    ipp = ip_prev[row];
    qpp = qp_prev[row];
    s_half = __float2int_rn(corr_half[row] * 16.0f);
  }

  for (int e = 0; e < n_ep; ++e) {
    if (tid == 0) {
      const int i0 = (int)floorf(cp);
      const float f0 = cp - (float)i0;
      const int s_p = 16 + __float2int_rn(f0 * 16.0f);
      ep.cph = cph;
      ep.cf = cf;
      ep.i0 = i0;
      ep.s_p = min(max(s_p, 0), max_start);
      ep.s_e = min(max(s_p + s_half, 0), max_start);
      ep.s_l = min(max(s_p - s_half, 0), max_start);
      // the prompt splits at the window's internal code-period boundary
      ep.t_b = __fdiv_rn(__fsub_rn(cl, py_modf(cp, cl)), rate);
    }
    __syncthreads();
    const Epoch E = ep;
    for (int k = tid; k < kNW; k += kThreads)
      win[k] = tab[py_mod(E.i0 - 1 + k, cl_int)];
    __syncthreads();

    const float* x_ep = raw + (size_t)e * n;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = tid; j < n; j += kThreads) {
      const float x = x_ep[j];
      const float ph = fmaf((float)j, E.cf, E.cph);
      float sn, cs;
      sincosf(ph, &sn, &cs);
      const float xi = x * cs;          // I = x*cos
      const float xq = (-x) * sn;       // Q = -x*sin (mix by e^{-j ph})
      const int ae = E.s_e + j, ap = E.s_p + j, al = E.s_l + j;
      float ce = win[ae >> 4], cpr = win[ap >> 4], cl_ = win[al >> 4];
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
#pragma unroll
    for (int q = 0; q < 8; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[q] += __shfl_down_sync(0xffffffffu, s[q], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) red[warp][q] = s[q];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v = lane < kWarps ? red[lane][q] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        s[q] = v;
      }
    }
    if (tid == 0) {
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
      const float cn0 = __fdiv_rn(
          sq_sum(ip, qp), at_least_1e9(sq_sum(e_mag, l_mag)));
      const float vals[kFields] = {ip, qp, ip_pre, cp, qp_pre, new_cf, dll,
                                   pll, cn0};
      float* o = outs + (size_t)e * nch + row;
#pragma unroll
      for (int f = 0; f < kFields; ++f) o[f * plane] = vals[f];
      if (act) {
        cp = new_cp;
        rate = new_rate;
        cph = new_cph;
        cf = new_cf;
      }
      ipp = ip_l;
      qpp = qp_l;
    }
    // thread 0 writes ep for the next epoch only after every thread has
    // read this one (the barrier after the window load) and finished with
    // the shared sums (this barrier)
    __syncthreads();
  }
  if (tid == 0) {
    code_phase[row] = cp;
    code_rate[row] = rate;
    carr_phase[row] = cph;
    carr_freq[row] = cf;
    ip_prev[row] = ipp;
    qp_prev[row] = qpp;
  }
}

}  // namespace

// outs: (9, n_ep, nch) float32 in the order ip, qp, ip_pre, code_phase
// (epoch start), qp_pre, carr_freq (new), dll_err, pll_err, cn0.
extern "C" int gps_track_f32(const void* raw, const void* table,
                             void* code_phase, void* code_rate,
                             void* carr_phase, void* carr_freq, void* ip_prev,
                             void* qp_prev, const void* active,
                             const void* code_len, const void* boc,
                             const void* corr_half, void* outs, int nch,
                             int n_ep, int n, float g1, float g2, float gf,
                             float gd, float c_inv_n, float c_dop, float c_l1,
                             float c_rate, float fc, void* stream) {
  if (nch <= 0 || n_ep <= 0 || n <= 0 || n > 16 * kNW)
    return (int)cudaErrorInvalidValue;
  gps_track_kernel<<<nch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (const float*)table, (float*)code_phase,
      (float*)code_rate, (float*)carr_phase, (float*)carr_freq,
      (float*)ip_prev, (float*)qp_prev, (const uint8_t*)active,
      (const float*)code_len, (const float*)boc, (const float*)corr_half,
      (float*)outs, nch, n_ep, n, g1, g2, gf, gd, c_inv_n, c_dop, c_l1,
      c_rate, fc);
  return (int)cudaGetLastError();
}
