// RWKV6 WKV backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The gradient of the forward in wkv.cu (which replaces the Pallas TPU
// kernel src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:86 wkv_kernel; the
// reference differentiates its plain chunked form).  Per (batch, head),
// with w_t = exp(clamp(lw_t, -4.6, 0)), the state S_t = diag(w_t) S_{t-1} +
// k_t^T v_t from S_0 = 0, and G_t = dL/dS_t starting from the final
// state's gradient (zero when none is given):
//   dr_t[i]  = u[i] k_t[i] (v_t . dout_t) + (S_{t-1} dout_t)[i]
//   dk_t[i]  = r_t[i] u[i] (v_t . dout_t) + (G_t v_t)[i]
//   dv_t[j]  = (sum_i r_t[i] u[i] k_t[i]) dout_t[j] + (G_t^T k_t)[j]
//   du[i]    = sum_{b,t} r_t[i] k_t[i] (v_t . dout_t)
//   G_{t-1}  = diag(w_t) G_t + r_t^T dout_t
// and the log-decay's gradient w_t[i] sum_j G_t[i, j] S_{t-1}[i, j] in its
// cumulative form (zero where lw_t lies outside the clamp):
//   dlog_w_t[i] = sum_j dS_T[i, j] S_T[i, j]
//               + sum_{t' > t} r_t'[i] (S_{t'-1} dout_t')[i]
//               - sum_{t' >= t} k_t'[i] (G_t' v_t')[i].
// Inputs r/k/v/log_w/dout are float32 (B,T,H,K), read in place through
// their strides (rows of 64 floats as 16-byte vectors, the forward's
// layout rule); u (H,K) and the final state (B,H,K,K) contiguous.  K = 64
// only; the chunk limit (<= 64) is the forward's.
//
// Bound on an H100 SXM at one node's training slice (B=40, T=512, H=64):
// the function reads r, k, v, log_w and dout and writes dr, dk, dv and
// dlog_w, 9 x 335.5 MB = 3.02 GB, 0.90 ms at 3.35 TB/s.  Its operations:
// the chunked form below does 5 K^2 + 6 C K = 32.8 K multiply-adds per
// token and head (C = 32) on the tensor cores, 85.9 GFLOP, 0.17 ms at the
// dense TF32 rate (495 TFLOP/s), 0.52 ms as three TF32 products each; the
// recurrence form's 12 K^2 operations, 64.4 GFLOP, take 0.96 ms at the
// float32 rate off the tensor cores (v1 ran them there).  It is bound by
// bytes.
//
// Design (v2; v1 walked all T steps twice, one state row or column per
// thread on the CUDA cores).  Chunk-parallel, as the forward: within a
// chunk of kChunk = 32 steps (whatever the forward's chunk, so the
// mid-point exponents stay within +-73.6), with L the inclusive cumulative
// clamped log-decay, L_p = L - lw, L_C its last row and L_m = L_C / 2,
// kn = k exp(L_m - L), rr = r exp(L_p - L_m), VD[t, s] = dout_t . v_s and
// A[t, s] = rr_t . kn_s for s < t (plain form: ref.py::wkv_backward_chunked):
//   * wkv_bwd_state_kernel, chunks forward, grid B*H: the state S_c entering
//     the chunk lives in shared memory;
//       dr_state = exp(L_p) (dout S_c^T) + exp(L_p - L_m) (VD kn)
//     goes to dr, then S <- exp(L_C) S + (k exp(L_C - L))^T v.
//   * wkv_bwd_grad_kernel, chunks backward, grid B*H: the gradient G_c of
//     the state leaving the chunk lives in shared memory;
//       dk_state = exp(L_C - L) (v G_c^T) + exp(L_m - L) (VD^T rr)
//       dv       = (r . u . k) dout + (k exp(L_C - L)) G_c + A^T dout
//     then G <- exp(L_C) G + (r exp(L_p))^T dout.  dr and dk add their
//     bonus terms; r dr_state and k dk_state are dlog_w's two terms, whose
//     running suffix sum (from sum_j dS_T S_T, in float64 since its terms
//     cancel over T) crosses the chunks in the same reverse walk.
//   * Every product runs on the tensor cores as mma.sync m16n8k8 TF32 with
//     split float32 operands (a = hi + lo, lo.hi + hi.lo + hi.hi
//     accumulated in float32), as the forward's, which keeps float32
//     accuracy.  r exp(L_p), k exp(L_C - L) and the outputs' scale factors
//     are formed directly from L, never as products of the mid-point
//     factors, so they never meet inf * 0; the masked halves of the
//     mid-point products are selected away, not multiplied.
//   * wkv_bwd_du_kernel: du[h, i] = sum over b of the (b, h) parts, in
//     order.  No float atomics anywhere: two calls give the same bits.
// The design's own bytes at the training slice: the first kernel reads k,
// v, log_w and dout and writes dr's state term, the second reads it back
// with r, k, v, log_w and dout and writes dr, dk, dv and dlog_w: 15 x
// 335.5 MB = 5.03 GB, 1.50 ms at the memory rate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;            // head size: the only one taken
constexpr int kMaxChunk = 64;     // the forward's limit
constexpr int kChunk = 32;        // steps per chunk here
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kK / 4;     // float4s per row
constexpr int kSegs = kThreads / kK;    // cumsum segments per channel
constexpr int kSegLen = kChunk / kSegs;
// Row pitches (floats) that keep the mma fragment loads free of bank
// conflicts: 4 mod 32 for tiles read as A[row][k] (or as a B given as
// [n][k]), 8 mod 32 for tiles read as B[k][n] (or as a transposed A).
constexpr int kP4 = kK + 4;
constexpr int kP8 = kK + 8;
constexpr int kSP = kChunk + 4;   // C x C tiles, read as A[row][k]
constexpr int kLayoutRejected = -1;
constexpr float kLogDecayMin = -4.6f;

enum { kR = 0, kKey = 1, kV = 2, kW = 3, kDo = 4 };

struct Params {
  const float* in[5];    // r, k, v, log_w, dout
  const float* u;        // (H, K)
  const float* state;    // (B, H, K, K): the forward's final state
  const float* d_state;  // (B, H, K, K) or null
  float* dr;             // (B, T, H, K) contiguous, as are dk, dv, dlw
  float* dk;
  float* dv;
  float* dlw;
  float* du;             // (H, K)
  float* partial;        // (B, H, K): du per (b, h)
  int B, T, H, nc;
  long long sb[5], st[5], sh[5];  // batch, time, head strides of the inputs
};

__device__ __forceinline__ float clamp_decay(float x) {
  return fminf(fmaxf(x, kLogDecayMin), 0.f);
}

// Offset of element (b, t, h, 0) of a contiguous (B, T, H, K) output.
__device__ __forceinline__ long long out_row(const Params& p, int b, int t, int h) {
  return (((long long)b * p.T + t) * p.H + h) * kK;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage chunk c's rows of input x (zero past row n) into a tile of pitch
// `pitch`, as 16-byte copies by every thread.
__device__ __forceinline__ void stage(const Params& p, int x, int b, int h, int t0, int n,
                                      float* tile, int pitch) {
  const float* src = p.in[x] + b * p.sb[x] + h * p.sh[x];
  for (int i = threadIdx.x; i < kChunk * kVecs; i += kThreads) {
    const int t = i / kVecs, j = (i % kVecs) * 4;
    const bool valid = t < n;
    cp_async16(tile + t * pitch + j, src + (long long)(t0 + (valid ? t : 0)) * p.st[x] + j, valid);
  }
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the
// exact rest, handed to the tensor core as float32 bits, of which it reads
// the TF32 part (lo's own rounding is 2^-10 of a term already 2^-11 of x).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a.b with both operands split, the small terms first.
struct FragA { unsigned hi[4], lo[4]; };
struct FragB { unsigned hi[2], lo[2]; };

__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4): A[m][k] holds
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B[k][n] holds (q, g),
// (q + 4, g); the accumulator (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).  m is [row][k] with row pitch `pitch`.
__device__ __forceinline__ FragA load_a(const float* m, int pitch, int row0, int k0, int g, int q) {
  FragA f;
  const float* p = m + (row0 + g) * pitch + k0 + q;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * pitch], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * pitch + 4], f.hi[3], f.lo[3]);
  return f;
}

// A[m][k] = m[k][m]: the transpose of a [k][row] tile.
__device__ __forceinline__ FragA load_a_t(const float* m, int pitch, int row0, int k0, int g,
                                          int q) {
  FragA f;
  const float* p = m + (k0 + q) * pitch + row0 + g;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8], f.hi[1], f.lo[1]);
  split_tf32(p[4 * pitch], f.hi[2], f.lo[2]);
  split_tf32(p[4 * pitch + 8], f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = m[k][n].
__device__ __forceinline__ FragB load_b(const float* m, int pitch, int k0, int n0, int g, int q) {
  FragB f;
  const float* p = m + (k0 + q) * pitch + n0 + g;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4 * pitch], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = m[n][k].
__device__ __forceinline__ FragB load_b_t(const float* m, int pitch, int k0, int n0, int g,
                                          int q) {
  FragB f;
  const float* p = m + (n0 + g) * pitch + k0 + q;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}

// exp(x) to float accuracy for an argument held in float64: the argument
// is split as hi + lo in float32 (|lo| <= half an ulp of hi, under 4e-6
// for |x| <= 73.6) and exp(hi + lo) = exp(hi) (1 + lo).  A float argument
// of that size would carry its own rounding into the factor, and dlog_w
// sums the factors' consequences over all of T.
__device__ __forceinline__ float exp_acc(double x) {
  const float hi = static_cast<float>(x);
  const float lo = static_cast<float>(x - static_cast<double>(hi));
  const float e = expf(hi);
  return fmaf(e, lo, e);
}

// The chunk's cumulative log-decay, in float64, channel i = tid % kK over
// rows kSegLen * sg .. of segment sg = tid / kK: the segment sums into
// `seg`, then (after a barrier) `offsets` gives channel i's offset and
// total.
__device__ __forceinline__ void segment_sum(const float* lw, double* seg, int i, int sg) {
  double acc = 0.0;
#pragma unroll
  for (int r = 0; r < kSegLen; ++r) acc += clamp_decay(lw[(sg * kSegLen + r) * kP4 + i]);
  seg[sg * kK + i] = acc;
}

__device__ __forceinline__ void offsets(const double* seg, int i, int sg, double& off,
                                        double& total) {
  off = 0.0;
  total = 0.0;
#pragma unroll
  for (int s = 0; s < kSegs; ++s) {
    const double x = seg[s * kK + i];
    if (s < sg) off += x;
    total += x;
  }
}

// Shared memory of sweep 1: the staged inputs twice (chunk c + 1 lands
// while chunk c computes).
struct StateIn {
  float kd[kChunk * kP8];   // k, then k exp(L_C - L)
  float v[kChunk * kP8];
  float dout[kChunk * kP4];
  float f[kChunk * kP4];    // log_w, then exp(L_p - L_m)
};

struct StateSmem {
  StateIn in[2];
  float kn[kChunk * kP8];   // k exp(L_m - L)
  float vd[kChunk * kSP];   // dout_t . v_s for s < t
  float S[kK * kP4];        // the state entering the chunk
  double seg[kSegs * kK];
  float elm[kK], elc[kK];
};

// Sweep 1: dr's state term, chunks forward.
__global__ void __launch_bounds__(kThreads, 2) wkv_bwd_state_kernel(Params p) {
  extern __shared__ float4 smem4[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int ci = tid % kK, sg = tid / kK;
  auto stage_chunk = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    StateIn& in = sm.in[c & 1];
    stage(p, kKey, b, h, t0, n, in.kd, kP8);
    stage(p, kV, b, h, t0, n, in.v, kP8);
    stage(p, kW, b, h, t0, n, in.f, kP4);
    stage(p, kDo, b, h, t0, n, in.dout, kP4);
    cp_async_commit();
  };
  for (int i = tid; i < kK * kP4; i += kThreads) sm.S[i] = 0.f;
  stage_chunk(0);
  for (int c = 0; c < p.nc; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    StateIn& in = sm.in[c & 1];
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's reads are done and S is written
    if (c + 1 < p.nc) stage_chunk(c + 1);
    segment_sum(in.f, sm.seg, ci, sg);
    __syncthreads();
    {
      double off, total;
      offsets(sm.seg, ci, sg, off, total);
      const double lm = 0.5 * total;
      const float elm = exp_acc(lm);
      // exp(L_p - L_m) and exp(L_m - L) of each row: the segment's entry
      // factors to float accuracy, then a product with the row's decay.
      float fp = exp_acc(off - lm), em = exp_acc(lm - off);
#pragma unroll
      for (int r = 0; r < kSegLen; ++r) {
        const int a = (sg * kSegLen + r) * kP8 + ci, af = (sg * kSegLen + r) * kP4 + ci;
        const float lw = clamp_decay(in.f[af]);
        in.f[af] = fp;
        fp *= expf(lw);
        em *= expf(-lw);
        const float kn = in.kd[a] * em;
        sm.kn[a] = kn;
        in.kd[a] = kn * elm;  // k exp(L_C - L): L_C - L_m = L_m
      }
      if (sg == 0) {
        sm.elm[ci] = elm;
        sm.elc[ci] = exp_acc(total);
      }
    }
    __syncthreads();
    {  // VD, kept below the diagonal; tiles with no s < t are skipped.
      const int mt = warp / 4, nt = warp % 4;
      if (nt * 8 <= mt * 16 + 14) {
        float acc[4] = {};
#pragma unroll
        for (int ks = 0; ks < kK / 8; ++ks)
          mma3(acc, load_a(in.dout, kP4, mt * 16, ks * 8, g, q),
               load_b_t(in.v, kP8, ks * 8, nt * 8, g, q));
        const int s = nt * 8 + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          *reinterpret_cast<float2*>(sm.vd + t * kSP + s) =
              make_float2(s < t ? acc[2 * half] : 0.f, s + 1 < t ? acc[2 * half + 1] : 0.f);
        }
      }
    }
    __syncthreads();
    {  // dr_state = exp(L_p) (dout S^T) + exp(L_p - L_m) (VD kn): two 16 x 8 tiles a warp.
      const int mt = warp & 1, nt0 = (warp >> 1) * 2;
      float a1[2][4] = {}, a2[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kK / 8; ++ks) {
        const FragA a = load_a(in.dout, kP4, mt * 16, ks * 8, g, q);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(a1[j], a, load_b_t(sm.S, kP4, ks * 8, (nt0 + j) * 8, g, q));
      }
      for (int ks = 0; ks < 2 * mt + 2; ++ks) {
        const FragA a = load_a(sm.vd, kSP, mt * 16, ks * 8, g, q);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(a2[j], a, load_b(sm.kn, kP8, ks * 8, (nt0 + j) * 8, g, q));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = mt * 16 + g + 8 * half;
        if (t >= n) continue;
        float* out = p.dr + out_row(p, b, t0 + t, h);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = (nt0 + j) * 8 + 2 * q;
          float val[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = in.f[t * kP4 + i + e];  // exp(L_p) = f exp(L_m)
            val[e] = fmaf(f * sm.elm[i + e], a1[j][2 * half + e], f * a2[j][2 * half + e]);
          }
          *reinterpret_cast<float2*>(out + i) = make_float2(val[0], val[1]);
        }
      }
    }
    // S <- exp(L_C) S + kd^T v: this warp's 16 rows x four 8-column tiles.
    const int mt = warp & 3, nt0 = (warp >> 2) * 4;
    float acc[4][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
      const float e = sm.elc[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sm.S + i * kP4 + (nt0 + j) * 8 + 2 * q);
        acc[j][2 * half] = e * s2.x;
        acc[j][2 * half + 1] = e * s2.y;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const FragA a = load_a_t(in.kd, kP8, mt * 16, ks * 8, g, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma3(acc[j], a, load_b(in.v, kP8, ks * 8, (nt0 + j) * 8, g, q));
    }
    __syncthreads();  // every read of S is done
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(sm.S + i * kP4 + (nt0 + j) * 8 + 2 * q) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// Shared memory of sweep 2.  Three pairs of buffers trade roles from one
// chunk to the next, so that chunk c - 1's r, k and dout land, while chunk
// c forms G and dlog_w, in the buffers that held chunk c's kn, kdec and rr
// (dead by then); v and log_w land in their own (dead as well).
struct GradSmem {
  float rbuf[2][kChunk * kP4];  // r (then r dr_state, dlog_w's first term) / kn = k exp(L_m - L)
  float kbuf[2][kChunk * kP4];  // k (then k dk_state, its second) / kdec = k exp(L_C - L)
  float dbuf[2][kChunk * kP8];  // dout / rr = r exp(L_p - L_m)
  float v[kChunk * kP4];
  float em[kChunk * kP4];       // log_w, then exp(L_m - L)
  float rq[kChunk * kP8];       // r exp(L_p)
  float vdt[kChunk * kSP];      // v_t . dout_s for s > t
  float at[kChunk * kSP];       // kn_t . rr_s for s > t
  float G[kK * kP4];            // the gradient of the state leaving the chunk
  double carry[2][kK];          // dlog_w's running sum entering the chunk from its right
  double seg[kSegs * kK];       // per segment: log-decay sums, dlog_w's terms, du's parts
  float elm[kK], elc[kK], us[kK];
  float vd[kChunk], ruk[kChunk];
  unsigned char inside[kChunk * kK];
};

// Sweep 2: dr, dk, dv, dlog_w and du's (b, h) part, chunks backward.
// Warps 0-3 form dk (a 16-column slice of both 16-row halves each), warps
// 4-7 dv; then all warps the next G (16 rows x 32 columns each).
__global__ void __launch_bounds__(kThreads, 2) wkv_bwd_grad_kernel(Params p) {
  extern __shared__ float4 smem4[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int ci = tid % kK, sg = tid / kK;
  const int n0 = (warp & 3) * 16;
  const long long sbase = (long long)bh * kK * kK;
  auto stage_chunk = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    stage(p, kR, b, h, t0, n, sm.rbuf[c & 1], kP4);
    stage(p, kKey, b, h, t0, n, sm.kbuf[c & 1], kP4);
    stage(p, kV, b, h, t0, n, sm.v, kP4);
    stage(p, kW, b, h, t0, n, sm.em, kP4);
    stage(p, kDo, b, h, t0, n, sm.dbuf[c & 1], kP8);
    cp_async_commit();
  };
  for (int i = tid; i < kK * kK; i += kThreads) {
    const int row = i / kK, col = i % kK;
    sm.G[row * kP4 + col] = p.d_state ? p.d_state[sbase + i] : 0.f;
  }
  if (tid < kK) {
    sm.us[tid] = p.u[h * kK + tid];
    double f = 0.0;  // sum_j dS_T S_T of row tid
    if (p.d_state) {
      for (int j = 0; j < kK; ++j)
        f += (double)p.d_state[sbase + tid * kK + j] * (double)p.state[sbase + tid * kK + j];
    }
    sm.carry[(p.nc - 1) & 1][tid] = f;
  }
  const float u0 = p.u[h * kK + lane], u1 = p.u[h * kK + lane + 32];
  float du_part = 0.f;
  stage_chunk(p.nc - 1);
  for (int c = p.nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    float* const r = sm.rbuf[c & 1];
    float* const kn = sm.rbuf[(c & 1) ^ 1];
    float* const kk = sm.kbuf[c & 1];
    float* const kdec = sm.kbuf[(c & 1) ^ 1];
    float* const dout = sm.dbuf[c & 1];
    float* const rr = sm.dbuf[(c & 1) ^ 1];
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c + 1's G and dlog_w are done
    // v . dout and sum_i r u k of each row (a warp per row); segment sums.
    for (int t = warp; t < kChunk; t += kWarps) {
      const float* vt = sm.v + t * kP4;
      const float* dt = dout + t * kP8;
      const float* rt = r + t * kP4;
      const float* kt = kk + t * kP4;
      float x = fmaf(vt[lane], dt[lane], vt[lane + 32] * dt[lane + 32]);
      float y = fmaf(rt[lane] * u0, kt[lane], rt[lane + 32] * u1 * kt[lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
        y += __shfl_xor_sync(0xffffffffu, y, off);
      }
      if (lane == 0) {
        sm.vd[t] = x;
        sm.ruk[t] = y;
      }
    }
    segment_sum(sm.em, sm.seg, ci, sg);
    __syncthreads();
    {
      double off, total;
      offsets(sm.seg, ci, sg, off, total);
      const double lm = 0.5 * total;
      const float elm = exp_acc(lm);
      // exp(L_p - L_m) and exp(L_m - L) of each row: the segment's entry
      // factors to float accuracy, then a product with the row's decay.
      float fp = exp_acc(off - lm), em = exp_acc(lm - off);
#pragma unroll
      for (int row = 0; row < kSegLen; ++row) {
        const int t = sg * kSegLen + row;
        const int a = t * kP4 + ci, a8 = t * kP8 + ci;
        const float raw = sm.em[a];
        sm.inside[t * kK + ci] = raw >= kLogDecayMin && raw <= 0.f;
        const float rv = r[a], kv = kk[a], lw = clamp_decay(raw);
        const float rrv = rv * fp;  // r exp(L_p - L_m)
        fp *= expf(lw);
        em *= expf(-lw);
        sm.em[a] = em;
        const float knv = kv * em;
        rr[a8] = rrv;
        sm.rq[a8] = rrv * elm;   // r exp(L_p)
        kn[a] = knv;
        kdec[a] = knv * elm;     // k exp(L_C - L)
        du_part = fmaf(rv * kv, sm.vd[t], du_part);
      }
      if (sg == 0) {
        sm.elm[ci] = elm;
        sm.elc[ci] = exp_acc(total);
      }
    }
    __syncthreads();
    {  // VD^T and A^T, kept above the diagonal; tiles with no s > t are skipped.
      const int mt = warp / 4, nt = warp % 4;
      if (nt * 8 + 7 > mt * 16) {
        float a1[4] = {}, a2[4] = {};
#pragma unroll
        for (int ks = 0; ks < kK / 8; ++ks) {
          mma3(a1, load_a(sm.v, kP4, mt * 16, ks * 8, g, q), load_b_t(dout, kP8, ks * 8, nt * 8, g, q));
          mma3(a2, load_a(kn, kP4, mt * 16, ks * 8, g, q), load_b_t(rr, kP8, ks * 8, nt * 8, g, q));
        }
        const int s = nt * 8 + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          *reinterpret_cast<float2*>(sm.vdt + t * kSP + s) =
              make_float2(s > t ? a1[2 * half] : 0.f, s + 1 > t ? a1[2 * half + 1] : 0.f);
          *reinterpret_cast<float2*>(sm.at + t * kSP + s) =
              make_float2(s > t ? a2[2 * half] : 0.f, s + 1 > t ? a2[2 * half + 1] : 0.f);
        }
      }
    }
    __syncthreads();
    // dr's state term, read now so that the loads fly during the products: this
    // thread's dk elements (warps 0-3).
    float ds[2][2][2][2] = {};
    if (warp < 4) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          if (t < n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 d2 = *reinterpret_cast<const float2*>(
                  p.dr + out_row(p, b, t0 + t, h) + n0 + j * 8 + 2 * q);
              ds[mt][half][j][0] = d2.x;
              ds[mt][half][j][1] = d2.y;
            }
          }
        }
    }
    float acc[4][2][4] = {};
    // dk (warps 0-3): acc[mt] = v G^T, acc[2 + mt] = VD^T rr; dv (warps
    // 4-7): acc[mt] = kdec G, acc[2 + mt] = A^T dout.  Rows 16-31 have s > t
    // only in the last 16 columns.
    const float* a_main = warp < 4 ? sm.v : kdec;
    const float* a_intra = warp < 4 ? sm.vdt : sm.at;
    const float* b_intra = warp < 4 ? rr : dout;
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      const FragA a0 = load_a(a_main, kP4, 0, ks * 8, g, q);
      const FragA a1 = load_a(a_main, kP4, 16, ks * 8, g, q);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const FragB fb = warp < 4 ? load_b_t(sm.G, kP4, ks * 8, n0 + j * 8, g, q)
                                  : load_b(sm.G, kP4, ks * 8, n0 + j * 8, g, q);
        mma3(acc[0][j], a0, fb);
        mma3(acc[1][j], a1, fb);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const FragA a0 = load_a(a_intra, kSP, 0, ks * 8, g, q);
      const FragA a1 = load_a(a_intra, kSP, 16, ks * 8, g, q);
      const bool lower = ks >= 2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const FragB fb = load_b(b_intra, kP8, ks * 8, n0 + j * 8, g, q);
        mma3(acc[2][j], a0, fb);
        if (lower) mma3(acc[3][j], a1, fb);
      }
    }
    if (warp < 4) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          const float vdt = sm.vd[t];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = n0 + j * 8 + 2 * q;
            float dr2[2], dk2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = t * kP4 + i + e;
              const float emid = sm.em[a];  // exp(L_C - L) = emid exp(L_m)
              const float dks = fmaf(emid * sm.elm[i + e], acc[mt][j][2 * half + e],
                                     emid * acc[2 + mt][j][2 * half + e]);
              const float ui = sm.us[i + e], rv = r[a], kv = kk[a];
              const float d = ds[mt][half][j][e];
              dr2[e] = fmaf(ui * kv, vdt, d);
              dk2[e] = fmaf(rv * ui, vdt, dks);
              r[a] = rv * d;    // 0 past row n: r is 0 there
              kk[a] = kv * dks;
            }
            if (t < n) {
              const long long o = out_row(p, b, t0 + t, h) + i;
              *reinterpret_cast<float2*>(p.dr + o) = make_float2(dr2[0], dr2[1]);
              *reinterpret_cast<float2*>(p.dk + o) = make_float2(dk2[0], dk2[1]);
            }
          }
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          if (t >= n) continue;
          const float ruk = sm.ruk[t];
          float* out = p.dv + out_row(p, b, t0 + t, h);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + j * 8 + 2 * q;
            *reinterpret_cast<float2*>(out + col) = make_float2(
                fmaf(ruk, dout[t * kP8 + col], acc[mt][j][2 * half] + acc[2 + mt][j][2 * half]),
                fmaf(ruk, dout[t * kP8 + col + 1],
                     acc[mt][j][2 * half + 1] + acc[2 + mt][j][2 * half + 1]));
          }
        }
    }
    __syncthreads();  // every read of G, v, kn, kdec, rr and em is done
    if (c > 0) stage_chunk(c - 1);
    {  // G <- exp(L_C) G + rq^T dout: rows 16 (warp & 3) .., columns 32 (warp >> 2) ...
      const int mt = warp & 3, c0 = (warp >> 2) * 32;
      float a[4][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mt * 16 + g + 8 * half;
        const float e = sm.elc[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 g2 = *reinterpret_cast<const float2*>(sm.G + i * kP4 + c0 + j * 8 + 2 * q);
          a[j][2 * half] = e * g2.x;
          a[j][2 * half + 1] = e * g2.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const FragA fa = load_a_t(sm.rq, kP8, mt * 16, ks * 8, g, q);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(a[j], fa, load_b(dout, kP8, ks * 8, c0 + j * 8, g, q));
      }
      // Each warp rewrites only the tiles it read.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mt * 16 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(sm.G + i * kP4 + c0 + j * 8 + 2 * q) =
              make_float2(a[j][2 * half], a[j][2 * half + 1]);
      }
    }
    // dlog_w, channel ci over rows kSegLen sg ..: the running sum from the
    // chunk's right end, acc -= k dk_state, dlog_w = acc, acc += r dr_state.
    // A segment's 8 terms sum in float (errors of 1e-7 of a term); the
    // running sum across segments and chunks, which cancels, in float64.
    float dsum = 0.f;
#pragma unroll
    for (int row = 0; row < kSegLen; ++row) {
      const int a = (sg * kSegLen + row) * kP4 + ci;
      dsum += r[a] - kk[a];
    }
    sm.seg[sg * kK + ci] = dsum;
    __syncthreads();
    {
      double entry = sm.carry[c & 1][ci];
      for (int s = kSegs - 1; s > sg; --s) entry += sm.seg[s * kK + ci];
      if (sg == 0) sm.carry[(c & 1) ^ 1][ci] = entry + sm.seg[ci];
      const float base = static_cast<float>(entry);
      const float rest = static_cast<float>(entry - static_cast<double>(base));
      float acc_w = 0.f;  // the running sum is base + rest + acc_w
#pragma unroll
      for (int row = kSegLen - 1; row >= 0; --row) {
        const int t = sg * kSegLen + row, a = t * kP4 + ci;
        acc_w -= kk[a];
        if (t < n)
          p.dlw[out_row(p, b, t0 + t, h) + ci] = sm.inside[t * kK + ci] ? base + (rest + acc_w) : 0.f;
        acc_w += r[a];
      }
    }
  }
  __syncthreads();
  sm.seg[sg * kK + ci] = du_part;
  __syncthreads();
  if (tid < kK) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) sum += (float)sm.seg[s * kK + tid];
    p.partial[(long long)bh * kK + tid] = sum;
  }
}

__global__ void __launch_bounds__(kK) wkv_bwd_du_kernel(Params p) {
  const int h = blockIdx.x, i = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < p.B; ++b) sum += p.partial[((long long)b * p.H + h) * kK + i];
  p.du[h * kK + i] = sum;
}

}  // namespace

extern "C" {

// The C entry's argument block, packed by ops.py (_BACKWARD_ARGS).
struct EntryArgs {
  const void* in[5];       // r, k, v, log_w, dout: (B, T, H, K)
  const void* u;           // (H, K) contiguous
  const void* state;       // (B, H, K, K) contiguous: the forward's final state
  const void* d_state;     // (B, H, K, K) contiguous, or null
  void* out[4];            // dr, dk, dv, dlog_w: (B, T, H, K) contiguous
  void* du;                // (H, K)
  void* partial;           // (B, H, K) float32 scratch
  long long strides[20];   // (batch, time, head, channel) of r, k, v, log_w, dout
  void* stream;
  int B, T, H, K, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 304, "EntryArgs must match ops.py's packing");

// Returns the first non-zero cudaError_t of the three launches (0 on
// success), or kLayoutRejected (-1) when K is not 64, the chunk is over 64,
// or an input is not read as 16-byte rows (base 16-byte aligned, channel
// stride 1, every other stride of a dim longer than 1 a multiple of 4);
// nothing is launched then.
int wkv_backward(const EntryArgs* a) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->chunk < 1) return (int)cudaErrorInvalidValue;
  const int C = a->chunk < a->T ? a->chunk : a->T;
  if (a->K != kK || C > kMaxChunk) return kLayoutRejected;
  const int sizes[3] = {a->B, a->T, a->H};
  for (int x = 0; x < 5; ++x) {
    const long long* st = a->strides + 4 * x;
    if (reinterpret_cast<uintptr_t>(a->in[x]) % 16 || st[3] != 1) return kLayoutRejected;
    for (int dim = 0; dim < 3; ++dim) {
      if (sizes[dim] > 1 && st[dim] % 4) return kLayoutRejected;
    }
  }
  Params p;
  for (int x = 0; x < 5; ++x) {
    p.in[x] = static_cast<const float*>(a->in[x]);
    p.sb[x] = a->strides[4 * x];
    p.st[x] = a->strides[4 * x + 1];
    p.sh[x] = a->strides[4 * x + 2];
  }
  p.u = static_cast<const float*>(a->u);
  p.state = static_cast<const float*>(a->state);
  p.d_state = static_cast<const float*>(a->d_state);
  p.dr = static_cast<float*>(a->out[0]);
  p.dk = static_cast<float*>(a->out[1]);
  p.dv = static_cast<float*>(a->out[2]);
  p.dlw = static_cast<float*>(a->out[3]);
  p.du = static_cast<float*>(a->du);
  p.partial = static_cast<float*>(a->partial);
  p.B = a->B;
  p.T = a->T;
  p.H = a->H;
  p.nc = (a->T + kChunk - 1) / kChunk;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  const int bytes_state = (int)sizeof(StateSmem), bytes_grad = (int)sizeof(GradSmem);
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_state);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes_grad);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a->B * a->H);
  wkv_bwd_state_kernel<<<grid, kThreads, bytes_state, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_grad_kernel<<<grid, kThreads, bytes_grad, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_du_kernel<<<a->H, kK, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
