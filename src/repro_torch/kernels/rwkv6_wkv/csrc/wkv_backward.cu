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
// Inputs r/k/v/log_w/dout (B,T,H,K) share one element type T, float32,
// bfloat16 or float16 (a template parameter), read in place through their
// strides (rows of K elements as 16-byte cp.async copies in float32, as
// 8-byte loads widened as they are staged in the 16-bit types: the
// forward's layout rule); u (H,K) and the final state (B,H,K,K)
// float32, contiguous.  dr, dk, dv and dlog_w go out in T, each rounded
// once from its float32 value (in the 16-bit types dr's state term, which
// the second kernel adds to, goes through a float32 buffer); du in
// float32 (ops.py rounds it to u's dtype).  K is a template parameter, instantiated at 32 (the reduced
// rwkv6-7b config), 64 (the published one) and 128, as the forward, which
// ops.py pads other head sizes to.  The forward's chunk does not enter:
// this kernel runs its own chunk of kChunk steps.
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
// At K = 32 (reduced rwkv6-7b) the warp splits follow Dims: a warp's share
// of a 32-row output is one 8-column tile, and segments of 4 rows; a call
// at the reduced shapes is launch-bound.
// The design's own bytes at the training slice: the first kernel reads k,
// v, log_w and dout and writes dr's state term, the second reads it back
// with r, k, v, log_w and dout and writes dr, dk, dv and dlog_w: 15 x
// 335.5 MB = 5.03 GB, 1.50 ms at the memory rate.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr int kChunk = 32;        // steps per chunk here
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSP = kChunk + 4;   // C x C tiles, read as A[row][k]

// What follows the head size K (32, 64 or 128).  Every warp split below is
// written in these: at K = 64 a warp's share of a 32-row output is two
// 8-column tiles, at K = 32 one, at 128 four.
template <int K>
struct Dims {
  static_assert(K == 32 || K == 64 || K == 128, "head sizes 32, 64 and 128");
  static constexpr int kVecs = K / 4;            // float4s per row
  static constexpr int kSegs = kThreads / K;     // cumsum segments per channel: 4 or 8
  static constexpr int kSegLen = kChunk / kSegs;  // their rows: 8 or 4
  // Row pitches (floats) that keep the mma fragment loads free of bank
  // conflicts at either K: 4 mod 32 for tiles read as A[row][k] (or as a B
  // given as [n][k]), 8 mod 32 for tiles read as B[k][n] (or as a
  // transposed A).
  static constexpr int kP4 = K + 4;
  static constexpr int kP8 = K + 8;
  // Four warps share the K columns of a 32-row output (dr's state term;
  // dk; dv) at kTw 8-column tiles each; the K x K state (S, G) is kMt
  // 16-row tiles, each shared by kWarps / kMt warps at kSNt 8-column tiles.
  static constexpr int kTw = K / 32;
  static constexpr int kMt = K / 16;
  static constexpr int kSNt = K / 8 / (kWarps / kMt);
  // Sweep 2 keeps r exp(L_p) in a buffer of its own, so that chunk c - 1
  // lands while chunk c forms G; at K = 128 that buffer would pass the
  // shared memory, so G's update scales rr there and chunk c - 1 lands
  // after it (the same products, the same bits).
  static constexpr bool kKeepRq = K < 128;
  static constexpr int kBlocks = K < 128 ? 2 : 1;  // blocks an SM
};
constexpr int kLayoutRejected = -1;
constexpr float kLogDecayMin = -4.6f;

enum { kR = 0, kKey = 1, kV = 2, kW = 3, kDo = 4 };

struct Params {
  const void* in[5];     // r, k, v, log_w, dout: the element type T
  const float* u;        // (H, K)
  const float* state;    // (B, H, K, K): the forward's final state
  const float* d_state;  // (B, H, K, K) or null
  void* dr;              // (B, T, H, K) contiguous, as are dk, dv, dlw: T
  void* dk;
  void* dv;
  void* dlw;
  float* drs;            // (B, T, H, K) contiguous float32: dr's state term in bfloat16
  float* du;             // (H, K)
  float* partial;        // (B, H, K): du per (b, h)
  int B, T, H, nc;
  long long sb[5], st[5], sh[5];  // batch, time, head strides of the inputs
};

__device__ __forceinline__ float clamp_decay(float x) {
  return fminf(fmaxf(x, kLogDecayMin), 0.f);
}

// Offset of element (b, t, h, 0) of a contiguous (B, T, H, K) output.
template <int K>
__device__ __forceinline__ long long out_row(const Params& p, int b, int t, int h) {
  return (((long long)b * p.T + t) * p.H + h) * K;
}

// dr's state term: dr itself in float32, a float32 buffer of its own in
// bfloat16.
template <typename T>
__device__ __forceinline__ float* dr_state(const Params& p) {
  return sizeof(T) == 4 ? static_cast<float*>(p.dr) : p.drs;
}

// An output element, or elements i and i + 1 at `o` (an even offset), in T.
__device__ __forceinline__ void put(float* o, float x) { *o = x; }
__device__ __forceinline__ void put(bf16* o, float x) { *o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(f16* o, float x) { *o = __float2half_rn(x); }

__device__ __forceinline__ void put_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

__device__ __forceinline__ void put_pair(bf16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put_pair(f16* o, float a, float b) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(a, b);
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

// Four elements of a row from `src` into the float32 tile at `dst`, zero
// where !valid (src is not read then), as in wkv.cu: a 16-byte cp.async
// copy (float32), or an 8-byte load widened and stored (bfloat16, float16).
__device__ __forceinline__ void stage4(float* dst, const float* src, bool valid) {
  cp_async16(dst, src, valid);
}

__device__ __forceinline__ void stage4(float* dst, const bf16* src, bool valid) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    x = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                    __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void stage4(float* dst, const f16* src, bool valid) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
    x = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  *reinterpret_cast<float4*>(dst) = x;
}

// Stage chunk c's rows of input x (zero past row n) into a tile of pitch
// `pitch`, as 4-element vectors by every thread.
template <int K, typename T>
__device__ __forceinline__ void stage(const Params& p, int x, int b, int h, int t0, int n,
                                      float* tile, int pitch) {
  constexpr int kVecs = Dims<K>::kVecs;
  const T* src = static_cast<const T*>(p.in[x]) + b * p.sb[x] + h * p.sh[x];
  for (int i = threadIdx.x; i < kChunk * kVecs; i += kThreads) {
    const int t = i / kVecs, j = (i % kVecs) * 4;
    const bool valid = t < n;
    stage4(tile + t * pitch + j, src + (long long)(t0 + (valid ? t : 0)) * p.st[x] + j, valid);
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

// load_a_t of m[k][row] scale[row]: each element times its row's factor,
// rounded as the product stored in a tile of its own would be.
__device__ __forceinline__ FragA load_a_t_scaled(const float* m, int pitch, int row0, int k0,
                                                 int g, int q, const float* scale) {
  FragA f;
  const float* p = m + (k0 + q) * pitch + row0 + g;
  const float s0 = scale[row0 + g], s1 = scale[row0 + g + 8];
  split_tf32(p[0] * s0, f.hi[0], f.lo[0]);
  split_tf32(p[8] * s1, f.hi[1], f.lo[1]);
  split_tf32(p[4 * pitch] * s0, f.hi[2], f.lo[2]);
  split_tf32(p[4 * pitch + 8] * s1, f.hi[3], f.lo[3]);
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

// The chunk's cumulative log-decay, in float64, channel i = tid % K over
// rows kSegLen * sg .. of segment sg = tid / K: the segment sums into
// `seg`, then (after a barrier) `offsets` gives channel i's offset and
// total.
template <int K>
__device__ __forceinline__ void segment_sum(const float* lw, double* seg, int i, int sg) {
  constexpr int kSegLen = Dims<K>::kSegLen;
  double acc = 0.0;
#pragma unroll
  for (int r = 0; r < kSegLen; ++r) acc += clamp_decay(lw[(sg * kSegLen + r) * Dims<K>::kP4 + i]);
  seg[sg * K + i] = acc;
}

template <int K>
__device__ __forceinline__ void offsets(const double* seg, int i, int sg, double& off,
                                        double& total) {
  off = 0.0;
  total = 0.0;
#pragma unroll
  for (int s = 0; s < Dims<K>::kSegs; ++s) {
    const double x = seg[s * K + i];
    if (s < sg) off += x;
    total += x;
  }
}

// Shared memory of sweep 1: the staged inputs twice (chunk c + 1 lands
// while chunk c computes).
template <int K>
struct StateIn {
  float kd[kChunk * Dims<K>::kP8];   // k, then k exp(L_C - L)
  float v[kChunk * Dims<K>::kP8];
  float dout[kChunk * Dims<K>::kP4];
  float f[kChunk * Dims<K>::kP4];    // log_w, then exp(L_p - L_m)
};

template <int K>
struct StateSmem {
  StateIn<K> in[2];
  float kn[kChunk * Dims<K>::kP8];   // k exp(L_m - L)
  float vd[kChunk * kSP];            // dout_t . v_s for s < t
  float S[K * Dims<K>::kP4];         // the state entering the chunk
  double seg[Dims<K>::kSegs * K];
  float elm[K], elc[K];
};

// Sweep 1: dr's state term, chunks forward.
template <int K, typename T>
__global__ void __launch_bounds__(kThreads, Dims<K>::kBlocks) wkv_bwd_state_kernel(Params p) {
  using D = Dims<K>;
  constexpr int kP4 = D::kP4, kP8 = D::kP8, kSegLen = D::kSegLen;
  extern __shared__ float4 smem4[];
  StateSmem<K>& sm = *reinterpret_cast<StateSmem<K>*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int ci = tid % K, sg = tid / K;
  auto stage_chunk = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    StateIn<K>& in = sm.in[c & 1];
    stage<K, T>(p, kKey, b, h, t0, n, in.kd, kP8);
    stage<K, T>(p, kV, b, h, t0, n, in.v, kP8);
    stage<K, T>(p, kW, b, h, t0, n, in.f, kP4);
    stage<K, T>(p, kDo, b, h, t0, n, in.dout, kP4);
    cp_async_commit();
  };
  for (int i = tid; i < K * kP4; i += kThreads) sm.S[i] = 0.f;
  stage_chunk(0);
  for (int c = 0; c < p.nc; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    StateIn<K>& in = sm.in[c & 1];
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's reads are done and S is written
    if (c + 1 < p.nc) stage_chunk(c + 1);
    segment_sum<K>(in.f, sm.seg, ci, sg);
    __syncthreads();
    {
      double off, total;
      offsets<K>(sm.seg, ci, sg, off, total);
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
        for (int ks = 0; ks < K / 8; ++ks)
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
    {  // dr_state = exp(L_p) (dout S^T) + exp(L_p - L_m) (VD kn): kTw 16 x 8 tiles a warp.
      constexpr int kTw = D::kTw;
      const int mt = warp & 1, nt0 = (warp >> 1) * kTw;
      float a1[kTw][4] = {}, a2[kTw][4] = {};
#pragma unroll
      for (int ks = 0; ks < K / 8; ++ks) {
        const FragA a = load_a(in.dout, kP4, mt * 16, ks * 8, g, q);
#pragma unroll
        for (int j = 0; j < kTw; ++j)
          mma3(a1[j], a, load_b_t(sm.S, kP4, ks * 8, (nt0 + j) * 8, g, q));
      }
      for (int ks = 0; ks < 2 * mt + 2; ++ks) {
        const FragA a = load_a(sm.vd, kSP, mt * 16, ks * 8, g, q);
#pragma unroll
        for (int j = 0; j < kTw; ++j)
          mma3(a2[j], a, load_b(sm.kn, kP8, ks * 8, (nt0 + j) * 8, g, q));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = mt * 16 + g + 8 * half;
        if (t >= n) continue;
        float* out = dr_state<T>(p) + out_row<K>(p, b, t0 + t, h);
#pragma unroll
        for (int j = 0; j < kTw; ++j) {
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
    // S <- exp(L_C) S + kd^T v: this warp's 16 rows x kSNt 8-column tiles.
    constexpr int kSNt = D::kSNt;
    const int mt = warp % D::kMt, nt0 = (warp / D::kMt) * kSNt;
    float acc[kSNt][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
      const float e = sm.elc[i];
#pragma unroll
      for (int j = 0; j < kSNt; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sm.S + i * kP4 + (nt0 + j) * 8 + 2 * q);
        acc[j][2 * half] = e * s2.x;
        acc[j][2 * half + 1] = e * s2.y;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const FragA a = load_a_t(in.kd, kP8, mt * 16, ks * 8, g, q);
#pragma unroll
      for (int j = 0; j < kSNt; ++j)
        mma3(acc[j], a, load_b(in.v, kP8, ks * 8, (nt0 + j) * 8, g, q));
    }
    __syncthreads();  // every read of S is done
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
#pragma unroll
      for (int j = 0; j < kSNt; ++j)
        *reinterpret_cast<float2*>(sm.S + i * kP4 + (nt0 + j) * 8 + 2 * q) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// Shared memory of sweep 2.  Three pairs of buffers trade roles from one
// chunk to the next, so that chunk c - 1's r, k and dout land, while chunk
// c forms G and dlog_w, in the buffers that held chunk c's kn, kdec and rr
// (dead by then); v and log_w land in their own (dead as well).
template <int K>
struct GradSmem {
  static constexpr int kP4 = Dims<K>::kP4, kP8 = Dims<K>::kP8;
  float rbuf[2][kChunk * kP4];  // r (then r dr_state, dlog_w's first term) / kn = k exp(L_m - L)
  float kbuf[2][kChunk * kP4];  // k (then k dk_state, its second) / kdec = k exp(L_C - L)
  float dbuf[2][kChunk * kP8];  // dout / rr = r exp(L_p - L_m)
  float v[kChunk * kP4];
  float em[kChunk * kP4];       // log_w, then exp(L_m - L)
  float rq[Dims<K>::kKeepRq ? kChunk * kP8 : 4];  // r exp(L_p), while kKeepRq (else 4 floats:
                                                  // what follows stays 16-byte aligned)
  float vdt[kChunk * kSP];      // v_t . dout_s for s > t
  float at[kChunk * kSP];       // kn_t . rr_s for s > t
  float G[K * kP4];             // the gradient of the state leaving the chunk
  double carry[2][K];           // dlog_w's running sum entering the chunk from its right
  double seg[Dims<K>::kSegs * K];  // per segment: log-decay sums, dlog_w's terms, du's parts
  float elm[K], elc[K], us[K];
  float vd[kChunk], ruk[kChunk];
  unsigned char inside[kChunk * K];
};

// Sweep 2: dr, dk, dv, dlog_w and du's (b, h) part, chunks backward.
// Warps 0-3 form dk (a K/4-column slice of both 16-row halves each), warps
// 4-7 dv; then all warps the next G (16 rows x 8 kSNt columns each).
template <int K, typename T>
__global__ void __launch_bounds__(kThreads, Dims<K>::kBlocks) wkv_bwd_grad_kernel(Params p) {
  using D = Dims<K>;
  constexpr int kP4 = D::kP4, kP8 = D::kP8, kSegLen = D::kSegLen, kSegs = D::kSegs;
  constexpr int kTw = D::kTw;
  extern __shared__ float4 smem4[];
  GradSmem<K>& sm = *reinterpret_cast<GradSmem<K>*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int ci = tid % K, sg = tid / K;
  const int n0 = (warp & 3) * (K / 4);
  const long long sbase = (long long)bh * K * K;
  auto stage_chunk = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, p.T - t0);
    stage<K, T>(p, kR, b, h, t0, n, sm.rbuf[c & 1], kP4);
    stage<K, T>(p, kKey, b, h, t0, n, sm.kbuf[c & 1], kP4);
    stage<K, T>(p, kV, b, h, t0, n, sm.v, kP4);
    stage<K, T>(p, kW, b, h, t0, n, sm.em, kP4);
    stage<K, T>(p, kDo, b, h, t0, n, sm.dbuf[c & 1], kP8);
    cp_async_commit();
  };
  for (int i = tid; i < K * K; i += kThreads) {
    const int row = i / K, col = i % K;
    sm.G[row * kP4 + col] = p.d_state ? p.d_state[sbase + i] : 0.f;
  }
  if (tid < K) {
    sm.us[tid] = p.u[h * K + tid];
    double f = 0.0;  // sum_j dS_T S_T of row tid
    if (p.d_state) {
      for (int j = 0; j < K; ++j)
        f += (double)p.d_state[sbase + tid * K + j] * (double)p.state[sbase + tid * K + j];
    }
    sm.carry[(p.nc - 1) & 1][tid] = f;
  }
  float uu[kTw];  // u of channels lane + 32 e
#pragma unroll
  for (int e = 0; e < kTw; ++e) uu[e] = p.u[h * K + lane + 32 * e];
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
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int e = kTw - 1; e >= 0; --e) {
        const int i = lane + 32 * e;
        x = fmaf(vt[i], dt[i], x);
        y = fmaf(rt[i] * uu[e], kt[i], y);
      }
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
    segment_sum<K>(sm.em, sm.seg, ci, sg);
    __syncthreads();
    {
      double off, total;
      offsets<K>(sm.seg, ci, sg, off, total);
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
        sm.inside[t * K + ci] = raw >= kLogDecayMin && raw <= 0.f;
        const float rv = r[a], kv = kk[a], lw = clamp_decay(raw);
        const float rrv = rv * fp;  // r exp(L_p - L_m)
        fp *= expf(lw);
        em *= expf(-lw);
        sm.em[a] = em;
        const float knv = kv * em;
        rr[a8] = rrv;
        if constexpr (D::kKeepRq) sm.rq[a8] = rrv * elm;   // r exp(L_p)
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
        for (int ks = 0; ks < K / 8; ++ks) {
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
    float ds[2][2][kTw][2] = {};
    if (warp < 4) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = mt * 16 + g + 8 * half;
          if (t < n) {
#pragma unroll
            for (int j = 0; j < kTw; ++j) {
              const float2 d2 = *reinterpret_cast<const float2*>(
                  dr_state<T>(p) + out_row<K>(p, b, t0 + t, h) + n0 + j * 8 + 2 * q);
              ds[mt][half][j][0] = d2.x;
              ds[mt][half][j][1] = d2.y;
            }
          }
        }
    }
    float acc[4][kTw][4] = {};
    // dk (warps 0-3): acc[mt] = v G^T, acc[2 + mt] = VD^T rr; dv (warps
    // 4-7): acc[mt] = kdec G, acc[2 + mt] = A^T dout.  Rows 16-31 have s > t
    // only in the last 16 columns.
    const float* a_main = warp < 4 ? sm.v : kdec;
    const float* a_intra = warp < 4 ? sm.vdt : sm.at;
    const float* b_intra = warp < 4 ? rr : dout;
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const FragA a0 = load_a(a_main, kP4, 0, ks * 8, g, q);
      const FragA a1 = load_a(a_main, kP4, 16, ks * 8, g, q);
#pragma unroll
      for (int j = 0; j < kTw; ++j) {
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
      for (int j = 0; j < kTw; ++j) {
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
          for (int j = 0; j < kTw; ++j) {
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
              const long long o = out_row<K>(p, b, t0 + t, h) + i;
              put_pair(static_cast<T*>(p.dr) + o, dr2[0], dr2[1]);
              put_pair(static_cast<T*>(p.dk) + o, dk2[0], dk2[1]);
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
          T* out = static_cast<T*>(p.dv) + out_row<K>(p, b, t0 + t, h);
#pragma unroll
          for (int j = 0; j < kTw; ++j) {
            const int col = n0 + j * 8 + 2 * q;
            put_pair(
                out + col,
                fmaf(ruk, dout[t * kP8 + col], acc[mt][j][2 * half] + acc[2 + mt][j][2 * half]),
                fmaf(ruk, dout[t * kP8 + col + 1],
                     acc[mt][j][2 * half + 1] + acc[2 + mt][j][2 * half + 1]));
          }
        }
    }
    __syncthreads();  // every read of G, v, kn, kdec, em (and rr but at K = 128) is done
    if constexpr (D::kKeepRq) {
      if (c > 0) stage_chunk(c - 1);
    }
    {  // G <- exp(L_C) G + rq^T dout: rows 16 (warp % kMt) .., kSNt 8-column tiles.
      constexpr int kSNt = D::kSNt;
      const int mt = warp % D::kMt, c0 = (warp / D::kMt) * kSNt * 8;
      float a[kSNt][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mt * 16 + g + 8 * half;
        const float e = sm.elc[i];
#pragma unroll
        for (int j = 0; j < kSNt; ++j) {
          const float2 g2 = *reinterpret_cast<const float2*>(sm.G + i * kP4 + c0 + j * 8 + 2 * q);
          a[j][2 * half] = e * g2.x;
          a[j][2 * half + 1] = e * g2.y;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        FragA fa;
        if constexpr (D::kKeepRq)
          fa = load_a_t(sm.rq, kP8, mt * 16, ks * 8, g, q);
        else
          fa = load_a_t_scaled(rr, kP8, mt * 16, ks * 8, g, q, sm.elm);
#pragma unroll
        for (int j = 0; j < kSNt; ++j) mma3(a[j], fa, load_b(dout, kP8, ks * 8, c0 + j * 8, g, q));
      }
      // Each warp rewrites only the tiles it read.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = mt * 16 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < kSNt; ++j)
          *reinterpret_cast<float2*>(sm.G + i * kP4 + c0 + j * 8 + 2 * q) =
              make_float2(a[j][2 * half], a[j][2 * half + 1]);
      }
    }
    if constexpr (!D::kKeepRq) {
      __syncthreads();  // every read of rr is done
      if (c > 0) stage_chunk(c - 1);
    }
    // dlog_w, channel ci over rows kSegLen sg ..: the running sum from the
    // chunk's right end, acc -= k dk_state, dlog_w = acc, acc += r dr_state.
    // A segment's kSegLen terms (8 at K = 64, 4 at 32) sum in float (errors
    // of 1e-7 of a term); the running sum across segments and chunks, which
    // cancels, in float64.
    float dsum = 0.f;
#pragma unroll
    for (int row = 0; row < kSegLen; ++row) {
      const int a = (sg * kSegLen + row) * kP4 + ci;
      dsum += r[a] - kk[a];
    }
    sm.seg[sg * K + ci] = dsum;
    __syncthreads();
    {
      double entry = sm.carry[c & 1][ci];
      for (int s = kSegs - 1; s > sg; --s) entry += sm.seg[s * K + ci];
      if (sg == 0) sm.carry[(c & 1) ^ 1][ci] = entry + sm.seg[ci];
      const float base = static_cast<float>(entry);
      const float rest = static_cast<float>(entry - static_cast<double>(base));
      float acc_w = 0.f;  // the running sum is base + rest + acc_w
#pragma unroll
      for (int row = kSegLen - 1; row >= 0; --row) {
        const int t = sg * kSegLen + row, a = t * kP4 + ci;
        acc_w -= kk[a];
        if (t < n)
          put(static_cast<T*>(p.dlw) + out_row<K>(p, b, t0 + t, h) + ci,
              sm.inside[t * K + ci] ? base + (rest + acc_w) : 0.f);
        acc_w += r[a];
      }
    }
  }
  __syncthreads();
  sm.seg[sg * K + ci] = du_part;
  __syncthreads();
  if (tid < K) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) sum += (float)sm.seg[s * K + tid];
    p.partial[(long long)bh * K + tid] = sum;
  }
}

template <int K>
__global__ void __launch_bounds__(K) wkv_bwd_du_kernel(Params p) {
  const int h = blockIdx.x, i = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < p.B; ++b) sum += p.partial[((long long)b * p.H + h) * K + i];
  p.du[h * K + i] = sum;
}

// The three kernels at head size K and element type T on `stream`.
template <int K, typename T>
int launch(const Params& p, cudaStream_t stream) {
  static_assert(sizeof(StateSmem<K>) <= 227 * 1024 && sizeof(GradSmem<K>) <= 227 * 1024,
                "the backward's shared memory");
  const int bytes_state = (int)sizeof(StateSmem<K>), bytes_grad = (int)sizeof(GradSmem<K>);
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_state_kernel<K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_state);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv_bwd_grad_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes_grad);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H);
  wkv_bwd_state_kernel<K, T><<<grid, kThreads, bytes_state, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_grad_kernel<K, T><<<grid, kThreads, bytes_grad, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_du_kernel<K><<<p.H, K, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The C entry's argument block, packed by ops.py (_BACKWARD_ARGS).
struct EntryArgs {
  const void* in[5];       // r, k, v, log_w, dout: (B, T, H, K), one element type
  const void* u;           // (H, K) contiguous float32
  const void* state;       // (B, H, K, K) contiguous float32: the forward's final state
  const void* d_state;     // (B, H, K, K) contiguous float32, or null
  void* out[4];            // dr, dk, dv, dlog_w: (B, T, H, K) contiguous
  void* du;                // (H, K)
  void* partial;           // (B, H, K) float32 scratch
  void* dr_state;          // (B, T, H, K) float32 scratch: dr's state term in bfloat16
  long long strides[20];   // (batch, time, head, channel) of r, k, v, log_w, dout
  void* stream;
  int B, T, H, K, chunk;
  int dtype;               // the inputs and dr, dk, dv, dlog_w: 0 float32, 1 bfloat16,
                           // 2 float16
};
static_assert(sizeof(EntryArgs) == 312, "EntryArgs must match ops.py's packing");

// Returns the first non-zero cudaError_t of the three launches (0 on
// success), or kLayoutRejected (-1) when K is not 32, 64 or 128, the chunk
// is over 128 (over 64 at K = 128), the forward's reach, or an input is
// not read as rows of 4-element vectors (the forward's layout rule);
// nothing is launched then.
int wkv_backward(const EntryArgs* a) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->chunk < 1) return (int)cudaErrorInvalidValue;
  const int C = a->chunk < a->T ? a->chunk : a->T;
  if ((a->K != 32 && a->K != 64 && a->K != 128) || C > 128 || (a->K == 128 && C > 64))
    return kLayoutRejected;
  const int sizes[3] = {a->B, a->T, a->H};
  if (a->dtype < 0 || a->dtype > 2) return (int)cudaErrorInvalidValue;
  const uintptr_t align = a->dtype ? 8 : 16;
  for (int x = 0; x < 5; ++x) {
    const long long* st = a->strides + 4 * x;
    if (reinterpret_cast<uintptr_t>(a->in[x]) % align || st[3] != 1) return kLayoutRejected;
    for (int dim = 0; dim < 3; ++dim) {
      if (sizes[dim] > 1 && st[dim] % 4) return kLayoutRejected;
    }
  }
  Params p;
  for (int x = 0; x < 5; ++x) {
    p.in[x] = a->in[x];
    p.sb[x] = a->strides[4 * x];
    p.st[x] = a->strides[4 * x + 1];
    p.sh[x] = a->strides[4 * x + 2];
  }
  p.u = static_cast<const float*>(a->u);
  p.state = static_cast<const float*>(a->state);
  p.d_state = static_cast<const float*>(a->d_state);
  p.dr = a->out[0];
  p.dk = a->out[1];
  p.dv = a->out[2];
  p.dlw = a->out[3];
  p.drs = static_cast<float*>(a->dr_state);
  p.du = static_cast<float*>(a->du);
  p.partial = static_cast<float*>(a->partial);
  p.B = a->B;
  p.T = a->T;
  p.H = a->H;
  p.nc = (a->T + kChunk - 1) / kChunk;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  if (a->dtype == 1) {
    switch (a->K) {
      case 32: return launch<32, bf16>(p, stream);
      case 64: return launch<64, bf16>(p, stream);
      default: return launch<128, bf16>(p, stream);
    }
  }
  if (a->dtype == 2) {
    switch (a->K) {
      case 32: return launch<32, f16>(p, stream);
      case 64: return launch<64, f16>(p, stream);
      default: return launch<128, f16>(p, stream);
    }
  }
  switch (a->K) {
    case 32: return launch<32, float>(p, stream);
    case 64: return launch<64, float>(p, stream);
    default: return launch<128, float>(p, stream);
  }
}

}  // extern "C"
