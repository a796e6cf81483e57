// RWKV6 WKV forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py::wkv_kernel
//   (body _wkv_kernel; entry ops.py::wkv)
// and computes the same function, per (batch, head), with a float32 K x K
// state S and log-decays clamped to [-4.6, 0]:
//   out_t = r_t . (diag(u) k_t^T v_t + S_{t-1})
//   S_t   = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
// in the chunked-parallel form: within a chunk of C tokens, with L_t the
// inclusive cumulative log-decay and L_mid = L_C / 2,
//   scores(t, s) = (r_t . exp(L_{t-1} - L_mid)) . (k_s . exp(L_mid - L_s)), s < t
//   out_t        = scores v + (r_t . u . k_t) v_t + (r_t . exp(L_{t-1})) S
//   S           <- exp(L_C) . S + (k . exp(L_C - L))^T v
// Inputs and output are float32; out is (B,T,H,K), the final state
// (B,H,K,K).  K = 64 only; 1 <= C <= 64.
//
// What it does differently from the TPU kernel:
//   * The TPU grid (B*H, n_chunks) carries the state in VMEM scratch across
//     its sequential chunk axis.  Blocks on Hopper run in no order, so the
//     chunk axis is a loop inside the block and the state slice stays in
//     shared memory for the whole sequence.
//   * At B=1 there are only 64 (b, h) pairs for 132 SMs.  Column j of the
//     state and of out depends only on column j of v, so the K = 64 value
//     columns are split over 4 blocks of 16 (grid (B*H, 4)); each block
//     recomputes the chunk's C x C scores, which need all K channels.
//   * r/k/v/log_w are read in place, (B,T,H,K) through their strides, with
//     no folded or padded copies: the ragged last chunk is zero-filled here
//     (r = k = v = 0, log-decay 0), so the final state is the padded form's.
//   * r . exp(L_{t-1}) and k . exp(L_C - L_t) are formed directly, not as
//     products of the mid-point factors, so they never meet inf * 0.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 off the tensor
// cores): at B=1, T=1024, H=64, K=64 the function must move r, k, v, lw and
// out once plus u and the state, about 84.9 MB, about 25 us, while the
// sequential recurrence's 4 K^2 operations per token and head are 1.07
// GFLOP, about 16 us: it is bound by bytes.
//
// What this design does about that bound: the next chunk's r/k/log_w/v
// are copied into a second shared-memory buffer with cp.async while the
// current chunk computes, so device-memory latency is off the chunk loop's
// critical path; the three products read shared memory as float4 into
// register tiles.  It is still far from the bound: the chunk loop runs its
// phases one after another with a barrier between each, every product is
// a scalar float32 FMA on the CUDA cores, and each of a head's four
// column blocks recomputes the scores (at C = 32 the scores are ~45 % of
// the FMAs).  Tensor cores (mma.sync / wgmma on the two C x K products,
// with split float32 operands to keep 1e-4 accuracy) and a chunk-parallel
// first pass are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kK = 64;            // head size: the only one taken
constexpr int kVB = 16;           // value columns per block
constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kPitch = kK + 4;    // row pitch of the (C, K) tiles: float4
                                  // rows 8 apart fall in distinct banks
constexpr float kLogDecayMin = -4.6f;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;   // (H, K) contiguous
  float* out;       // (B, T, H, K) contiguous
  float* state;     // (B, H, K, K) contiguous
  int T, H, C;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long o_sb, o_st, o_sh;
};

// Chunk rows rounded up to 4 (the float4 reads of the scores run over s).
__host__ __device__ inline int round4(int c) { return (c + 3) & ~3; }
// Row pitch of the scores: a multiple of 4, and 4 mod 32 at C = 32 / 64.
__host__ __device__ inline int score_pitch(int c) { return round4(c) + 4; }

// One buffer of raw chunk inputs: r, k, log_w (C x kPitch) and v (C4 x kVB).
__host__ __device__ inline int raw_floats(int c) { return 3 * c * kPitch + round4(c) * kVB; }

size_t smem_floats(int C) {
  return 2 * raw_floats(C)          // double-buffered raw inputs
         + 2 * C * kPitch           // rr, kn
         + C * score_pitch(C)       // scores
         + kK * kVB                 // state slice
         + round4(C)                // bonus term
         + 4 * kK                   // segment sums of the cumsum
         + 2 * kK;                  // L_C and exp(L_C)
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_size = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Start copying chunk rows [t0, t0 + C) into one raw buffer; rows past T
// (and the v rows up to C4) are zero-filled.
__device__ __forceinline__ void load_chunk(const float* r, const float* k, const float* lw,
                                           const float* v, const Params& p, int t0,
                                           float* raw, int tid) {
  const int C = p.C;
  const int n = min(C, p.T - t0);
  float* rb = raw;
  float* kb = rb + C * kPitch;
  float* wb = kb + C * kPitch;
  float* vb = wb + C * kPitch;
  for (int i = tid; i < C * (kK / 4); i += kThreads) {
    const int t = i >> 4;
    const int q = (i & 15) * 4;
    const bool valid = t < n;
    const long long tt = t0 + (valid ? t : 0);
    cp_async16(rb + t * kPitch + q, r + tt * p.r_st + q, valid);
    cp_async16(kb + t * kPitch + q, k + tt * p.k_st + q, valid);
    cp_async16(wb + t * kPitch + q, lw + tt * p.w_st + q, valid);
  }
  for (int i = tid; i < round4(C) * (kVB / 4); i += kThreads) {
    const int t = i >> 2;
    const int q = (i & 3) * 4;
    const bool valid = t < n;
    const long long tt = t0 + (valid ? t : 0);
    cp_async16(vb + t * kVB + q, v + tt * p.v_st + q, valid);
  }
  cp_async_commit();
}

// scores(t, s) for s < t, zero elsewhere (s < C4).  Thread (s = tid % SW,
// tq = tid / SW) owns key s and rows tq + TQ*i: a warp shares its rows (rr
// is a broadcast float4) and spans 32 keys (kn float4 rows, conflict-free
// per quarter warp).
template <int SW>
__device__ __forceinline__ void chunk_scores(const float* rr, const float* kn, float* sc,
                                             int C, int tid) {
  constexpr int TQ = kThreads / SW;
  constexpr int NR = SW / TQ;  // rows per thread: TQ * NR = SW >= C4
  const int s = tid % SW;
  const int tq = tid / SW;
  const int sp = score_pitch(C);
  if (s >= round4(C)) return;
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  if (s < C) {
    const float4* kn4 = reinterpret_cast<const float4*>(kn + s * kPitch);
#pragma unroll 2
    for (int d4 = 0; d4 < kK / 4; ++d4) {
      const float4 kv = kn4[d4];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int t = tq + TQ * i;
        if (t < C) acc[i] = dot4(reinterpret_cast<const float4*>(rr + t * kPitch)[d4], kv, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int t = tq + TQ * i;
    if (t < C) sc[t * sp + s] = s < t ? acc[i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2) wkv_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C;
  const int C4 = round4(C);
  const int sp = score_pitch(C);
  float* raw0 = smem;                     // two raw buffers, alternating by chunk
  float* rr = raw0 + 2 * raw_floats(C);   // (C, kPitch) r . exp(L_{t-1} - L_mid)
  float* kn = rr + C * kPitch;            // (C, kPitch) k . exp(L_mid - L_t)
  float* sc = kn + C * kPitch;            // (C, sp) scores
  float* st = sc + C * sp;                // (kK, kVB) state columns of this block
  float* dg = st + kK * kVB;              // (C4) r_t . (u . k_t)
  float* seg = dg + C4;                   // (4, kK)
  float* lend = seg + 4 * kK;             // (kK) L_C
  float* eend = lend + kK;                // (kK) exp(L_C)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int j0 = blockIdx.y * kVB;

  const float* r = p.r + b * p.r_sb + h * p.r_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh + j0;
  const float* lw = p.lw + b * p.w_sb + h * p.w_sh;
  float* o = p.out + b * p.o_sb + h * p.o_sh + j0;
  const float u_lo = p.u[h * kK + lane];
  const float u_hi = p.u[h * kK + lane + 32];

  for (int i = tid; i < kK * kVB; i += kThreads) st[i] = 0.f;
  load_chunk(r, k, lw, v, p, 0, raw0, tid);

  int buf = 0;
  for (int t0 = 0; t0 < p.T; t0 += C, buf ^= 1) {
    const int n = min(C, p.T - t0);  // valid rows of this chunk
    cp_async_wait_all();
    __syncthreads();                 // this chunk has landed; the last one's reads are done
    float* rb = raw0 + buf * raw_floats(C);  // r, then r . exp(L_{t-1})
    float* kb = rb + C * kPitch;             // k, then k . exp(L_C - L_t)
    float* wb = kb + C * kPitch;             // log-decay, clamped, then L_t
    const float4* vb4 = reinterpret_cast<const float4*>(wb + C * kPitch);  // (C4, kVB / 4)
    if (t0 + C < p.T) load_chunk(r, k, lw, v, p, t0 + C, raw0 + (buf ^ 1) * raw_floats(C), tid);

    // 1. Clamp the log-decay and form the bonus term (warp per row).
    for (int t = warp; t < C; t += kThreads / 32) {
      float bonus = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int a = t * kPitch + lane + 32 * half;
        wb[a] = fminf(fmaxf(wb[a], kLogDecayMin), 0.f);
        bonus += rb[a] * (half ? u_hi : u_lo) * kb[a];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      if (lane == 0) dg[t] = bonus;
    }
    __syncthreads();

    // 2. Inclusive cumsum of the log-decay per channel: four segments of
    //    rows per channel, then each segment adds the sums before it.
    {
      const int d = tid & (kK - 1);
      const int q = tid >> 6;
      const int len = (C + 3) / 4;
      const int lo = min(C, q * len);
      const int hi = min(C, lo + len);
      float acc = 0.f;
      for (int t = lo; t < hi; ++t) {
        acc += wb[t * kPitch + d];
        wb[t * kPitch + d] = acc;
      }
      seg[q * kK + d] = acc;
      __syncthreads();
      float off = 0.f;
      for (int s = 0; s < q; ++s) off += seg[s * kK + d];
      for (int t = lo; t < hi; ++t) wb[t * kPitch + d] += off;
      if (q == 0) {
        float total = 0.f;
        for (int s = 0; s < 4; ++s) total += seg[s * kK + d];
        lend[d] = total;
        eend[d] = expf(total);
      }
    }
    __syncthreads();

    // 3. Decay factors.  Each exponent of the mid-point pair is at most
    //    C * 4.6 / 2; the other two are <= 0.
    for (int i = tid; i < C * kK; i += kThreads) {
      const int t = i >> 6;
      const int d = i & (kK - 1);
      const int a = t * kPitch + d;
      const float l_inc = wb[a];
      const float l_prev = t ? wb[a - kPitch] : 0.f;
      const float l_end = lend[d];
      const float l_mid = 0.5f * l_end;
      const float rv = rb[a];
      const float kv = kb[a];
      rr[a] = rv * expf(l_prev - l_mid);
      rb[a] = rv * expf(l_prev);
      kn[a] = kv * expf(l_mid - l_inc);
      kb[a] = kv * expf(l_end - l_inc);
    }
    __syncthreads();

    // 4. The chunk's strictly lower-triangular scores.
    if (C <= 32) {
      chunk_scores<32>(rr, kn, sc, C, tid);
    } else {
      chunk_scores<64>(rr, kn, sc, C, tid);
    }
    __syncthreads();

    // 5. out = bonus . v + scores v + rq S, with S the state before the
    //    chunk.  Thread (t, jq) owns row t, columns 4 jq .. 4 jq + 3.
    {
      const int t = tid >> 2;
      const int jq = tid & 3;
      if (t < C) {
        const float4* st4 = reinterpret_cast<const float4*>(st);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        fma4(acc, dg[t], vb4[t * 4 + jq]);
        for (int s4 = 0; s4 < C4; s4 += 4) {
          const float4 a = *reinterpret_cast<const float4*>(sc + t * sp + s4);
          fma4(acc, a.x, vb4[(s4 + 0) * 4 + jq]);
          fma4(acc, a.y, vb4[(s4 + 1) * 4 + jq]);
          fma4(acc, a.z, vb4[(s4 + 2) * 4 + jq]);
          fma4(acc, a.w, vb4[(s4 + 3) * 4 + jq]);
        }
        const float4* rq4 = reinterpret_cast<const float4*>(rb + t * kPitch);
#pragma unroll 4
        for (int d4 = 0; d4 < kK / 4; ++d4) {
          const float4 a = rq4[d4];
          fma4(acc, a.x, st4[(4 * d4 + 0) * 4 + jq]);
          fma4(acc, a.y, st4[(4 * d4 + 1) * 4 + jq]);
          fma4(acc, a.z, st4[(4 * d4 + 2) * 4 + jq]);
          fma4(acc, a.w, st4[(4 * d4 + 3) * 4 + jq]);
        }
        if (t < n) *reinterpret_cast<float4*>(o + (long long)(t0 + t) * p.o_st + 4 * jq) = acc;
      }
    }
    __syncthreads();

    // 6. S <- exp(L_C) . S + kd^T v.  Thread (d, jq) owns row d, columns
    //    4 jq .. 4 jq + 3.
    {
      const int d = tid >> 2;
      const int jq = tid & 3;
      float4* st4 = reinterpret_cast<float4*>(st);
      float4 acc = st4[d * 4 + jq];
      const float e = eend[d];
      acc.x *= e;
      acc.y *= e;
      acc.z *= e;
      acc.w *= e;
#pragma unroll 4
      for (int t = 0; t < C; ++t) fma4(acc, kb[t * kPitch + d], vb4[t * 4 + jq]);
      st4[d * 4 + jq] = acc;
    }
  }
  __syncthreads();
  const int d = tid >> 2;
  const int jq = tid & 3;
  *reinterpret_cast<float4*>(p.state + ((long long)bh * kK + d) * kK + j0 + 4 * jq) =
      reinterpret_cast<const float4*>(st)[d * 4 + jq];
}

}  // namespace

// Returns a cudaError_t code (0 on success).  Strides are in elements; the
// channel dim of r, k, v, log_w and out must be contiguous, and their rows
// 16-byte aligned (the wrapper checks).
extern "C" int wkv_forward(
    const void* r, const void* k, const void* v, const void* lw, const void* u,
    void* out, void* state,
    int B, int T, int H, int K, int chunk,
    long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh,
    long long o_sb, long long o_st, long long o_sh,
    void* stream) {
  if (K != kK || B < 1 || T < 1 || H < 1 || chunk < 1 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.lw = static_cast<const float*>(lw);
  p.u = static_cast<const float*>(u);
  p.out = static_cast<float*>(out);
  p.state = static_cast<float*>(state);
  p.T = T;
  p.H = H;
  p.C = chunk < T ? chunk : T;
  p.r_sb = r_sb; p.r_st = r_st; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_st = w_st; p.w_sh = w_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  const size_t bytes = smem_floats(p.C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, kK / kVB);
  wkv_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
