// RWKV6 WKV forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:86 wkv_kernel
//   (body _wkv_kernel; entry ops.py::wkv)
// and computes the same function, per (batch, head), with a float32 K x K
// state S and log-decays clamped to [-4.6, 0]:
//   out_t = r_t . (diag(u) k_t^T v_t + S_{t-1})
//   S_t   = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
// in the chunked-parallel form: within a chunk of C tokens, with L_t the
// inclusive cumulative log-decay and L_mid = L_C / 2,
//   scores(t, s) = (r_t . exp(L_{t-1} - L_mid)) . (k_s . exp(L_mid - L_s)), s < t
//   out_t        = scores v + (r_t . u . k_t) v_t + (r_t . exp(L_{t-1})) S_c
//   S_{c+1}      = exp(L_C) . S_c + (k . exp(L_C - L))^T v
// with S_c the state entering chunk c.  Inputs and output are float32;
// r/k/v/log_w (B,T,H,K) are read in place through their strides, out is
// (B,T,H,K), the final state (B,H,K,K).  K = 64 only; 1 <= C <= 64.  The
// ragged last chunk is zero-filled (r = k = v = 0, log-decay 0), so the
// final state is the padded form's.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 off the tensor
// cores): at B=1, T=1024, H=64, K=64 the function must move r, k, v, lw
// and out once plus u and the final state, 84.9 MB, 25.4 us; the
// recurrence's 4 K^2 operations per token and head (1.07 GFLOP, 16 us) come
// second.  It is bound by bytes.
//
// Design: two passes, and only one thing is sequential, the K x K state
// crossing chunk boundaries.
//   * wkv_states_kernel (pass A): grid (B*H, K/16); a block owns 16 rows of
//     one head's state (rows of S are independent: row d decays by
//     exp(L_C[d]) and gains kd[:, d]^T v) in registers, walks the chunks in
//     order and sets S <- exp(L_C) . S + kd^T v.  It forms the cumsum and
//     kd = k . exp(L_C - L_t) of its 16 channels only, for as many chunks
//     at once as fill 64 rows (two at chunk 32), so the serial chain has
//     one cumsum phase and one product phase per 64 tokens; both passes
//     are compiled for each padded chunk length, so these loops unroll.  A
//     two-stage cp.async ring brings the next step's k, log_w and v while
//     a step computes (a third stage measured no faster and left pass B no
//     room beside two pass-A blocks).  Four compute warps stage each S_c in shared
//     memory; a fifth warp copies it to a (B,H,n_chunks,K,K) scratch
//     tensor, fences and counts it in a per-chunk flag, so neither the
//     stores nor the fence sit on the chain.
//   * wkv_out_kernel (pass B): grid B*H*n_chunks, every chunk in parallel,
//     chunk-major.  A block forms the chunk's cumsum, the mid-point factors
//     rr and kn and rq = r . exp(L_{t-1}) once, the strictly
//     lower-triangular scores once (tiles above the diagonal are skipped),
//     then waits for its chunk's flag, copies S_c over kn and rr (dead by
//     then) and forms out = scores v + rq S_c + bonus . v.
//   * Pass B is launched as a programmatic dependent of pass A: its blocks
//     may start as soon as every pass-A block runs, two beside the two
//     pass-A blocks of an SM (69 KB and 41 KB of shared memory at chunk 32),
//     and wait on the flags.
//   * The products (scores C x K . K x C, the inter-chunk C x K . K x K,
//     the state increment K x C . C x K) run on the tensor cores as
//     mma.sync m16n8k8 TF32 with split float32 operands: a = hi + lo (both
//     cvt.rna.tf32), accumulating lo.hi + hi.lo + hi.hi in float32, which
//     keeps float32 accuracy.  The exponents and the cumsum stay float32 on
//     the CUDA cores.
//   * r . exp(L_{t-1}) and k . exp(L_C - L_t) are formed directly, not as
//     products of the mid-point factors, so they never meet inf * 0.  The
//     scores keep the reference's mid-point factors, and with them its
//     limit: at chunk 64 a summed log-decay below about -177 overflows.
//
// The design's own bytes at that shape (16.8 MB per (B,T,H,K) tensor):
// pass A reads k and log_w once and v once per 16-row block (4x, the four
// blocks of a head run side by side, so L2 serves repeats) and writes the
// 33.6 MB of chunk states; pass B reads r, k, v, log_w and the chunk
// states and writes out.  At least 84.9 + 117.4 = 202 MB of device-memory
// traffic (60 us at the memory rate) where L2 keeps none of the chunk
// states, against the function's 84.9 MB.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;             // head size: the only one taken
constexpr int kMaxChunk = 64;
constexpr int kComputeA = 128;     // pass A: four compute warps ...
constexpr int kThreadsA = kComputeA + 32;  // ... and one that publishes S_c
constexpr int kStP = kK + 8;       // row pitch of pass A's S_c staging tiles
constexpr int kRows = 16;          // state rows per pass-A block
constexpr int kNtA = kK / 8 / (kComputeA / 32);  // 8-column state tiles per compute warp
constexpr int kStages = 2;         // pass A's cp.async ring
constexpr int kSegsA = kComputeA / kRows;  // cumsum segments per channel, pass A
constexpr int kThreadsB = 256;     // pass B: eight warps
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kUnitNt = 2;         // pass B: 8-column output tiles per warp unit
constexpr int kSegsB = kThreadsB / kK;     // cumsum segments per channel, pass B
// Row pitches (floats), chosen so that mma fragment loads are free of bank
// conflicts: tiles read as A[row][k] (or as a B given as [n][k]) have
// pitch = 4 mod 32, tiles read as B[k][n] pitch = 8 mod 32 (or 24 mod 32).
// Pass B's S_c tile, read as B[k][n], takes the pitch of the buffers it
// reuses (4 mod 32: two-way conflicts).
constexpr int kRP = kK + 4;
constexpr int kVP = kK + 8;
constexpr int kKdP = kRows + 8;
constexpr int kLayoutRejected = -1;
constexpr float kLogDecayMin = -4.6f;

enum { kR = 0, kKey = 1, kV = 2, kW = 3, kO = 4 };

struct Params {
  const float* in[4];  // r, k, v, log_w
  const float* u;      // (H, K) contiguous
  float* out;
  float* state;        // (B, H, K, K) contiguous
  float* states;       // (B, H, nc, K, K) contiguous: S_c entering chunk c
  int* ready;          // (B, H, nc): pass-A blocks that have published S_c
  int T, H, C, C16, nc;
  long long sb[5], st[5], sh[5];  // batch, time, head strides of r, k, v, log_w, out
};

__host__ __device__ inline int round16(int c) { return (c + 15) & ~15; }

// Chunks per pass-A step: as many whole chunks as fit in 64 rows.
__host__ __device__ constexpr int chunks_per_step(int C16) {
  return C16 <= 16 ? 4 : C16 <= 32 ? 2 : 1;
}

size_t states_smem_floats(int C16) {
  const int G = chunks_per_step(C16);
  return kStages * G * C16 * (2 * kRows + kVP) + G * C16 * kKdP + kSegsA * kRows + G * kRows +
         G * kRows * kStP;
}

// Pass B's S_c tile (kK x kRP) goes over kn and rr, dead once the scores
// are formed, where those two fill it.
__host__ __device__ constexpr bool out_states_alias(int C16) { return 2 * C16 >= kK; }

size_t out_smem_floats(int C16) {
  return 3 * C16 * kRP + C16 * kVP + (out_states_alias(C16) ? 0 : kK * kRP) +
         C16 * (C16 + 4) + C16 + kSegsB * kK;
}

__device__ __forceinline__ float clamp_decay(float x) {
  return fminf(fmaxf(x, kLogDecayMin), 0.f);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_size = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_size));
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
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
// (q + 4, g).  m is [row][k] with row pitch `pitch`.
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

// Start copying one step's chunks (chunks G step .. G step + G - 1, each
// C16 rows): k and log_w of this block's 16 channels and v (all 64
// columns) into one ring stage.  Rows past a chunk's end are zero-filled;
// chunks past the last are not copied (nor used).
template <int C16>
__device__ __forceinline__ void load_states_step(const float* k, const float* lw, const float* v,
                                                 const Params& p, int step, float* stage,
                                                 int tid) {
  constexpr int G = chunks_per_step(C16);
  constexpr int rows = G * C16;
  float* kb = stage;
  float* wb = kb + rows * kRows;
  float* vb = wb + rows * kRows;
#pragma unroll
  for (int ci = 0; ci < G; ++ci) {
    const int c = step * G + ci;
    if (c >= p.nc) break;
    const int t0 = c * p.C;
    const int n = min(p.C, p.T - t0);
    const int r0 = ci * C16;
    for (int i = tid; i < C16 * (kRows / 4); i += kComputeA) {
      const int t = i >> 2;
      const int j = (i & 3) * 4;
      const bool valid = t < n;
      const long long tt = t0 + (valid ? t : 0);
      cp_async16(kb + (r0 + t) * kRows + j, k + tt * p.st[kKey] + j, valid);
      cp_async16(wb + (r0 + t) * kRows + j, lw + tt * p.st[kW] + j, valid);
    }
    for (int i = tid; i < C16 * (kK / 4); i += kComputeA) {
      const int t = i >> 4;
      const int j = (i & 15) * 4;
      const bool valid = t < n;
      const long long tt = t0 + (valid ? t : 0);
      cp_async16(vb + (r0 + t) * kVP + j, v + tt * p.st[kV] + j, valid);
    }
  }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Named barriers of pass A: 0 (__syncthreads) is the whole block; kBarStaged
// is the compute warps' arrival with a step's S_c staged, which the
// publisher waits on; kBarCompute is the compute warps alone.
constexpr int kBarStaged = 1;
constexpr int kBarCompute = 2;

// A compute warp's slice of a state block (rows 0..15 of the block,
// kNtA 8-column tiles) into a row-major tile with row pitch `pitch`.
__device__ __forceinline__ void put_state(float* s, int pitch, const float (&S)[kNtA][4],
                                          int warp, int g, int q) {
#pragma unroll
  for (int nt = 0; nt < kNtA; ++nt) {
    const int j = (warp * kNtA + nt) * 8 + 2 * q;
    *reinterpret_cast<float2*>(s + g * pitch + j) = make_float2(S[nt][0], S[nt][1]);
    *reinterpret_cast<float2*>(s + (g + 8) * pitch + j) = make_float2(S[nt][2], S[nt][3]);
  }
}

// Pass A: the states entering every chunk, and the final state.  A block
// owns 16 rows of one head's state.  A step takes G chunks of C16 rows at
// once (G C16 <= 64): one cumsum phase and one product phase for all G,
// each chunk's product in its own accumulators, then the G state updates
// one after another.
template <int C16>
__global__ void __launch_bounds__(kThreadsA) wkv_states_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int G = chunks_per_step(C16);
  constexpr int rows = G * C16;
  constexpr int stage = rows * (2 * kRows + kVP);
  const int nc = p.nc;
  float* ring = smem;
  float* kd = ring + kStages * stage;  // (rows, kKdP) k . exp(L_C - L_t)
  float* seg = kd + rows * kKdP;       // (kSegsA, kRows) segment sums
  float* eend = seg + kSegsA * kRows;  // (G, kRows) exp(L_C)
  // (G, kRows, kStP) S_c of this step's chunks.  The compute warps write
  // it after the step's first barrier, which the publisher reaches only
  // once it has copied the last step's.
  float* staged = eend + G * kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int d0 = blockIdx.y * kRows;
  const float* k = p.in[kKey] + b * p.sb[kKey] + h * p.sh[kKey] + d0;
  const float* lw = p.in[kW] + b * p.sb[kW] + h * p.sh[kW] + d0;
  const float* v = p.in[kV] + b * p.sb[kV] + h * p.sh[kV];
  float* states = p.states + (long long)bh * nc * kK * kK;
  int* ready = p.ready + (long long)bh * nc;
  const int steps = (nc + G - 1) / G;
  // Every block of this grid is running: pass B may start beside it.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == kComputeA / 32) {
    // The publisher: each step, copy the staged S_c of the step's chunks
    // to the scratch tensor, make the stores visible at gpu scope and
    // count them in the chunks' flags, off the compute warps' chain.
    for (int step = 0; step < steps; ++step) {
      __syncthreads();
      bar_sync(kBarStaged, kThreadsA);
#pragma unroll
      for (int ci = 0; ci < G; ++ci) {
        const int c = step * G + ci;
        if (c >= nc) break;
        float* dst = states + (long long)c * kK * kK + d0 * kK;
        for (int i = lane; i < kRows * kK / 4; i += 32) {
          const int row = i / (kK / 4);
          const int j = (i % (kK / 4)) * 4;
          *reinterpret_cast<float4*>(dst + row * kK + j) =
              *reinterpret_cast<const float4*>(staged + (ci * kRows + row) * kStP + j);
        }
      }
      __syncwarp();
      if (lane == 0) {
        asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
#pragma unroll
        for (int ci = 0; ci < G; ++ci) {
          if (step * G + ci < nc) atomicAdd(ready + step * G + ci, 1);
        }
      }
    }
    return;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_states_step<C16>(k, lw, v, p, s, ring + s * stage, tid);
    cp_async_commit();
  }

  // Thread (dl, sg) sums rows sg * len .. of channel dl; a chunk has
  // kSegsA / G segments.
  constexpr int len = rows / kSegsA;
  const int dl = tid & (kRows - 1);
  const int sg = tid / kRows;
  const int seg0 = sg / (kSegsA / G) * (kSegsA / G);  // this chunk's first segment
  float S[kNtA][4] = {};
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step has landed; the last step's stage, kd and seg are free
    {
      const int sn = step + kStages - 1;
      if (sn < steps) load_states_step<C16>(k, lw, v, p, sn, ring + (sn % kStages) * stage, tid);
      cp_async_commit();
    }
    const float* kb = ring + (step % kStages) * stage;
    const float* wb = kb + rows * kRows;
    const float* vb = wb + rows * kRows;

    // 1. Segment sums of the clamped log-decay, channel dl.
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < len; ++i) acc += clamp_decay(wb[(sg * len + i) * kRows + dl]);
    seg[sg * kRows + dl] = acc;
    bar_sync(kBarCompute, kComputeA);

    // 2. kd = k . exp(L_C - L_t) and exp(L_C), each chunk on its own.
    float off = 0.f;
    float total = 0.f;
    for (int s = seg0; s < seg0 + kSegsA / G; ++s) {
      const float x = seg[s * kRows + dl];
      if (s < sg) off += x;
      total += x;
    }
    float l = off;
#pragma unroll
    for (int i = 0; i < len; ++i) {
      const int t = sg * len + i;
      l += clamp_decay(wb[t * kRows + dl]);
      kd[t * kKdP + dl] = kb[t * kRows + dl] * expf(total - l);
    }
    if (sg == seg0) eend[sg / (kSegsA / G) * kRows + dl] = expf(total);
    bar_sync(kBarCompute, kComputeA);

    // 3. Each chunk's kd^T v: this warp's 16 rows x 8 kNtA columns.
    float P[G][kNtA][4] = {};
#pragma unroll
    for (int ci = 0; ci < G; ++ci) {
#pragma unroll
      for (int ks = 0; ks < C16 / 8; ++ks) {
        const int k0 = ci * C16 + ks * 8;
        const FragA a = load_a_t(kd, kKdP, 0, k0, g, q);
#pragma unroll
        for (int nt = 0; nt < kNtA; ++nt) {
          mma3(P[ci][nt], a, load_b(vb, kVP, k0, (warp * kNtA + nt) * 8, g, q));
        }
      }
    }

    // 4. S_c staged for the publisher, then S <- exp(L_C) . S + kd^T v,
    //    chunk after chunk.
#pragma unroll
    for (int ci = 0; ci < G; ++ci) {
      const int c = step * G + ci;
      if (c >= nc) break;
      put_state(staged + ci * kRows * kStP, kStP, S, warp, g, q);
      const float e0 = eend[ci * kRows + g];
      const float e1 = eend[ci * kRows + g + 8];
#pragma unroll
      for (int nt = 0; nt < kNtA; ++nt) {
        S[nt][0] = fmaf(e0, S[nt][0], P[ci][nt][0]);
        S[nt][1] = fmaf(e0, S[nt][1], P[ci][nt][1]);
        S[nt][2] = fmaf(e1, S[nt][2], P[ci][nt][2]);
        S[nt][3] = fmaf(e1, S[nt][3], P[ci][nt][3]);
      }
    }
    bar_arrive(kBarStaged, kThreadsA);
  }
  put_state(p.state + ((long long)bh * kK + d0) * kK, kK, S, warp, g, q);
}

// Pass B: one chunk's output from its inputs and S_c.
template <int C16>
__global__ void __launch_bounds__(kThreadsB) wkv_out_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int scp = C16 + 4;
  float* rb = smem;              // (C16, kRP) r, then rq = r . exp(L_{t-1})
  float* kb = rb + C16 * kRP;    // (C16, kRP) k, then kn = k . exp(L_mid - L_t)
  float* wb = kb + C16 * kRP;    // (C16, kRP) log_w, then rr = r . exp(L_{t-1} - L_mid)
  float* vb = wb + C16 * kRP;    // (C16, kVP) v
  constexpr bool alias = out_states_alias(C16);
  float* sb = alias ? kb : vb + C16 * kVP;  // (kK, kRP) S_c, after the scores
  float* sc = vb + C16 * kVP + (alias ? 0 : kK * kRP);  // (C16, scp) scores
  float* dg = sc + C16 * scp;    // (C16) r_t . (u . k_t)
  float* seg = dg + C16;         // (kSegsB, kK) segment sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int nbh = gridDim.x / p.nc;
  const int c = blockIdx.x / nbh;  // chunk-major: early chunks, whose S_c comes first, first
  const int bh = blockIdx.x % nbh;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int t0 = c * p.C;
  const int n = min(p.C, p.T - t0);  // valid rows of this chunk

  {
    float* dst[4] = {rb, kb, vb, wb};
    const int pitch[4] = {kRP, kRP, kVP, kRP};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* src = p.in[x] + b * p.sb[x] + h * p.sh[x];
      for (int i = tid; i < C16 * (kK / 4); i += kThreadsB) {
        const int t = i >> 4;
        const int j = (i & 15) * 4;
        const bool valid = t < n;
        const long long tt = t0 + (valid ? t : 0);
        cp_async16(dst[x] + t * pitch[x] + j, src + tt * p.st[x] + j, valid);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // 1. The bonus term (a warp per row) and segment sums of the clamped
  //    log-decay (thread (d, sg)).
  {
    const float u0 = p.u[h * kK + lane];
    const float u1 = p.u[h * kK + lane + 32];
    for (int t = warp; t < C16; t += kWarpsB) {
      const float* rt = rb + t * kRP;
      const float* kt = kb + t * kRP;
      float x = rt[lane] * u0 * kt[lane] + rt[lane + 32] * u1 * kt[lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) dg[t] = x;
    }
  }
  const int d = tid & (kK - 1);
  const int sg = tid / kK;
  constexpr int len = C16 / kSegsB;
  {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < len; ++i) acc += clamp_decay(wb[(sg * len + i) * kRP + d]);
    seg[sg * kK + d] = acc;
  }
  __syncthreads();

  // 2. Decay factors, in place; each exponent of the mid-point pair is at
  //    most C * 4.6 / 2, the other one <= 0.
  {
    float off = 0.f;
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < kSegsB; ++s) {
      const float x = seg[s * kK + d];
      if (s < sg) off += x;
      total += x;
    }
    const float l_mid = 0.5f * total;
    float l = off;
#pragma unroll
    for (int i = 0; i < len; ++i) {
      const int a = (sg * len + i) * kRP + d;
      const float l_prev = l;
      l += clamp_decay(wb[a]);
      const float rv = rb[a];
      wb[a] = rv * expf(l_prev - l_mid);
      rb[a] = rv * expf(l_prev);
      kb[a] = kb[a] * expf(l_mid - l);
    }
  }
  __syncthreads();

  // 3. Strictly lower-triangular scores, tile by tile (16 x 8); tiles with
  //    no s < t are neither computed nor read.
  constexpr int mtiles = C16 / 16;
  constexpr int ntiles = C16 / 8;
  for (int i = warp; i < mtiles * ntiles; i += kWarpsB) {
    const int mt = i / ntiles;
    const int nt = i % ntiles;
    if (nt * 8 > mt * 16 + 14) continue;
    float acc[4] = {};
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      mma3(acc, load_a(wb, kRP, mt * 16, ks * 8, g, q), load_b_t(kb, kRP, ks * 8, nt * 8, g, q));
    }
    const int s = nt * 8 + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = mt * 16 + g + 8 * half;
      *reinterpret_cast<float2*>(sc + t * scp + s) =
          make_float2(s < t ? acc[2 * half] : 0.f, s + 1 < t ? acc[2 * half + 1] : 0.f);
    }
  }

  // S_c: wait until the four pass-A blocks of this head have published it.
  if (tid == 0) {
    const int* ready = p.ready + (long long)bh * p.nc + c;
    while (load_acquire(ready) < kK / kRows) __nanosleep(256);
  }
  __syncthreads();  // also: the scores are in shared memory
  const float* s_c = p.states + ((long long)bh * p.nc + c) * kK * kK;
  for (int i = tid; i < kK * (kK / 4); i += kThreadsB) {
    const int row = i >> 4;
    const int j = (i & 15) * 4;
    cp_async16(sb + row * kRP + j, s_c + row * kK + j, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 4. out = scores v + rq S_c + bonus . v: a warp per 16 rows x kUnitNt
  //    8-column tiles.
  float* o = p.out + b * p.sb[kO] + h * p.sh[kO];
  constexpr int kUnits = kK / 8 / kUnitNt;  // units per 16 rows
  for (int i = warp; i < mtiles * kUnits; i += kWarpsB) {
    const int mt = i / kUnits;
    const int n0 = (i % kUnits) * kUnitNt * 8;
    float acc[kUnitNt][4] = {};
    const int ks_end = min(ntiles, 2 * mt + 2);
    for (int ks = 0; ks < ks_end; ++ks) {
      const FragA a = load_a(sc, scp, mt * 16, ks * 8, g, q);
#pragma unroll
      for (int nt = 0; nt < kUnitNt; ++nt) {
        mma3(acc[nt], a, load_b(vb, kVP, ks * 8, n0 + nt * 8, g, q));
      }
    }
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      const FragA a = load_a(rb, kRP, mt * 16, ks * 8, g, q);
#pragma unroll
      for (int nt = 0; nt < kUnitNt; ++nt) {
        mma3(acc[nt], a, load_b(sb, kRP, ks * 8, n0 + nt * 8, g, q));
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = mt * 16 + g + 8 * half;
      if (t >= n) continue;
      const float bonus = dg[t];
      float* ot = o + (long long)(t0 + t) * p.st[kO];
#pragma unroll
      for (int nt = 0; nt < kUnitNt; ++nt) {
        const int j = n0 + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(ot + j) =
            make_float2(fmaf(bonus, vb[t * kVP + j], acc[nt][2 * half]),
                        fmaf(bonus, vb[t * kVP + j + 1], acc[nt][2 * half + 1]));
      }
    }
  }
  // Pass A's grid (its final state too) completes before this one does.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace

extern "C" {

// The C entry's argument block, packed by ops.py (_ENTRY_ARGS).
struct EntryArgs {
  const void* in[4];         // r, k, v, log_w
  const void* u;             // (H, K) contiguous
  void* out;                 // (B, T, H, K)
  void* state;               // (B, H, K, K) contiguous
  void* states;              // (B, H, n_chunks, K, K) float32 scratch, then (B, H,
                             // n_chunks) int32 flags
  long long strides[20];     // (batch, time, head, channel) of r, k, v, log_w, out
  void* stream;
  int B, T, H, K, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 256, "EntryArgs must match ops.py's packing");

// Returns the first non-zero cudaError_t of the flags' memset and the two
// launches (0 on success), or kLayoutRejected (-1) when K is not 64, the chunk is over 64,
// or a tensor is not read as 16-byte rows (base 16-byte aligned, channel
// stride 1, every other stride of a dim longer than 1 a multiple of 4);
// nothing is launched then.
int wkv_forward(const EntryArgs* a) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->chunk < 1) return (int)cudaErrorInvalidValue;
  const int C = a->chunk < a->T ? a->chunk : a->T;
  if (a->K != kK || C > kMaxChunk) return kLayoutRejected;
  const int sizes[3] = {a->B, a->T, a->H};
  for (int x = 0; x < 5; ++x) {
    const void* ptr = x < 4 ? a->in[x] : a->out;
    const long long* st = a->strides + 4 * x;
    if (reinterpret_cast<uintptr_t>(ptr) % 16 || st[3] != 1) return kLayoutRejected;
    for (int dim = 0; dim < 3; ++dim) {
      if (sizes[dim] > 1 && st[dim] % 4) return kLayoutRejected;
    }
  }
  Params p;
  for (int x = 0; x < 4; ++x) p.in[x] = static_cast<const float*>(a->in[x]);
  p.u = static_cast<const float*>(a->u);
  p.out = static_cast<float*>(a->out);
  p.state = static_cast<float*>(a->state);
  p.states = static_cast<float*>(a->states);
  p.T = a->T;
  p.H = a->H;
  p.C = C;
  p.C16 = round16(C);
  p.nc = (a->T + C - 1) / C;
  const long long n_states = (long long)a->B * a->H * p.nc;
  p.ready = reinterpret_cast<int*>(p.states + n_states * kK * kK);
  for (int x = 0; x < 5; ++x) {
    p.sb[x] = a->strides[4 * x];
    p.st[x] = a->strides[4 * x + 1];
    p.sh[x] = a->strides[4 * x + 2];
  }
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  const size_t bytes_a = states_smem_floats(p.C16) * sizeof(float);
  const size_t bytes_b = out_smem_floats(p.C16) * sizeof(float);
  void (*states_kernel)(Params) = wkv_states_kernel<64>;
  void (*out_kernel)(Params) = wkv_out_kernel<64>;
  switch (p.C16) {
    case 16: states_kernel = wkv_states_kernel<16>; out_kernel = wkv_out_kernel<16>; break;
    case 32: states_kernel = wkv_states_kernel<32>; out_kernel = wkv_out_kernel<32>; break;
    case 48: states_kernel = wkv_states_kernel<48>; out_kernel = wkv_out_kernel<48>; break;
    default: break;
  }
  cudaError_t err = cudaFuncSetAttribute(states_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes_b);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(p.ready, 0, n_states * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  states_kernel<<<dim3(a->B * a->H, kK / kRows), kThreadsA, bytes_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Pass B launches as soon as every pass-A block runs (programmatic
  // dependent launch) and waits for each S_c on its flag.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_states));
  cfg.blockDim = dim3(kThreadsB);
  cfg.dynamicSmemBytes = bytes_b;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, out_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
