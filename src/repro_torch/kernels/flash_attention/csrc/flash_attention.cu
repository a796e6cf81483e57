// Flash attention for Hopper (sm_90a), plain C interface for ctypes: the
// forward (below) and, for training, its backward (at the end of the file).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
//   (body _flash_kernel; entry ops.py::flash_attention)
// and computes the same function: blockwise online-softmax attention with
// a causal mask, an optional sliding window (key > query - window), a
// runtime kv_len mask for padded keys and scale 1/sqrt(D) by default.  The
// running max, the denominator and the accumulator are float32; the output
// has q's dtype.  Rows with no valid key give zeros.
//
// What it does differently from the TPU kernel:
//   * q (B,S,H,D) and k/v (B,T,KV,D) are read in place through their
//     strides; q head h reads kv head h / (H/KV) instead of a repeated copy.
//   * The ragged S and T edges are masked (or zero-filled by TMA) here
//     instead of padded copies.
//   * The TPU grid's sequential kv axis becomes a loop inside the block,
//     which stops at the causal diagonal and starts at the window's lower
//     edge, so dead kv tiles are never loaded.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at S=T=512,
// H=16, D=128 bf16 the q/k/v/o traffic is about 8.4 MB, about 2.5 us, and
// the kernel is bound by bytes; at S=2048 causal it is about 17 GFLOP,
// about 17 us, and bound by operations.  hymba-1.5b's head dim 64 (H=25,
// KV=5) halves the bytes and operations per head.
//
// bfloat16, flash_fwd_kernel_sm90: what the design does about that bound.
//   * Both products run on the tensor cores through wgmma (bf16 in, f32
//     accumulate).  S = Q K^T reads Q and K from shared memory (both
//     K-major).  O += P V takes P from registers: the m64nNk16 accumulator
//     layout is the A-fragment layout of the next wgmma, so the scores are
//     converted in place and P never touches shared memory.  V is read from
//     shared memory as an MN-major B (the transpose bit), so no transposed
//     copy is made.
//   * P enters the second product as two bf16 terms, hi = bf16(p) and
//     lo = bf16(p - hi).  With one term P keeps 8 bits, and the output then
//     differs from the float32 softmax by a bf16 ulp where |o| >= 2 (0.0156,
//     above the 1e-2 tolerance the kernel is held to): the emulation in
//     tests/test_torch_flash_p_rounding.py finds one such output per call
//     at olmo-1b S=512.  Two terms keep about 16 bits for a second P V
//     wgmma per 16 keys.
//   * K/V tiles arrive through a two-stage ring in shared memory filled by
//     TMA.  One producer warp issues cp.async.bulk.tensor loads through a
//     4-D tensor map per operand ({D, heads, length, B}, built in the C
//     entry point; cuTensorMapEncodeTiled is reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda).  Each stage
//     completes on an mbarrier (transaction bytes); the consumers release
//     a K stage as soon as its scores are in registers and a V stage when
//     its product is done, each on a barrier of its own, so the next K
//     tile is loading a whole tile step before it is needed.  Every tile
//     uses the 128-byte swizzle (64 bf16 columns per row chunk), which the
//     wgmma descriptors match.  TMA zero-fills rows past S and T; the zeros
//     are masked or never stored.
//   * Inside a warpgroup, tile i's P V product runs under tile i+1's
//     S = Q K^T and softmax (both products are asynchronous wgmma groups).
//   * Masks only where they bite: a tile is masked element by element only
//     when it crosses the causal diagonal, the window's lower edge or
//     kv_len.  log2(e) is folded into the scale and exponentials are exp2f.
//   * A block is one consumer warpgroup that owns 64 q rows and one
//     producer warp.  128-row blocks (two consumer warpgroups sharing each
//     K/V tile) were 8-38 % slower at every main-path shape: they halve the
//     blocks and compute tiles the first warpgroup's causal edge does not
//     need.  Blocks are launched longest causal q tile first (grid y
//     reversed, heads on x), so short tiles fill the tail.
//   What it does not do yet: run persistent blocks, or split a long q
//   tile's keys over blocks (at S <= 512 the longest tile's chain of tile
//   steps bounds the time, not the card's rate).
//
// float32, flash_fwd_kernel: the scalar v1 body.  It is the parity path
// (held at 1e-5, which TF32 or bf16 splits would not meet) and carries no
// serving traffic.  One block of 256 threads per (b, h, 64-row q tile);
// each 64-key K/V tile is staged in shared memory and both products run as
// scalar FMAs on the CUDA cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTensorMapRejected = -1;  // not a cudaError_t: those are >= 0

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // <= 0: no window
  int kv_len;  // keys at index >= kv_len are masked
  float scale;
  float* lse;  // (B, H, S) log-sum-exp of each row's scaled scores, or null
};

// ===========================================================================
// float32: the scalar v1 body
// ===========================================================================

constexpr int kBlockM = 64;            // q rows per block
constexpr int kBlockN = 64;            // keys per kv tile
constexpr int kThreads = 256;          // 16 x 16 thread grid
constexpr int kPPitch = kBlockN + 1;   // pitch of the probability tile

// Shared-memory layout for head dim D: q and K tiles at a padded row pitch
// (no bank conflicts), the V tile unpadded; the P tile aliases the K tile.
template <int D>
struct Tile {
  static constexpr int kPitch = D + 1;
  static constexpr size_t kSmemBytes = sizeof(float) * (2 * kBlockM * kPitch + kBlockN * D);
  static_assert(D % 16 == 0, "16 lanes share a row's head dims");
  static_assert(kBlockM * kPPitch <= kBlockN * kPitch, "the P tile must fit in the K tile");
};

// Thread (tx, ty) of the 16 x 16 grid owns q rows ty + 16*i (i < 4) of the
// tile: scores at keys tx + 16*j (j < 4) and outputs at dims tx + 16*j
// (j < D/16).  A row's 16 owners are 16 adjacent lanes of one warp, so row
// reductions are four xor-shuffles.
template <int kHeadDim>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Params p) {
  constexpr int kPitch = Tile<kHeadDim>::kPitch;
  constexpr int kOut = kHeadDim / 16;    // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // (kBlockM, kPitch), pre-scaled q
  float* ks = qs + kBlockM * kPitch;     // (kBlockN, kPitch); then P tile
  float* vs = ks + kBlockN * kPitch;     // (kBlockN, kHeadDim)
  float* ps = ks;                        // (kBlockM, kPPitch), aliases ks

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < kBlockM * kHeadDim; idx += kThreads) {
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const int m = m0 + r;
    qs[r * kPitch + c] = m < p.S ? q[m * p.q_ss + c] * p.scale : 0.f;
  }

  float row_max[4], row_sum[4], acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  const int n_valid = min(p.kv_len, p.T);
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + kBlockM);  // keys <= last q row
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1);  // keys > first q row - window
  kv_start = (kv_start / kBlockN) * kBlockN;

  for (int n0 = kv_start; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile's P and V reads are done
    for (int idx = tid; idx < kBlockN * kHeadDim; idx += kThreads) {
      const int r = idx / kHeadDim, c = idx % kHeadDim;
      const int n = n0 + r;
      const bool in = n < p.T;
      ks[r * kPitch + c] = in ? k[n * p.k_ss + c] : 0.f;
      vs[r * kHeadDim + c] = in ? v[n * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kPitch + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kPitch + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = m0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + tx + 16 * j;
        bool ok = kpos < n_valid;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(row_max[i], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {  // no valid key in this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(row_max[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row_sum[i] = row_sum[i] * alpha + sum;
      row_max[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading ks: reuse it for P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float pv[4], vv[kOut];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPPitch + n];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = vs[n * kHeadDim + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.S) continue;
    const float denom = fmaxf(row_sum[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j) o[m * p.o_ss + tx + 16 * j] = acc[i][j] / denom;
    // -inf for a row with no valid key (row_max -inf, row_sum 0).
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.H + h) * p.S + m] = row_max[i] + logf(row_sum[i]);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = Tile<D>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.S + kBlockM - 1) / kBlockM, p.H, B);
  flash_fwd_kernel<D><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

// ===========================================================================
// bfloat16: wgmma, TMA and an mbarrier ring (sm_90a)
// ===========================================================================

namespace sm90 {

constexpr int kStages = 2;          // K/V tiles in flight
constexpr int kBM = 64;             // q rows per block: one consumer warpgroup
constexpr int kBN = 64;             // keys per K/V tile
constexpr int kBlockThreads = 160;  // the consumer warpgroup and one producer warp
constexpr int kRowBytes = 128;      // one swizzled row chunk: 64 bf16 columns

// Shared memory (from a 1024-byte aligned base; every tile starts on a
// 1024-byte boundary, the 128-byte swizzle's period):
//   q       D/64 chunks x 64 rows x 128 B
//   k, v    kStages x (D/64 chunks x kBN rows x 128 B) each
//   barriers  q, k[kStages], v[kStages], k_free[kStages], v_free[kStages]
template <int D>
struct Cfg {
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kQBytes = kBM * D * 2;    // the block's q rows
  static constexpr uint32_t kTileBytes = kBN * D * 2; // one K or V tile
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 4 * kStages) + 1024;
  static_assert(D % 64 == 0 && kBN % 16 == 0, "tiles are whole swizzle chunks and k16 steps");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  A
// phase that never completes is a bug: trap after about 2^34 cycles
// (several seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the accumulator registers to this point in program order, so no
// read or write of them moves across an asynchronous wgmma or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (q, K): 8-row groups 1024 B apart (SBO), LBO unused.  MN-major V: the
// 64-column chunks LBO apart, 8-key groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// d (64 x N, f32) += A (64 x 16, registers) x B (16 x N, smem, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b);

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) x B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each packed low element first.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// Thread t of the consumer warpgroup (warp w = t / 32, lane l) owns q rows
// 16*w + l/4 + {0, 8} of the block's 64, and in each 8-column group j of an m64nN
// accumulator the columns 8*j + 2*(l%4) + {0, 1}: element [4*j + 2*i + c]
// is (row 16*w + l/4 + 8*i, column 8*j + 2*(l%4) + c).  A row's four
// owners are lanes 4*(l/4) .. 4*(l/4) + 3.
struct Rows {
  int mw;    // the block's first q row
  int row0;  // this thread's rows: row0 and row0 + 8
  int col0;  // this thread's first column in each 8-column group
};

// sc (64 x kBN) = q (64 x D) K^T (kBN x D), issued and committed, not waited.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t koff = (kk % 4) * 32;  // 16 columns inside a 128-byte row chunk
    wgmma_ss_n64(sc, desc_sw128(q_base + (kk / 4) * kBM * kRowBytes + koff, 16, 1024),
                 desc_sw128(k_base + (kk / 4) * kBN * kRowBytes + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o (64 x D) += P (64 x kBN, registers, hi + lo) V (kBN x D), issued and
// committed, not waited.  Keys 16*kk .. 16*kk + 15 are accumulator groups
// 2*kk and 2*kk + 1, i.e. A fragments [4*kk, 4*kk + 4).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p_hi)[kBN / 4],
                                         const uint32_t (&p_lo)[kBN / 4], uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
    const uint32_t lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
    const uint64_t dv = desc_sw128(v_base + kk * 16 * kRowBytes, kBN * kRowBytes, 1024);
    wgmma_rs_tb<D>(o, hi, dv);
    wgmma_rs_tb<D>(o, lo, dv);
  }
  wgmma_commit();
}

// The probabilities as A fragments: (r, k), (r+8, k), (r, k+8), (r+8, k+8)
// for each 16 keys, i.e. consecutive pairs of the accumulator.
__device__ __forceinline__ void to_fragments(const float (&sc)[kBN / 2], uint32_t (&p_hi)[kBN / 4],
                                             uint32_t (&p_lo)[kBN / 4]) {
#pragma unroll
  for (int f = 0; f < kBN / 4; ++f) split_bf16x2(sc[2 * f], sc[2 * f + 1], p_hi[f], p_lo[f]);
}

// One tile's scores (keys n0 ..) become probabilities in place: scaled to
// log2 units, masked element by element only where the tile crosses the
// causal diagonal, the window's lower edge or n_valid, and exponentiated
// against the updated running max.  alpha is each row's rescale factor
// for the output accumulated so far.
__device__ __forceinline__ void online_softmax(float (&sc)[kBN / 2], const Params& p, const Rows& r,
                                               int n0, int n_valid, float scale_log2,
                                               float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) sc[e] *= scale_log2;
  const bool masked = n0 + kBN > n_valid || (p.causal && n0 + kBN - 1 > r.mw) ||
                      (p.window > 0 && n0 <= r.mw + 63 - p.window);
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = n0 + 8 * j + r.col0 + c;
          const int row = r.row0 + 8 * i;
          bool ok = key < n_valid;
          if (p.causal) ok = ok && key <= row;
          if (p.window > 0) ok = ok && key > row - p.window;
          if (!ok) sc[4 * j + 2 * i + c] = -INFINITY;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[i], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p = 0
    alpha[i] = exp2f(m_run[i] - m_use);
    m_run[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float pr = exp2f(sc[4 * j + 2 * i + c] - m_use);
        sc[4 * j + 2 * i + c] = pr;
        sum += pr;
      }
    l_run[i] = l_run[i] * alpha[i] + sum;  // this thread's part of the row sum
  }
}

// Block (blockIdx.x = h + H*b, blockIdx.y = q tile from the last): one
// consumer warpgroup of 64 q rows and one producer warp.  The consumer
// overlaps tile i's P V product with tile i+1's Q K^T product and softmax:
// a K stage is released as soon as its scores are in registers, a V stage
// when its product is done.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 2)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::kOffBar;
  const uint32_t bar_k = bar_q + 8;                   // K tile landed, + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;         // V tile landed
  const uint32_t bar_k_free = bar_v + 8 * kStages;    // consumers done with a K stage
  const uint32_t bar_v_free = bar_k_free + 8 * kStages;

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest causal tiles first
  const int kvh = h / (p.H / p.KV);
  const int n_valid = min(p.kv_len, p.T);
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + kBM);      // keys <= last q row
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1) / kBN * kBN;  // keys > first row - window
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + kBN - 1) / kBN : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_free + 8 * s, 128);
      mbar_init(bar_v_free + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: q once, then K and V of tile i into stage i % kStages as
    // soon as the consumers have released what that stage held before.
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(base + c * kBM * kRowBytes, &tq, bar_q, 64 * c, h, m0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t free_parity = (i / kStages - 1) & 1;
        const int n0 = kv_start + i * kBN;
        const uint32_t k_dst = base + C::kOffK + s * C::kTileBytes;
        const uint32_t v_dst = base + C::kOffV + s * C::kTileBytes;
        if (i >= kStages) mbar_wait(bar_k_free + 8 * s, free_parity);
        mbar_expect_tx(bar_k + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(k_dst + c * kBN * kRowBytes, &tk, bar_k + 8 * s, 64 * c, kvh, n0, b);
        if (i >= kStages) mbar_wait(bar_v_free + 8 * s, free_parity);
        mbar_expect_tx(bar_v + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(v_dst + c * kBN * kRowBytes, &tv, bar_v + 8 * s, 64 * c, kvh, n0, b);
      }
    }
    return;
  }

  // The consumer warpgroup: q rows [m0, m0 + 64).
  const Rows r{m0, m0 + 16 * warp + lane / 4, 2 * (lane % 4)};
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const uint32_t q_base = base;
  auto k_base = [&](int s) { return base + C::kOffK + s * C::kTileBytes; };
  auto v_base = [&](int s) { return base + C::kOffV + s * C::kTileBytes; };

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float sc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) sc[e] = 0.f;
  uint32_t p_hi[kBN / 4], p_lo[kBN / 4];  // the probabilities awaiting their P V product
  mbar_wait(bar_q, 0);

  if (n_tiles > 0) {  // tile 0's scores and probabilities
    float alpha[2];
    mbar_wait(bar_k, 0);
    wgmma_fence();
    issue_qk<D>(sc, q_base, k_base(0));
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar_k_free);
    online_softmax(sc, p, r, kv_start, n_valid, scale_log2, m_run, l_run, alpha);
    to_fragments(sc, p_hi, p_lo);
  }
  // Tile i's P V product runs under tile i+1's scores and softmax.  No
  // branch separates a wgmma from its wait, so ptxas keeps them asynchronous.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int s = i % kStages;
    const int s1 = (i + 1) % kStages;
    mbar_wait(bar_k + 8 * s1, ((i + 1) / kStages) & 1);
    wgmma_fence();
    issue_qk<D>(sc, q_base, k_base(s1));
    mbar_wait(bar_v + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_pv<D>(o, p_hi, p_lo, v_base(s));
    wgmma_wait<1>();  // the scores are in; the product may still run
    fence_regs(sc);
    mbar_arrive(bar_k_free + 8 * s1);
    float alpha[2];
    online_softmax(sc, p, r, kv_start + (i + 1) * kBN, n_valid, scale_log2, m_run, l_run, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(sc);
    mbar_arrive(bar_v_free + 8 * s);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        o[4 * j + 2 * ii] *= alpha[ii];
        o[4 * j + 2 * ii + 1] *= alpha[ii];
      }
    to_fragments(sc, p_hi, p_lo);
  }
  if (n_tiles > 0) {  // the last tile's product
    const int s = (n_tiles - 1) % kStages;
    mbar_wait(bar_v + 8 * s, ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<D>(o, p_hi, p_lo, v_base(s));
    wgmma_wait<0>();
    fence_regs(o);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float l = l_run[ii];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int row = r.row0 + 8 * ii;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + 8 * j + r.col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * ii] / denom, o[4 * j + 2 * ii + 1] / denom);
      // m_run is in log2 units; -inf for a row with no valid key.
      if (p.lse != nullptr && r.col0 == 0)
        p.lse[((long long)b * p.H + h) * p.S + row] = m_run[ii] * 0.6931471805599453f + logf(l);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, L, heads, D) bf16 tensor, strides in elements, as the 4-D map
// {D, heads, L, B} with box {64, 1, rows, 1} and the 128-byte swizzle.  A
// dimension of size 1 is never stepped; it gets the extent of the
// dimensions inside it as its stride, which TMA accepts whatever the
// tensor's own stride there is.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L, int heads,
              int D, long long sb, long long sl, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const long long elem_strides[3] = {sh, sl, sb};
  cuuint64_t strides[3];
  cuuint64_t extent = 2ull * D;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? extent : 2ull * (cuuint64_t)elem_strides[i];
    if (strides[i] * dims[i + 1] > extent) extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returns a cudaError_t, or kTensorMapRejected when q, k or v breaks TMA's
// layout rule (cuTensorMapEncodeTiled checks it: a 16-byte aligned base and
// 16-byte multiple strides).
template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !make_map(encode, &tk, p.k, B, p.T, p.KV, D, p.k_sb, p.k_ss, p.k_sh, kBN) ||
      !make_map(encode, &tv, p.v, B, p.T, p.KV, D, p.v_sb, p.v_ss, p.v_sh, kBN))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(p.H * B, (p.S + kBM - 1) / kBM);
  flash_fwd_kernel_sm90<D><<<grid, kBlockThreads, C::kSmemBytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// ===========================================================================
// Backward (both dtypes): dQ, dK, dV from the forward's log-sum-exp
// ===========================================================================
//
// The reference has no Pallas backward: it differentiates plain jnp
// attention.  The port's training path runs the forward kernel, so its
// gradient is a kernel too (FlashAttention-2's backward, simple form):
//   * a pre-pass writes delta = rowsum(dO * O) per (b, h, row);
//   * flash_bwd_dkdv_kernel: one block per (key tile of 64, kv head, b)
//     walks every q head of the GQA group and every q tile the mask lets
//     see the tile, recomputing P = exp(scale q.k - lse) and dS = P (dO V^T -
//     delta), and keeps dV = sum P^T dO and dK = scale sum dS^T Q in
//     registers: the group's sum needs no atomics;
//   * flash_bwd_dq_kernel: one block per (q tile of 64, head, b) walks the
//     key tiles the forward walks and keeps dQ = scale sum dS K in registers.
//     A separate dQ kernel recomputes S and dO V^T once more, and in
//     exchange nothing is accumulated across blocks (no atomics, no f32
//     scratch, the same result every run).
// The mask predicate is the forward's; tiles it leaves dead are never
// loaded.  The pre-pass is flash_bwd_delta_kernel (float32) or
// sm90::flash_bwd_delta_kernel_sm90 (bfloat16: 16-byte loads, rows strided
// over a grid of at most 16 blocks an SM).
//
// Bound on an H100 SXM: q, k, v, o, dO and the lse read once and dq, dk, dv
// written once are about 0.040 ms at olmo-1b's training shape (B=8, S=512,
// 16x128 heads, bf16, causal), the five products over the causal pairs
// 0.022 ms at the bf16 tensor-core rate: bound by bytes.  The two-kernel
// split runs seven products (S and dP once more for dQ), 0.030 ms at that
// rate, still below the byte bound.
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the scalar v1 body,
// every product a float32 FMA on the CUDA cores from padded shared-memory
// tiles, one 256-thread block per SM at D=128.  It is the 1e-4 parity path,
// as the float32 forward is, and carries no training traffic.
//
// bfloat16 (sm90::flash_bwd_dkdv_kernel_sm90, sm90::flash_bwd_dq_kernel_sm90):
// every product on the tensor cores, what the design does about the bound.
//   * dK/dV per (64-key tile, kv head, b): the K and V tiles are loaded once
//     by TMA; the Q and dO tiles of every q tile that sees the key tile, over
//     every q head of the GQA group, stream through a three-stage ring
//     filled by one producer warp (each stage carries its 64 lse, in log2
//     units, and delta values, written by the producer warp's lanes).  The
//     work is in the transposed layout (rows are keys, columns q rows) and
//     split over two consumer warpgroups that run side by side: warpgroup 0
//     computes S^T = K Q^T, P^T = exp2(S^T scale log2e - lse log2e) and dV
//     += P^T dO; warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T -
//     delta) and dK += dS^T Q.  P^T reaches warpgroup 1 through shared
//     memory in warpgroup 0's fragment layout (thread t of both warpgroups
//     holds the same elements), on a barrier per stage.  S^T and dP^T read
//     both operands K-major from shared memory; P^T and dS^T enter the last
//     products from registers (the accumulator layout is the A-fragment
//     layout), Q and dO as MN-major B operands (the transpose bit, as V in
//     the forward's P V).
//   * Why the split: ptxas gave a block of two consumer warpgroups at most
//     168 registers a thread (with a producer warp or a producer warpgroup;
//     setmaxnreg did not raise what it allocates), and spilled and
//     serialized the wgmma there.  One warpgroup holding both dK and dV (128
//     accumulator registers at D=128) alone in a block takes 247, so its
//     block runs alone on its SM and its exponentials and products follow
//     one another (0.13 ms at olmo-1b's training shape on an H100, most of
//     it that chain, not the loads).  Split, each warpgroup holds one 64 x D
//     accumulator (136 registers) and the two chains overlap (0.10 ms).
//     Issuing the next tile's S^T with this tile's last product, as the
//     forward does, made it slower (0.11 ms).
//   * dQ per (64-row q tile, head, b), two blocks to an SM (162 registers):
//     Q and dO are loaded once, K and V stream through a two-stage ring over
//     the key tiles the forward walks: S = Q K^T, dP = dO V^T, dS in
//     registers, dQ += dS K (K as an MN-major B).  dQ in its own kernel costs S and dP
//     once more, and in exchange nothing is summed across blocks: no
//     atomics, the same bits every run.
//   * P and dS enter the tensor cores as one bf16 term each, and dS is
//     formed from the rounded P.  The gradients are held to 2e-2 x max(1,
//     max|plain|), and the emulation in tests/test_torch_flash_bwd_rounding.py
//     puts this rounding at a fifth of that at olmo-1b's head shape; the
//     forward needs P in two terms only for its 1e-2 absolute tolerance.
//   * Tiles are masked element by element only where they cross the
//     diagonal, the window's edge, kv_len or S; dead tiles are never loaded.
//     Blocks are launched longest causal chain first; log2(e) is folded into
//     the scale and the lse, and exponentials are ex2.approx.
//   What it does not do yet: split a GQA group over blocks (hymba-1.5b's
//   dK/dV grid is 80 blocks for 132 SMs), run persistent blocks that load
//   the next tile's K/V under the current one, or store through TMA.

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S), from the forward
  float* delta;      // (B, H, S), written by the pre-pass
  void* dq;
  void* dk;
  void* dv;
  int S, T, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int causal;
  int window;
  int kv_len;
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow_to(float* dst, float x) { *dst = x; }

// One warp per (b, row, h): delta = sum_d dO * O, in float32.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(BwdParams p, int B) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * p.S * p.H) return;
  const int h = row % p.H;
  const int m = (row / p.H) % p.S;
  const int b = row / ((long long)p.H * p.S);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + m * p.o_ss + h * p.o_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + m * p.do_ss + h * p.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(widen(g[d]), widen(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((long long)b * p.H + h) * p.S + m] = acc;
}

// Shared memory of both backward kernels: four 64 x D float32 tiles at a
// padded pitch, the 64 x 64 P / dS tile, and the q tile's lse and delta.
template <int D>
struct BwdTile {
  static constexpr int kPitch = D + 1;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (4 * kBlockM * kPitch + kBlockM * kPPitch + 2 * kBlockM);
};

// Rows [m0, m0+64) and cols [0, D) of a (L, heads, D) slice into a float32
// tile; rows past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int m0,
                                      int rows) {
  constexpr int kPitch = D + 1;
  for (int idx = threadIdx.x; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int m = m0 + r;
    dst[r * kPitch + c] = m < rows ? widen(src[m * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(const BwdParams& p, int n_valid, int m, int n) {
  bool ok = m < p.S && n < n_valid;
  if (p.causal) ok = ok && n <= m;
  if (p.window > 0) ok = ok && n > m - p.window;
  return ok;
}

// Thread (tx, ty) of the 16 x 16 grid: the scores of q rows ty + 16 i and
// keys tx + 16 j (i, j < 4) become P (returned in s) and dS (in dp).
template <int D>
__device__ __forceinline__ void scores_and_ds(const BwdParams& p, const float* qs, const float* dos,
                                              const float* ks, const float* vs, const float* lse_s,
                                              const float* delta_s, int m0, int n0, int n_valid,
                                              float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int kPitch = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * kPitch + d];
      g[i] = dos[(ty + 16 * i) * kPitch + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = ks[(tx + 16 * j) * kPitch + d];
      bv[j] = vs[(tx + 16 * j) * kPitch + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i;
      const bool ok = visible(p, n_valid, m0 + r, n0 + tx + 16 * j);
      const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
      s[i][j] = pr;
      dp[i][j] = pr * (dp[i][j] - delta_s[r]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(BwdParams p) {
  constexpr int kPitch = D + 1;
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockN * kPitch;
  float* qs = vs + kBlockN * kPitch;
  float* dos = qs + kBlockM * kPitch;
  float* ps = dos + kBlockM * kPitch;  // (kBlockM, kPPitch): P, then dS
  float* lse_s = ps + kBlockM * kPPitch;
  float* delta_s = lse_s + kBlockM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kBlockN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.KV;
  const int n_valid = min(p.kv_len, p.T);

  stage<T, D>(ks, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, n0, p.T);
  stage<T, D>(vs, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, n0, p.T);

  float dk[4][kOut], dv[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) dk[i][j] = dv[i][j] = 0.f;

  // The q rows that see a key of this tile.
  int m_begin = 0, m_end = n0 < n_valid ? p.S : 0;
  if (p.causal) m_begin = n0;                                            // rows >= first key
  if (p.window > 0) m_end = min(m_end, n0 + kBlockN - 1 + p.window);    // rows < last key + window
  m_begin = (m_begin / kBlockM) * kBlockM;

  for (int hq = kvh * group; hq < (kvh + 1) * group; ++hq) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const T* g = static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    const long long stat = ((long long)b * p.H + hq) * p.S;
    for (int m0 = m_begin; m0 < m_end; m0 += kBlockM) {
      __syncthreads();  // the previous q tile's reads are done
      stage<T, D>(qs, q, p.q_ss, m0, p.S);
      stage<T, D>(dos, g, p.do_ss, m0, p.S);
      if (threadIdx.x < kBlockM) {
        const int m = m0 + threadIdx.x;
        lse_s[threadIdx.x] = m < p.S ? p.lse[stat + m] : 0.f;
        delta_s[threadIdx.x] = m < p.S ? p.delta[stat + m] : 0.f;
      }
      __syncthreads();
      float s[4][4], ds[4][4];
      scores_and_ds<D>(p, qs, dos, ks, vs, lse_s, delta_s, m0, n0, n_valid, s, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dV[n][d] += sum_m P[m][n] dO[m][d]: this thread's keys ty + 16 i, dims tx + 16 j.
#pragma unroll 4
      for (int m = 0; m < kBlockM; ++m) {
        float pv[4], gv[kOut];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[m * kPPitch + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kOut; ++j) gv[j] = dos[m * kPitch + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kOut; ++j) dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = ds[i][j];
      __syncthreads();
      // dK[n][d] += sum_m dS[m][n] Q[m][d] (times scale at the store).
#pragma unroll 4
      for (int m = 0; m < kBlockM; ++m) {
        float dsv[4], qv[kOut];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = ps[m * kPPitch + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kOut; ++j) qv[j] = qs[m * kPitch + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kOut; ++j) dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= p.T) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      narrow_to(dkp + n * p.dk_ss + tx + 16 * j, dk[i][j] * p.scale);
      narrow_to(dvp + n * p.dv_ss + tx + 16 * j, dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int kPitch = D + 1;
  constexpr int kOut = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockN * kPitch;
  float* qs = vs + kBlockN * kPitch;
  float* dos = qs + kBlockM * kPitch;
  float* ps = dos + kBlockM * kPitch;  // (kBlockM, kPPitch): dS
  float* lse_s = ps + kBlockM * kPPitch;
  float* delta_s = lse_s + kBlockM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int n_valid = min(p.kv_len, p.T);

  stage<T, D>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.S);
  stage<T, D>(dos, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh, p.do_ss, m0, p.S);
  if (threadIdx.x < kBlockM) {
    const long long stat = ((long long)b * p.H + h) * p.S;
    const int m = m0 + threadIdx.x;
    lse_s[threadIdx.x] = m < p.S ? p.lse[stat + m] : 0.f;
    delta_s[threadIdx.x] = m < p.S ? p.delta[stat + m] : 0.f;
  }

  // The key tiles the forward walks for this q tile.
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + kBlockM);
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1);
  kv_start = (kv_start / kBlockN) * kBlockN;

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float dq[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) dq[i][j] = 0.f;

  for (int n0 = kv_start; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile's reads are done
    stage<T, D>(ks, k, p.k_ss, n0, p.T);
    stage<T, D>(vs, v, p.v_ss, n0, p.T);
    __syncthreads();
    float s[4][4], ds[4][4];
    scores_and_ds<D>(p, qs, dos, ks, vs, lse_s, delta_s, m0, n0, n_valid, s, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[m][d] += sum_n dS[m][n] K[n][d]: this thread's rows ty + 16 i, dims tx + 16 j.
#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float dsv[4], kv[kOut];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ps[(ty + 16 * i) * kPPitch + n];
#pragma unroll
      for (int j = 0; j < kOut; ++j) kv[j] = ks[n * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.S) continue;
#pragma unroll
    for (int j = 0; j < kOut; ++j) narrow_to(dqp + m * p.dq_ss + tx + 16 * j, dq[i][j] * p.scale);
  }
}

namespace sm90 {

constexpr int kDkdvStages = 3;  // Q/dO tile pairs in flight (dK/dV)
constexpr int kDqStages = 2;    // K/V tile pairs in flight (dQ)
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV: two consumer warpgroups (warps 0-7) and one producer warp.  Shared
// memory (1024-byte aligned base):
//   K, V      the block's 64 keys, D/64 swizzled chunks x 64 rows x 128 B each
//   ring      kDkdvStages x (Q tile, dO tile) of 64 q rows
//   P         kDkdvStages x P^T as warpgroup 0's bf16 fragments, 16 x 128 words
//   stats     kDkdvStages x (64 lse in log2 units, 64 delta)
//   barriers  K/V, full[stage], free[stage], P ready[stage]
template <int D>
struct DkdvCfg {
  static constexpr int kThreads = 288;
  static constexpr int kProducerWarp = 8;
  static constexpr uint32_t kTile = 64 * D * 2;
  static constexpr uint32_t kOffRing = 2 * kTile;
  static constexpr uint32_t kStageBytes = 2 * kTile;
  static constexpr uint32_t kOffP = kOffRing + kDkdvStages * kStageBytes;
  static constexpr uint32_t kOffStats = kOffP + kDkdvStages * 16 * 128 * 4;
  static constexpr uint32_t kOffBar = kOffStats + kDkdvStages * 2 * 64 * sizeof(float);
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 3 * kDkdvStages) + 1024;
  static_assert(D % 64 == 0, "tiles are whole swizzle chunks");
  static_assert(kSmemBytes <= 232448, "one block must fit an SM's shared memory");
};

// dQ: one consumer warpgroup (warps 0-3) and one producer warp, two blocks
// to an SM.  Shared memory: Q and dO of the block's 64 rows, then
// kDqStages x (K tile, V tile), then barriers Q/dO, full[stage], free[stage].
template <int D>
struct DqCfg {
  static constexpr int kThreads = 160;
  static constexpr int kProducerWarp = 4;
  static constexpr uint32_t kTile = 64 * D * 2;
  static constexpr uint32_t kOffRing = 2 * kTile;
  static constexpr uint32_t kStageBytes = 2 * kTile;
  static constexpr uint32_t kOffBar = kOffRing + kDqStages * kStageBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * kDqStages) + 1024;
  static_assert(2 * kSmemBytes <= 232448, "two blocks must fit an SM's shared memory");
};

// 2^x on the special-function unit; -inf gives 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An m64n64 accumulator as the A fragments of the next wgmma, one bf16
// term: consecutive pairs, as to_fragments packs them.
__device__ __forceinline__ void to_bf16_fragments(const float (&x)[32], uint32_t (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = bf16x2_bits(__floats2bfloat162_rn(x[2 * i], x[2 * i + 1]));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t bits) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
}

// d (64 x D) += A (64 x 64, registers, one bf16 term) B (64 x D, smem,
// MN-major: a 64-row tile read along its rows), issued and committed, not
// waited.  A's columns 16*kk .. 16*kk + 15 are fragments [4*kk, 4*kk + 4).
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[16],
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_rs_tb<D>(d, f, desc_sw128(b_base + kk * 16 * kRowBytes, 64 * kRowBytes, 1024));
  }
  wgmma_commit();
}

// Some (q row, key) pair of the 64 x 64 tile at (m0, n0) is masked.
__device__ __forceinline__ bool crosses_edge(const BwdParams& p, int n_valid, int m0, int n0) {
  return n0 + 64 > n_valid || m0 + 64 > p.S || (p.causal && n0 + 63 > m0) ||
         (p.window > 0 && n0 <= m0 + 63 - p.window);
}

// Block (blockIdx.x = kv head + KV*b, blockIdx.y = 64-key tile, the
// longest causal chain first): two consumer warpgroups share the block's 64
// keys and split each q tile's work.  Warpgroup 0 computes S^T = K Q^T and
// P^T, hands P^T to warpgroup 1 through shared memory (its own fragment
// layout, one barrier per stage) and accumulates dV += P^T dO; warpgroup 1
// computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and accumulates dK +=
// dS^T Q.  Each holds one 64 x D accumulator, so both fit 168 registers.
// The producer warp comes last.
template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::kThreads, 1)
    flash_bwd_dkdv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
  using C = DkdvCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* aligned = smem_raw + (base - smem_u32(smem_raw));
  float* stats = reinterpret_cast<float*>(aligned + C::kOffStats);
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(aligned + C::kOffP);
  const uint32_t bar_kv = base + C::kOffBar;
  const uint32_t bar_full = bar_kv + 8;                    // + 8 * stage
  const uint32_t bar_free = bar_full + 8 * kDkdvStages;
  const uint32_t bar_p = bar_free + 8 * kDkdvStages;       // P^T of the stage is in pbuf

  const int kvh = blockIdx.x % p.KV;
  const int b = blockIdx.x / p.KV;
  const int n0 = blockIdx.y * 64;
  const int group = p.H / p.KV;
  const int n_valid = min(p.kv_len, p.T);
  // The q tiles that see a key of this block: rows >= its first key
  // (causal), rows < its last key + window.
  int m_begin = 0, m_end = n0 < n_valid ? p.S : 0;
  if (p.causal) m_begin = n0;
  if (p.window > 0) m_end = min(m_end, n0 + 63 + p.window);
  const int q_tiles = m_end > m_begin ? (m_end - m_begin + 63) / 64 : 0;
  const int n_iters = group * q_tiles;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);                     // the producer warp's lanes
      mbar_init(bar_free + 8 * s, 256);                    // both warpgroups
      mbar_init(bar_p + 8 * s, 128);                       // warpgroup 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kProducerWarp) {
    // Producer: K and V once, then Q, dO, lse and delta of iteration i
    // into stage i % kDkdvStages.
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * C::kTile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + c * 64 * kRowBytes, &tk, bar_kv, 64 * c, kvh, n0, b);
        tma_load_4d(base + C::kTile + c * 64 * kRowBytes, &tv, bar_kv, 64 * c, kvh, n0, b);
      }
    }
    for (int i = 0; i < n_iters; ++i) {
      const int s = i % kDkdvStages;
      const int hq = kvh * group + i / q_tiles;
      const int m0 = m_begin + (i % q_tiles) * 64;
      if (i >= kDkdvStages) mbar_wait(bar_free + 8 * s, (i / kDkdvStages - 1) & 1);
      const long long stat = ((long long)b * p.H + hq) * p.S;
      float* st = stats + s * 128;
      for (int r = lane; r < 64; r += 32) {
        const int m = m0 + r;
        st[r] = m < p.S ? p.lse[stat + m] * kLog2e : 0.f;
        st[64 + r] = m < p.S ? p.delta[stat + m] : 0.f;
      }
      if (lane == 0) {
        const uint32_t dst = base + C::kOffRing + s * C::kStageBytes;
        mbar_expect_tx(bar_full + 8 * s, C::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(dst + c * 64 * kRowBytes, &tq, bar_full + 8 * s, 64 * c, hq, m0, b);
          tma_load_4d(dst + C::kTile + c * 64 * kRowBytes, &tdo, bar_full + 8 * s, 64 * c, hq,
                      m0, b);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int key0 = n0 + 16 * (warp % 4) + lane / 4;        // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * kLog2e;
  // Every q tile the block walks sees one of its keys (m_begin and m_end
  // are the diagonal's and the window's edges).
  float acc[D / 2];                                        // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float x[32];                                             // S^T (0) or dP^T (1)
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.f;
  uint32_t frag[16];                                       // P^T (0) or dS^T (1), bf16
  mbar_wait(bar_kv, 0);

  for (int i = 0; i < n_iters; ++i) {
    const int s = i % kDkdvStages;
    const int m0 = m_begin + (i % q_tiles) * 64;
    const uint32_t q_base = base + C::kOffRing + s * C::kStageBytes;  // dO at + kTile
    uint32_t* pslot = pbuf + s * 16 * 128 + t;             // fragment f at pslot[128 f]
    const bool masked = crosses_edge(p, n_valid, m0, n0);
    mbar_wait(bar_full + 8 * s, (i / kDkdvStages) & 1);
    wgmma_fence();
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): operands are picked by
    // warpgroup, so no branch separates a wgmma from its wait.
    issue_qk<D>(x, base + wg * C::kTile, q_base + wg * C::kTile);
    wgmma_wait<0>();
    fence_regs(x);
    if (wg == 0) {
      // P^T: rows are keys key0 + 8r, columns q rows m0 + 8j + col0 + c.
      const float* lse2 = stats + s * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float pr = ex2_approx(fmaf(x[e], scale_log2, -(c ? l.y : l.x)));
            if (masked && !visible(p, n_valid, m0 + 8 * j + col0 + c, key0 + 8 * r)) pr = 0.f;
            x[e] = pr;
          }
      }
      to_bf16_fragments(x, frag);
#pragma unroll
      for (int f = 0; f < 16; ++f) pslot[128 * f] = frag[f];
      mbar_arrive(bar_p + 8 * s);
    } else {
      // dS^T = P^T (dP^T - delta), from warpgroup 0's rounded P^T.
      const float* delta = stats + s * 128 + 64;
      mbar_wait(bar_p + 8 * s, (i / kDkdvStages) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pp = bf16x2_to_float2(pslot[128 * (2 * j + r)]);
          x[4 * j + 2 * r] = pp.x * (x[4 * j + 2 * r] - dl.x);
          x[4 * j + 2 * r + 1] = pp.y * (x[4 * j + 2 * r + 1] - dl.y);
        }
      }
      to_bf16_fragments(x, frag);
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1).
    wgmma_fence();
    issue_rs<D>(acc, frag, q_base + (1 - wg) * C::kTile);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(bar_free + 8 * s);
  }

  // Warpgroup 0 stores dV, warpgroup 1 dK (scaled).
  const float out_scale = wg == 0 ? 1.f : p.scale;
  __nv_bfloat16* dst = wg == 0
      ? static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh
      : static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  const long long row_stride = wg == 0 ? p.dv_ss : p.dk_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = key0 + 8 * r;
    if (n >= p.T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dst + n * row_stride + 8 * j + col0) =
          __floats2bfloat162_rn(acc[e] * out_scale, acc[e + 1] * out_scale);
    }
  }
}

// Block (blockIdx.x = h + H*b, blockIdx.y = 64-row q tile from the last):
// one consumer warpgroup owns the rows, the producer warp comes last.
template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 2)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
  using C = DqCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::kOffBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_free = bar_full + 8 * kDqStages;

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int kvh = h / (p.H / p.KV);
  const int n_valid = min(p.kv_len, p.T);
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + 64);             // keys <= last q row
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1) / 64 * 64;  // keys > first row - window
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + 63) / 64 : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kProducerWarp) {
    // Producer: Q and dO once, then K and V of key tile i into stage
    // i % kDqStages.
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * C::kTile);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + c * 64 * kRowBytes, &tq, bar_q, 64 * c, h, m0, b);
        tma_load_4d(base + C::kTile + c * 64 * kRowBytes, &tdo, bar_q, 64 * c, h, m0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDqStages;
        const int n0 = kv_start + i * 64;
        const uint32_t dst = base + C::kOffRing + s * C::kStageBytes;
        if (i >= kDqStages) mbar_wait(bar_free + 8 * s, (i / kDqStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, C::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(dst + c * 64 * kRowBytes, &tk, bar_full + 8 * s, 64 * c, kvh, n0, b);
          tma_load_4d(dst + C::kTile + c * 64 * kRowBytes, &tv, bar_full + 8 * s, 64 * c, kvh,
                      n0, b);
        }
      }
    }
    return;
  }

  const int row0 = m0 + 16 * warp + lane / 4;              // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * kLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + 8 * r;
    const long long stat = ((long long)b * p.H + h) * p.S + m;
    lse2[r] = m < p.S ? p.lse[stat] * kLog2e : 0.f;
    delta[r] = m < p.S ? p.delta[stat] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
  uint32_t dsf[16];
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kDqStages;
    const int n0 = kv_start + i * 64;
    const uint32_t k_stage = base + C::kOffRing + s * C::kStageBytes;
    mbar_wait(bar_full + 8 * s, (i / kDqStages) & 1);
    wgmma_fence();
    issue_qk<D>(sc, base, k_stage);                        // S = Q K^T
    issue_qk<D>(dp, base + C::kTile, k_stage + C::kTile);  // dP = dO V^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // dS = P (dP - delta), P rounded to bf16 as the dK/dV kernel rounds it:
    // rows are q rows row0 + 8r, columns keys n0 + 8j + col0 + c.
    const bool masked = crosses_edge(p, n_valid, m0, n0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c;
          float pr = ex2_approx(fmaf(sc[e], scale_log2, -lse2[r]));
          if (masked && !visible(p, n_valid, row0 + 8 * r, n0 + 8 * j + col0 + c)) pr = 0.f;
          pr = __bfloat162float(__float2bfloat16_rn(pr));
          dp[e] = pr * (dp[e] - delta[r]);
        }
    to_bf16_fragments(dp, dsf);
    wgmma_fence();
    issue_rs<D>(dq, dsf, k_stage);                         // dQ += dS K
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(bar_free + 8 * s);
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + 8 * r;
    if (m >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqp + m * p.dq_ss + 8 * j + col0) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
  }
}

// delta = rowsum(dO * O) in float32 for each (b, row, h): D/8 lanes per
// row, each reading 8 adjacent elements of both with one 16-byte load (the
// rows are 16-byte aligned: TMA's rule holds for dO and, as the wrapper
// sees to, for O); the grid strides over the rows.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel_sm90(BwdParams p, long long rows) {
  constexpr int kLanes = D / 8;
  const int lane = threadIdx.x % 32;
  const int sub = lane % kLanes;
  const long long stride = (long long)gridDim.x * (256 / kLanes);
  // first: the warp's first row, the same for its lanes, so the shuffles
  // below run with every lane.
  for (long long first = ((long long)blockIdx.x * 256 + threadIdx.x - lane) / kLanes; first < rows;
       first += stride) {
    const long long row = first + lane / kLanes;
    const int h = row % p.H;
    const int m = (row / p.H) % p.S;
    const int b = row / ((long long)p.H * p.S);
    float acc = 0.f;
    if (row < rows) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + m * p.o_ss + h * p.o_sh + 8 * sub);
      const uint4 gv = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) +
                                                       b * p.do_sb + m * p.do_ss + h * p.do_sh +
                                                       8 * sub);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = bf16x2_to_float2(ow[w]), g = bf16x2_to_float2(gw[w]);
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0 && row < rows) p.delta[((long long)b * p.H + h) * p.S + m] = acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The delta pre-pass, then the dK/dV and dQ kernels.  Returns a
// cudaError_t, or kTensorMapRejected when q, k, v or dO breaks TMA's rule.
template <int D>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(encode, &tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !make_map(encode, &tk, p.k, B, p.T, p.KV, D, p.k_sb, p.k_ss, p.k_sh, 64) ||
      !make_map(encode, &tv, p.v, B, p.T, p.KV, D, p.v_sb, p.v_ss, p.v_sh, 64) ||
      !make_map(encode, &tdo, p.dout, B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, 64))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(flash_bwd_dkdv_kernel_sm90<D>, DkdvCfg<D>::kSmemBytes);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel_sm90<D>, DqCfg<D>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)B * p.S * p.H;
  const long long blocks = (rows * (D / 8) + 255) / 256;  // at most 16 to an SM, striding
  flash_bwd_delta_kernel_sm90<D><<<(unsigned)(blocks < 2112 ? blocks : 2112), 256, 0, stream>>>(
      p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv(p.KV * B, (p.T + 63) / 64);
  flash_bwd_dkdv_kernel_sm90<D><<<grid_kv, DkdvCfg<D>::kThreads, DkdvCfg<D>::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q(p.H * B, (p.S + 63) / 64);
  flash_bwd_dq_kernel_sm90<D><<<grid_q, DqCfg<D>::kThreads, DqCfg<D>::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90

template <typename T, int D>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = BwdTile<D>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)B * p.S * p.H;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((p.T + kBlockN - 1) / kBlockN, p.KV, B);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((p.S + kBlockM - 1) / kBlockM, p.H, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The entry point's arguments in one block, packed by ops.py as
// struct.Struct("=5Q12qQ10ifi"): no padding, 192 bytes.  One pointer
// argument keeps the host's cost of a ctypes call small.
//   dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); D = 64 or
//   128.  Strides are in elements, (batch, sequence, head) for q, k, v and
//   o in that order; the head dim is contiguous.  bfloat16 takes q/k/v at
//   16-byte aligned addresses with 16-byte multiple strides (TMA's rule).
//   lse: a (B, H, S) float32 buffer for each row's log-sum-exp, or null
//   (serving passes null and nothing extra is written).
struct EntryArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long strides[12];
  void* stream;
  int dtype, B, S, T, H, KV, D, causal, window, kv_len;
  float scale;
  int pad;
};
static_assert(sizeof(EntryArgs) == 192, "EntryArgs must match ops.py's packing");

// Returns a cudaError_t, or kTensorMapRejected (-1) when a bfloat16 q, k or
// v breaks TMA's rule; nothing is launched then.
int flash_attention_forward(const EntryArgs* a) {
  const int B = a->B, D = a->D;
  if ((D != 64 && D != 128) || a->KV <= 0 || a->H % a->KV != 0 || B <= 0 || a->S <= 0 ||
      a->T <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* st = a->strides;
  Params p{a->q, a->k, a->v, a->o, a->S, a->T, a->H, a->KV,
           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
           a->causal, a->window, a->kv_len, a->scale, a->lse};
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  if (a->dtype == 0) return (int)(D == 64 ? launch_f32<64>(p, B, s) : launch_f32<128>(p, B, s));
  if (a->dtype == 1) return D == 64 ? sm90::launch<64>(p, B, s) : sm90::launch<128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's arguments, packed by ops.py as struct.Struct("=10Q24qQ10ifi"):
// 328 bytes.  Pointers q, k, v, o, dO (the forward's inputs and output and
// the output's gradient), lse (from the forward), delta (a (B, H, S) float32
// scratch), dq, dk, dv (outputs in q's dtype); strides in elements,
// (batch, sequence, head) for q, k, v, o, dO, dq, dk, dv in that order.
struct BwdEntryArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long strides[24];
  void* stream;
  int dtype, B, S, T, H, KV, D, causal, window, kv_len;
  float scale;
  int pad;
};
static_assert(sizeof(BwdEntryArgs) == 328, "BwdEntryArgs must match ops.py's packing");

// Launches the delta pre-pass, the dK/dV kernel and the dQ kernel on the
// stream; returns the first cudaError_t that is not cudaSuccess, or
// kTensorMapRejected (-1) when a bfloat16 q, k, v or dO breaks TMA's rule
// (bfloat16 takes them at 16-byte aligned addresses with 16-byte multiple
// strides); nothing is launched then.
int flash_attention_backward(const BwdEntryArgs* a) {
  const int B = a->B, D = a->D;
  if ((D != 64 && D != 128) || a->KV <= 0 || a->H % a->KV != 0 || B <= 0 || a->S <= 0 ||
      a->T <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* st = a->strides;
  BwdParams p{a->q, a->k, a->v, a->o, a->dout, a->lse, a->delta, a->dq, a->dk, a->dv,
              a->S, a->T, a->H, a->KV,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
              st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20], st[21],
              st[22], st[23], a->causal, a->window, a->kv_len, a->scale};
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  if (a->dtype == 0)
    return D == 64 ? launch_bwd<float, 64>(p, B, s) : launch_bwd<float, 128>(p, B, s);
  if (a->dtype == 1) return D == 64 ? sm90::launch_bwd<64>(p, B, s) : sm90::launch_bwd<128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
