// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
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

}  // namespace

extern "C" {

// The entry point's arguments in one block, packed by ops.py as
// struct.Struct("=4Q12qQ10ifi"): no padding, 184 bytes.  One pointer
// argument keeps the host's cost of a ctypes call small.
//   dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); D = 64 or
//   128.  Strides are in elements, (batch, sequence, head) for q, k, v and
//   o in that order; the head dim is contiguous.  bfloat16 takes q/k/v at
//   16-byte aligned addresses with 16-byte multiple strides (TMA's rule).
struct EntryArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long strides[12];
  void* stream;
  int dtype, B, S, T, H, KV, D, causal, window, kv_len;
  float scale;
  int unused;
};
static_assert(sizeof(EntryArgs) == 184, "EntryArgs must match ops.py's packing");

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
           a->causal, a->window, a->kv_len, a->scale};
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  if (a->dtype == 0) return (int)(D == 64 ? launch_f32<64>(p, B, s) : launch_f32<128>(p, B, s));
  if (a->dtype == 1) return D == 64 ? sm90::launch<64>(p, B, s) : sm90::launch<128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
