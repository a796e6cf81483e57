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
// float32 at every head dim, and bfloat16 at the reduced configs' (16, 16),
// (32, 32) and (48, 32), tc::flash_fwd_kernel_mma: mma.sync on cp.async
// tiles.  The bf16 instances serve the reduced bf16 configs (llama3-8b's
// and whisper's (32, 32): the examples' quickstart and batched serving;
// hymba's (16, 16), 5 q heads over 1 KV head; deepseek's MLA at (48, 32)),
// whose rows are narrower than one 128-byte swizzle row, which the wgmma
// kernel's TMA tiles are built from; the float32 ones are the parity path
// (held at 1e-5) and the CLI's default run (reduced olmo-1b at (32, 32)).
//   * Both products run on the tensor cores with mma.sync: bf16 m16n8k16,
//     and for float32 3xTF32 m16n8k8 (each operand split into TF32 hi and
//     lo, lo.hi + hi.lo + hi.hi in float32, about 22 bits of each product:
//     one TF32 term keeps 11 and misses the 1e-5 check, which
//     tests/test_torch_flash_tf32_split.py shows on the CPU).  At 165
//     TFLOP/s for 3xTF32 against 67 for float32 FMAs, and with fragments
//     loaded once per 8 x 8 product instead of 8 values per 16 FMAs, the
//     products stop being bound by shared-memory loads.
//   * Warps own 16-row strips of a 32-row q tile (reduced configs run
//     S = 32: no half-empty 64-row tiles), over K/V tiles of 32 keys (16
//     in float32 at Dqk + Dv >= 256).  A block runs G warp pairs side by
//     side on one q tile (float32: 4; bf16: 1), pair j taking every G-th
//     K/V tile; the pairs' (output, max, sum) merge in a fixed order at
//     the end.  At S = 300 a float32 call has about one block an SM, and
//     one pair of warps alone there left the products' latencies bare: one
//     pair a block ran the (192, 128) forward in 0.0787 ms and the (128,
//     128) backward in 0.2275, two pairs in 0.0445 and 0.1342 (PERF.md
//     section 6).
//     The online softmax runs on the accumulators in registers
//     (row max and sum over the four lanes that share a row), and P stays
//     in registers as the A operand of P V: in two bf16 terms (as the wgmma
//     forward, for the 1e-2 check), re-split into TF32 hi and lo in float32.
//   * K and V arrive through two stages of 16-byte cp.async copies: tile
//     i + 1 loads while tile i computes.  Rows past S and T are zero-filled.
//   * Dead tiles are skipped as in the wgmma kernel, and a tile is masked
//     element by element only where it crosses the diagonal, the window's
//     edge or kv_len.  Blocks run longest causal tile first.
//   * Shared-memory pitches (row width + 4 words in float32, + 8 elements
//     in bf16) make every fragment load conflict-free; at (192, 128)
//     float32 a block (four pairs, 16-key tiles) takes 189 KB.
//   What it does not do yet: split the K tile into TF32 terms once per
//   block (each warp splits what it reads), or use ldmatrix for float32.
//
// Head dims.  Every kernel is a template on (DQK, DV): q and k share DQK, v
// and the output have DV, as in repro/models/common.py::full_attention.
// DeepSeek-V2's MLA attends at (192, 128): q and k are a 128-dim part from
// the latent and a 64-dim RoPE part, v is 128 wide, and the scale is
// 1/sqrt(192).  The instances (the C entries' forward_instance and
// backward_instance): bf16 and float16 at (64, 64), (128, 128), (192, 128)
// on wgmma and at (16, 16), (32, 32), (48, 32), (256, 256) on mma.sync;
// float32 at all seven on mma.sync.  ops.py runs any other pair up to 256
// on the smallest instance that holds it, padded by zero channels.
// float16 is bfloat16's code with the .f16 operand type (m16n8k16 and
// wgmma alike), P in two float16 terms as in two bf16 ones
// (tests/test_torch_flash_p_rounding.py).  (256, 256) on mma.sync is the
// simple instance, not the fast one: its dK/dV kernel spills at the
// 255-register cap (ptxas, in chip_smoke.py phase 2).  At (192, 128)
// the bf16 forward's Q K^T runs over three 64-column swizzle chunks (12
// k16 steps), its P V at N = 128; q, the K ring and the V ring take 24 +
// 48 + 32 KB, so two blocks still share an SM, and the accumulators are
// those of D = 128.  The backward's choices at (192, 128) are noted at
// DkdvCfg and DqCfg.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The element types this library holds: FLASH_ELEM = 0 (float32), 1
// (bfloat16) or 2 (float16) builds one (ops.py builds one library per
// element type, side by side); left undefined, all three.
#ifndef FLASH_ELEM
#define FLASH_ELEM -1
#endif
#define FLASH_HAS(code) (FLASH_ELEM < 0 || FLASH_ELEM == (code))

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

// Helpers of both kernel families.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

__device__ __forceinline__ uint32_t half2_bits(__half2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 16-bit element types (bfloat16 and float16) behind one interface:
// two floats packed low element first (one term, or hi + lo), a packed
// pair widened, a float rounded to the type and back.  The bfloat16
// helpers are the expressions the bf16 kernels were written with.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  if constexpr (std::is_same<T, __half>::value) return half2_bits(__floats2half2_rn(x0, x1));
  else return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(x0, x1);
    hi = half2_bits(h);
    lo = half2_bits(__floats2half2_rn(x0 - __low2float(h), x1 - __high2float(h)));
  } else {
    split_bf16x2(x0, x1, hi, lo);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t bits) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&bits));
  else return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
}

template <typename T>
__device__ __forceinline__ float round16(float x) {
  if constexpr (std::is_same<T, __half>::value) return __half2float(__float2half_rn(x));
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats as T's packed pair, rounded to nearest; the 16-bit kernels
// store it as `*reinterpret_cast<Pair<T>*>(dst) = pair2<T>(x0, x1)`, which
// computes the pair before its address, as their bf16 code always did.
template <typename T>
using Pair = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;

template <typename T>
__device__ __forceinline__ Pair<T> pair2(float x0, float x1) {
  if constexpr (std::is_same<T, __half>::value) return __floats2half2_rn(x0, x1);
  else return __floats2bfloat162_rn(x0, x1);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ===========================================================================
// float32 at every head dim, bfloat16 at (16, 16), (32, 32), (48, 32):
// mma.sync on cp.async tiles
// ===========================================================================

namespace tc {

constexpr int kPair = 64;  // threads of a warp pair, which owns a tile's 32 rows (16 each)
constexpr int kRows = 32;  // q rows of a forward or dQ block, keys of a dK/dV block

// 16 bytes from global to shared memory; !valid zero-fills and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of one warp's mma.sync (g = lane / 4, qd = lane % 4).  Tiles
// in shared memory are [row][column] at a pitch of the row's width plus
// kPad elements.  Every product accumulates a 16 x 8 float32 block c[4]:
// (g, 2qd), (g, 2qd + 1), (g + 8, 2qd), (g + 8, 2qd + 1).
//   a_rows   A[m][k] = t[r0 + m][k0 + k]            (q, dO, K, V as A)
//   b_rows   B[k][n] = t[n0 + n][k0 + k]            (K, V, q, dO as B of S-like products)
//   b_cols   B[k][n] = t[k0 + k'][n0 + n]           (V, K, dO, q as B of P-like products)
//   a_acc    A from the accumulators of the previous product (P, dS)
//   mma      d += A B
// The k' of b_cols is the order a_acc reads the accumulators in (below).
template <typename T>
struct Ops;

// float32: m16n8k8 TF32 three times, each operand split into TF32 hi and
// lo, lo.hi + hi.lo + hi.hi (the small terms first) into a float32
// accumulator: about 22 bits of each product, where one TF32 term keeps 11.
// With a pitch of the width plus 4 words (the widths are multiples of 16)
// every fragment load below hits 32 distinct banks.  An accumulator block
// holds keys 2qd and 2qd + 1 where the A fragment wants qd and qd + 4, so
// a_acc reads its columns in the order 0, 2, 4, 6, 1, 3, 5, 7 and b_cols
// reads the rows of B in the same order: the sum over k is unchanged.
template <>
struct Ops<float> {
  static constexpr int kK = 8;
  static constexpr int kPad = 4;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ A split_a(float x0, float x1, float x2, float x3) {
    A f;
    split_tf32(x0, f.hi[0], f.lo[0]);
    split_tf32(x1, f.hi[1], f.lo[1]);
    split_tf32(x2, f.hi[2], f.lo[2]);
    split_tf32(x3, f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ B split_b(float x0, float x1) {
    B f;
    split_tf32(x0, f.hi[0], f.lo[0]);
    split_tf32(x1, f.hi[1], f.lo[1]);
    return f;
  }
  static __device__ __forceinline__ A a_rows(const float* t, int pitch, int r0, int k0, int g,
                                             int qd) {
    const float* p = t + (r0 + g) * pitch + k0 + qd;
    return split_a(p[0], p[8 * pitch], p[4], p[8 * pitch + 4]);
  }
  static __device__ __forceinline__ B b_rows(const float* t, int pitch, int n0, int k0, int g,
                                             int qd) {
    const float* p = t + (n0 + g) * pitch + k0 + qd;
    return split_b(p[0], p[4]);
  }
  static __device__ __forceinline__ B b_cols(const float* t, int pitch, int k0, int n0, int g,
                                             int qd) {
    const float* p = t + (k0 + 2 * qd) * pitch + n0 + g;
    return split_b(p[0], p[pitch]);
  }
  // c: the accumulator block of keys k0 .. k0 + 7.
  static __device__ __forceinline__ A a_acc(const float* c) { return split_a(c[0], c[2], c[1], c[3]); }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  }
};

// bfloat16 and float16: m16n8k16, float32 accumulators (``.bf16`` or
// ``.f16`` operands, the same fragment layout).  A pitch of the width plus
// 8 elements makes each row (2 D + 16) bytes, an odd number of 16-byte
// chunks at D = 16, 32, 48 and 256: the 32-bit fragment loads and
// ldmatrix's eight rows hit distinct banks.  The accumulator layout of two
// adjacent 8-key blocks is the A fragment of one k16 step, so a_acc packs
// in place; b_cols reads B across rows with ldmatrix.trans.
template <typename T>
struct Ops16 {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
  static __device__ __forceinline__ uint32_t ld32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A a_rows(const T* t, int pitch, int r0, int k0, int g,
                                             int qd) {
    const T* p = t + (r0 + g) * pitch + k0 + 2 * qd;
    return {{ld32(p), ld32(p + 8 * pitch), ld32(p + 8), ld32(p + 8 * pitch + 8)}};
  }
  static __device__ __forceinline__ B b_rows(const T* t, int pitch, int n0, int k0, int g,
                                             int qd) {
    const T* p = t + (n0 + g) * pitch + k0 + 2 * qd;
    return {{ld32(p), ld32(p + 8)}};
  }
  // ldmatrix.x2.trans: lanes 0-15 give the addresses of rows k0 .. k0 + 15
  // (8 columns from n0 each); lanes 16-31 repeat them.
  static __device__ __forceinline__ B b_cols(const T* t, int pitch, int k0, int n0, int, int) {
    const T* row = t + (k0 + threadIdx.x % 16) * pitch + n0;
    B f;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(f.x[0]), "=r"(f.x[1])
                 : "r"(smem_u32(row)));
    return f;
  }
  // c: the accumulator blocks of keys k0 .. k0 + 7 and k0 + 8 .. k0 + 15, one term.
  static __device__ __forceinline__ A a_acc(const float* c) {
    return {{pack2<T>(c[0], c[1]), pack2<T>(c[2], c[3]), pack2<T>(c[4], c[5]),
             pack2<T>(c[6], c[7])}};
  }
  // The same in two terms, hi = T(x) and lo = T(x - hi).
  static __device__ __forceinline__ void a_acc2(const float* c, A& hi, A& lo) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split2<T>(c[2 * i], c[2 * i + 1], hi.x[i], lo.x[i]);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
    } else {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
    }
  }
};

template <>
struct Ops<__nv_bfloat16> : Ops16<__nv_bfloat16> {};
template <>
struct Ops<__half> : Ops16<__half> {};

template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + Ops<T>::kPad;
}

// Rows [r0, r0 + ROWS) of a (L, D) slice at `src` (rows `ld` elements
// apart) into a tile at pitch<T, D>(), by 16-byte cp.async over the block's
// threads; rows at or past `rows` are zero-filled (masked keys then meet
// zeros in V, never stale shared memory).
template <typename T, int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int r0, int rows) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  constexpr int kChunks = D / kPer;     // copies per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < rows;
    cp_async16(dst + r * pitch<T, D>() + c * kPer, src + (valid ? r0 + r : 0) * ld + c * kPer,
               valid);
  }
}

// s (16 x 8 NG) = A B^T: A the 16 rows of `a` from r0, B the first 8 NG
// rows of `bt`, both over D columns.  S = q K^T, dP = dO V^T, and in the
// dK/dV kernel S^T = K q^T, dP^T = V dO^T.
template <typename T, int NG, int D>
__device__ __forceinline__ void gemm_rows(float (&s)[NG][4], const T* a, int r0, const T* bt,
                                          int g, int qd) {
  using O = Ops<T>;
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / O::kK; ++kk) {
    const typename O::A fa = O::a_rows(a, pitch<T, D>(), r0, kk * O::kK, g, qd);
#pragma unroll
    for (int j = 0; j < NG; ++j)
      O::mma(s[j], fa, O::b_rows(bt, pitch<T, D>(), 8 * j, kk * O::kK, g, qd));
  }
}

// d (16 x 8 NO) += P B: P (16 x 8 NP) the accumulators of the previous
// product, B the first 8 NP rows of `bt` (its rows are P's columns) over
// 8 NO columns.  O += P V, dQ += dS K, dV += P^T dO, dK += dS^T q.  TWO:
// P enters a bf16 product in two terms (the forward's P V).
template <typename T, int NP, int NO, bool TWO>
__device__ __forceinline__ void gemm_acc(float (&d)[NO][4], const float (&p)[NP][4], const T* bt,
                                         int g, int qd) {
  using O = Ops<T>;
  constexpr int kPitch = pitch<T, 8 * NO>();
#pragma unroll
  for (int kk = 0; kk < 8 * NP / O::kK; ++kk) {
    const float* c = &p[kk * O::kK / 8][0];
    if constexpr (TWO) {
      typename O::A hi, lo;
      O::a_acc2(c, hi, lo);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const typename O::B fb = O::b_cols(bt, kPitch, kk * O::kK, 8 * j, g, qd);
        O::mma(d[j], lo, fb);
        O::mma(d[j], hi, fb);
      }
    } else {
      const typename O::A fa = O::a_acc(c);
#pragma unroll
      for (int j = 0; j < NO; ++j) O::mma(d[j], fa, O::b_cols(bt, kPitch, kk * O::kK, 8 * j, g, qd));
    }
  }
}

// Two 8-byte-aligned adjacent outputs in T.
__device__ __forceinline__ void store2(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(__half* dst, float x0, float x1) {
  *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x0, x1);
}

// Warp pairs a block runs side by side.  Each pair owns the block's 32
// rows and takes every G-th tile (or q step) of the block's loop; the
// pairs' partial results are merged in a fixed order at the end (the same
// bits every run).  At S = 300 a float32 call has about one block an SM,
// and a lone pair of warps leaves the products' and loads' latencies bare.
// float32 runs four pairs (two at (256, 256), whose tiles would not fit
// shared memory four times); bf16 and f16, whose instances serve the
// reduced configs' rows of one tile, one.
template <typename T, int DQK, int DV>
__host__ __device__ constexpr int groups() {
  return sizeof(T) == 2 ? 1 : DQK + DV > 384 ? 2 : 4;
}

// Keys of a K/V tile (forward, dQ): 32, or 16 where four pairs' double
// stages of 32-key float32 tiles would not fit (Dqk + Dv >= 256).
template <typename T, int DQK, int DV>
__host__ __device__ constexpr int tile_keys() {
  return sizeof(T) == 4 && DQK + DV >= 256 ? 16 : 32;
}

// The forward's shared memory: q, then two stages of a round's G K tiles
// and G V tiles.  After the loop the stages hold the merge: pairs 1 .. G-1
// leave each row's output, running max and sum there.
template <typename T, int DQK, int DV>
struct FwdCfg {
  static constexpr int G = groups<T, DQK, DV>();
  static constexpr int kThreads = kPair * G;
  static constexpr int kKeys = tile_keys<T, DQK, DV>();
  static constexpr int kQ = kRows * pitch<T, DQK>();  // elements of the q tile
  static constexpr int kK = kKeys * pitch<T, DQK>();  // of one K tile
  static constexpr int kV = kKeys * pitch<T, DV>();   // of one V tile
  static constexpr int kStage = G * (kK + kV);
  static constexpr int kMergePitch = DV + 2;          // a row's output, max and sum
  static constexpr size_t kSmemBytes = sizeof(T) * (kQ + 2 * kStage);
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "whole k16 steps and 16-byte rows");
  static_assert(sizeof(float) * (G - 1) * kRows * kMergePitch <= sizeof(T) * 2 * kStage,
                "the merge fits the stages");
};

// Block (blockIdx.x = h + H b, blockIdx.y = q tile from the last): G warp
// pairs over one 32-row q tile, each warp owning 16 of its rows.  q is
// loaded once, K and V in rounds of G tiles of C::kKeys keys through two
// cp.async stages, round r + 1 loading while round r computes; pair j takes
// tile r G + j.  Per tile each warp computes S = q K^T, the online softmax
// on its accumulators (the row max and sum over the four lanes that share
// a row) and O += P V with P from registers.  Pair 0 merges the others'
// (output, max, sum) at the end and stores.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(FwdCfg<T, DQK, DV>::kThreads, 1)
    flash_fwd_kernel_mma(Params p) {
  using C = FwdCfg<T, DQK, DV>;
  constexpr int G = C::G, NT = C::kThreads, kKeys = C::kKeys;
  constexpr int NS = kKeys / 8;  // score blocks
  constexpr int NO = DV / 8;     // output blocks
  extern __shared__ __align__(16) uint8_t tc_smem[];
  T* qs = reinterpret_cast<T*>(tc_smem);
  T* stages = qs + C::kQ;

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal tiles first
  const int kvh = h / (p.H / p.KV);
  const int pair = threadIdx.x / kPair;
  const int warp = threadIdx.x / 32 % 2, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int n_valid = min(p.kv_len, p.T);
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + kRows);  // keys <= last q row
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1) / kKeys * kKeys;  // keys > first row - window
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + kKeys - 1) / kKeys : 0;
  const int n_rounds = (n_tiles + G - 1) / G;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto load_round = [&](int r) {
    T* st = stages + (r & 1) * C::kStage;
    for (int slot = 0; slot < G && r * G + slot < n_tiles; ++slot) {
      const int n0 = kv_start + (r * G + slot) * kKeys;
      load_tile<T, kKeys, DQK, NT>(st + slot * C::kK, k, p.k_ss, n0, p.T);
      load_tile<T, kKeys, DV, NT>(st + G * C::kK + slot * C::kV, v, p.v_ss, n0, p.T);
    }
  };
  load_tile<T, kRows, DQK, NT>(qs, q, p.q_ss, m0, p.S);
  if (n_rounds > 0) load_round(0);
  cp_async_commit();

  const int row0 = 16 * warp;                  // the warp's first row in the tile
  const bool live = m0 + row0 < p.S;           // a warp past S computes nothing
  const float scale_log2 = p.scale * kLog2e;   // scores in log2 units: exp2f
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) load_round(r + 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and round r have landed
    __syncthreads();
    const int i = r * G + pair;
    if (live && i < n_tiles) {
      const int n0 = kv_start + i * kKeys;
      const T* st = stages + (r & 1) * C::kStage;
      float s[NS][4];
      gemm_rows<T, NS, DQK>(s, qs, row0, st + pair * C::kK, g, qd);
      const bool masked = n0 + kKeys > n_valid || (p.causal && n0 + kKeys - 1 > m0) ||
                          (p.window > 0 && n0 <= m0 + kRows - 1 - p.window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale_log2;
          if (masked) {
            const int row = m0 + row0 + g + 8 * (e >> 1);
            const int key = n0 + 8 * j + 2 * qd + (e & 1);
            bool ok = key < n_valid;
            if (p.causal) ok = ok && key <= row;
            if (p.window > 0) ok = ok && key > row - p.window;
            if (!ok) s[j][e] = -INFINITY;
          }
        }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r2], s[j][2 * r2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r2], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: p = 0
        const float alpha = exp2f(m_run[r2] - m_use);
        m_run[r2] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pr = exp2f(s[j][2 * r2 + c] - m_use);
            s[j][2 * r2 + c] = pr;
            sum += pr;
          }
        l_run[r2] = l_run[r2] * alpha + sum;  // this lane's part of the row sum
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[j][2 * r2] *= alpha;
          o[j][2 * r2 + 1] *= alpha;
        }
      }
      gemm_acc<T, NS, NO, sizeof(T) == 2>(o, s, st + G * C::kK + pair * C::kV, g, qd);
    }
    __syncthreads();  // every pair is done with stage r & 1 before it refills
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {  // each row's whole sum
    l_run[r2] += __shfl_xor_sync(0xffffffffu, l_run[r2], 1);
    l_run[r2] += __shfl_xor_sync(0xffffffffu, l_run[r2], 2);
  }
  if constexpr (G > 1) {
    __syncthreads();
    float* merge = reinterpret_cast<float*>(stages);
    constexpr int MP = C::kMergePitch;
    if (pair > 0) {
      float* mine = merge + (pair - 1) * kRows * MP;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float* row = mine + (row0 + g + 8 * r2) * MP;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          row[8 * j + 2 * qd] = o[j][2 * r2];
          row[8 * j + 2 * qd + 1] = o[j][2 * r2 + 1];
        }
        if (qd == 0) {
          row[DV] = m_run[r2];
          row[DV + 1] = l_run[r2];
        }
      }
    }
    __syncthreads();
    if (pair > 0) return;
    for (int other = 1; other < G; ++other) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float* row = merge + ((other - 1) * kRows + row0 + g + 8 * r2) * MP;
        const float m_new = fmaxf(m_run[r2], row[DV]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float a = exp2f(m_run[r2] - m_use), c = exp2f(row[DV] - m_use);
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[j][2 * r2] = o[j][2 * r2] * a + row[8 * j + 2 * qd] * c;
          o[j][2 * r2 + 1] = o[j][2 * r2 + 1] * a + row[8 * j + 2 * qd + 1] * c;
        }
        l_run[r2] = l_run[r2] * a + row[DV + 1] * c;
        m_run[r2] = m_new;
      }
    }
  }

  if (!live) return;
  T* out = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const float inv = 1.f / fmaxf(l_run[r2], 1e-30f);
    const int row = m0 + row0 + g + 8 * r2;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < NO; ++j)
        store2(out + row * p.o_ss + 8 * j + 2 * qd, o[j][2 * r2] * inv, o[j][2 * r2 + 1] * inv);
      // m_run is in log2 units; -inf for a row with no valid key.
      if (p.lse != nullptr && qd == 0)
        p.lse[((long long)b * p.H + h) * p.S + row] =
            m_run[r2] * 0.6931471805599453f + logf(l_run[r2]);
    }
  }
}

// The 16-byte rule of cp.async for a (B, L, heads, D) tensor: a 16-byte
// aligned base and every stepped stride a multiple of 16 bytes (the head
// dim is contiguous, and D is a multiple of 16).
bool rows_16b(const void* ptr, long long sb, long long sl, long long sh, int B, int L, int heads,
              int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const long long strides[3] = {sb, sl, sh};
  const int sizes[3] = {B, L, heads};
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && (strides[i] * elem) % 16) return false;
  return true;
}

// Returns a cudaError_t, or kTensorMapRejected when q, k or v breaks the
// 16-byte rule (ops.py copies such a tensor first).
template <typename T, int DQK, int DV>
int launch_fwd(const Params& p, int B, cudaStream_t stream) {
  using C = FwdCfg<T, DQK, DV>;
  constexpr int e = sizeof(T);
  if (!rows_16b(p.q, p.q_sb, p.q_ss, p.q_sh, B, p.S, p.H, e) ||
      !rows_16b(p.k, p.k_sb, p.k_ss, p.k_sh, B, p.T, p.KV, e) ||
      !rows_16b(p.v, p.v_sb, p.v_ss, p.v_sh, B, p.T, p.KV, e))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(flash_fwd_kernel_mma<T, DQK, DV>, C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(p.H * B, (p.S + kRows - 1) / kRows);
  flash_fwd_kernel_mma<T, DQK, DV><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
// 1024-byte boundary, the 128-byte swizzle's period), for q and K of head
// dim DQK and V of head dim DV:
//   q       DQK/64 chunks x 64 rows x 128 B
//   k       kStages x (DQK/64 chunks x kBN rows x 128 B)
//   v       kStages x (DV/64 chunks x kBN rows x 128 B)
//   barriers  q, k[kStages], v[kStages], k_free[kStages], v_free[kStages]
// At DQK 192, DV 128 (DeepSeek-V2's MLA) that is 24 + 48 + 32 KB, so two
// blocks still share an SM.
template <int DQK, int DV>
struct Cfg {
  static constexpr int kQkChunks = DQK / 64;
  static constexpr int kVChunks = DV / 64;
  static constexpr uint32_t kQBytes = kBM * DQK * 2;   // the block's q rows
  static constexpr uint32_t kKBytes = kBN * DQK * 2;   // one K tile
  static constexpr uint32_t kVBytes = kBN * DV * 2;    // one V tile
  static constexpr uint32_t kOffK = kQBytes;
  static constexpr uint32_t kOffV = kOffK + kStages * kKBytes;
  static constexpr uint32_t kOffBar = kOffV + kStages * kVBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 4 * kStages) + 1024;
  static_assert(DQK % 64 == 0 && DV % 64 == 0 && kBN % 16 == 0,
                "tiles are whole swizzle chunks and k16 steps");
  static_assert(2 * (kSmemBytes + 1024) <= 233472, "two blocks must share an SM");
};

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

// The 16-bit element type's name in wgmma's PTX (the A and B operands).
#define FLASH_WGMMA_SS_N64(TY)                                                           \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define FLASH_WGMMA_RS_N64(TY)                                                          \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define FLASH_WGMMA_RS_N128(TY)                                                          \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define FLASH_WGMMA_RS_N192(TY)                                                          \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {"                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, " \
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) x B (16 x 64, smem,
// K-major), A and B in T (bfloat16 or float16).
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  if constexpr (std::is_same<T, __half>::value) FLASH_WGMMA_SS_N64("f16");
  else FLASH_WGMMA_SS_N64("bf16");
}

// d (64 x N, f32) += A (64 x 16, registers) x B (16 x N, smem, MN-major),
// A and B in T.  N = 192: the dK accumulator at DQK 192 (the dK/dV
// kernel's second warpgroup).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 192, "wgmma widths 64, 128 and 192");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kHalf) FLASH_WGMMA_RS_N64("f16");
    else FLASH_WGMMA_RS_N64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (kHalf) FLASH_WGMMA_RS_N128("f16");
    else FLASH_WGMMA_RS_N128("bf16");
  } else {
    if constexpr (kHalf) FLASH_WGMMA_RS_N192("f16");
    else FLASH_WGMMA_RS_N192("bf16");
  }
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
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t koff = (kk % 4) * 32;  // 16 columns inside a 128-byte row chunk
    wgmma_ss_n64<T>(sc, desc_sw128(q_base + (kk / 4) * kBM * kRowBytes + koff, 16, 1024),
                 desc_sw128(k_base + (kk / 4) * kBN * kRowBytes + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o (64 x D) += P (64 x kBN, registers, hi + lo) V (kBN x D), issued and
// committed, not waited.  Keys 16*kk .. 16*kk + 15 are accumulator groups
// 2*kk and 2*kk + 1, i.e. A fragments [4*kk, 4*kk + 4).
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p_hi)[kBN / 4],
                                         const uint32_t (&p_lo)[kBN / 4], uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
    const uint32_t lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
    const uint64_t dv = desc_sw128(v_base + kk * 16 * kRowBytes, kBN * kRowBytes, 1024);
    wgmma_rs_tb<T, D>(o, hi, dv);
    wgmma_rs_tb<T, D>(o, lo, dv);
  }
  wgmma_commit();
}

// The probabilities as A fragments: (r, k), (r+8, k), (r, k+8), (r+8, k+8)
// for each 16 keys, i.e. consecutive pairs of the accumulator; two terms
// in T, hi and lo.
template <typename T>
__device__ __forceinline__ void to_fragments(const float (&sc)[kBN / 2], uint32_t (&p_hi)[kBN / 4],
                                             uint32_t (&p_lo)[kBN / 4]) {
#pragma unroll
  for (int f = 0; f < kBN / 4; ++f) split2<T>(sc[2 * f], sc[2 * f + 1], p_hi[f], p_lo[f]);
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
// when its product is done.  T: bfloat16 or float16.
template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(kBlockThreads, 2)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<DQK, DV>;
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
      for (int c = 0; c < C::kQkChunks; ++c)
        tma_load_4d(base + c * kBM * kRowBytes, &tq, bar_q, 64 * c, h, m0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t free_parity = (i / kStages - 1) & 1;
        const int n0 = kv_start + i * kBN;
        const uint32_t k_dst = base + C::kOffK + s * C::kKBytes;
        const uint32_t v_dst = base + C::kOffV + s * C::kVBytes;
        if (i >= kStages) mbar_wait(bar_k_free + 8 * s, free_parity);
        mbar_expect_tx(bar_k + 8 * s, C::kKBytes);
        for (int c = 0; c < C::kQkChunks; ++c)
          tma_load_4d(k_dst + c * kBN * kRowBytes, &tk, bar_k + 8 * s, 64 * c, kvh, n0, b);
        if (i >= kStages) mbar_wait(bar_v_free + 8 * s, free_parity);
        mbar_expect_tx(bar_v + 8 * s, C::kVBytes);
        for (int c = 0; c < C::kVChunks; ++c)
          tma_load_4d(v_dst + c * kBN * kRowBytes, &tv, bar_v + 8 * s, 64 * c, kvh, n0, b);
      }
    }
    return;
  }

  // The consumer warpgroup: q rows [m0, m0 + 64).
  const Rows r{m0, m0 + 16 * warp + lane / 4, 2 * (lane % 4)};
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const uint32_t q_base = base;
  auto k_base = [&](int s) { return base + C::kOffK + s * C::kKBytes; };
  auto v_base = [&](int s) { return base + C::kOffV + s * C::kVBytes; };

  float o[DV / 2];
#pragma unroll
  for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
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
    issue_qk<T, DQK>(sc, q_base, k_base(0));
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar_k_free);
    online_softmax(sc, p, r, kv_start, n_valid, scale_log2, m_run, l_run, alpha);
    to_fragments<T>(sc, p_hi, p_lo);
  }
  // Tile i's P V product runs under tile i+1's scores and softmax.  No
  // branch separates a wgmma from its wait, so ptxas keeps them asynchronous.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int s = i % kStages;
    const int s1 = (i + 1) % kStages;
    mbar_wait(bar_k + 8 * s1, ((i + 1) / kStages) & 1);
    wgmma_fence();
    issue_qk<T, DQK>(sc, q_base, k_base(s1));
    mbar_wait(bar_v + 8 * s, (i / kStages) & 1);
    wgmma_fence();
    issue_pv<T, DV>(o, p_hi, p_lo, v_base(s));
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
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        o[4 * j + 2 * ii] *= alpha[ii];
        o[4 * j + 2 * ii + 1] *= alpha[ii];
      }
    to_fragments<T>(sc, p_hi, p_lo);
  }
  if (n_tiles > 0) {  // the last tile's product
    const int s = (n_tiles - 1) % kStages;
    mbar_wait(bar_v + 8 * s, ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<T, DV>(o, p_hi, p_lo, v_base(s));
    wgmma_wait<0>();
    fence_regs(o);
  }

  T* out = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    float l = l_run[ii];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int row = r.row0 + 8 * ii;
    if (row < p.S) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<Pair<T>*>(out + row * p.o_ss + 8 * j + r.col0) =
            pair2<T>(o[4 * j + 2 * ii] / denom, o[4 * j + 2 * ii + 1] / denom);
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

// The encoder is a driver call: it needs a context current on the calling
// thread.  A thread that has made no runtime call yet has none (autograd's
// device thread, when this kernel is the first node a backward pass
// reaches), and the encoder then fails with CUDA_ERROR_INVALID_CONTEXT;
// cudaFree(nullptr) binds the device's primary context to the thread.
EncodeTiled encode_tiled() {
  thread_local const bool bound = cudaFree(nullptr) == cudaSuccess;
  if (!bound) return nullptr;
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

// A (B, L, heads, D) tensor of T (bfloat16 or float16), strides in
// elements, as the 4-D map {D, heads, L, B} with box {64, 1, rows, 1} and
// the 128-byte swizzle.  A dimension of size 1 is never stepped; it gets
// the extent of the dimensions inside it as its stride, which TMA accepts
// whatever the tensor's own stride there is.  The map's data type is
// chosen by the type, not by its size.
template <typename T>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L, int heads,
              int D, long long sb, long long sl, long long sh, int rows) {
  static_assert(sizeof(T) == 2, "16-bit tiles");
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
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returns a cudaError_t, or kTensorMapRejected when q, k or v breaks TMA's
// layout rule (cuTensorMapEncodeTiled checks it: a 16-byte aligned base and
// 16-byte multiple strides).
template <int DQK, int DV, typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<T>(encode, &tq, p.q, B, p.S, p.H, DQK, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !make_map<T>(encode, &tk, p.k, B, p.T, p.KV, DQK, p.k_sb, p.k_ss, p.k_sh, kBN) ||
      !make_map<T>(encode, &tv, p.v, B, p.T, p.KV, DV, p.v_sb, p.v_ss, p.v_sh, kBN))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<DQK, DV, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(p.H * B, (p.S + kBM - 1) / kBM);
  flash_fwd_kernel_sm90<DQK, DV, T><<<grid, kBlockThreads, C::kSmemBytes, stream>>>(tq, tk, tv,
                                                                                    p);
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
//   * delta = rowsum(dO * O) per (b, h, row);
//   * dK/dV: one block per (key tile, kv head, b) walks every q head of the
//     GQA group and every q tile the mask lets see the tile, recomputing
//     P = exp(scale q.k - lse) and dS = P (dO V^T - delta), and keeps dV =
//     sum P^T dO and dK = scale sum dS^T Q in registers: the group's sum
//     needs no atomics;
//   * dQ: one block per (q tile, head, b) walks the key tiles the forward
//     walks and keeps dQ = scale sum dS K in registers.  A separate dQ
//     kernel recomputes S and dO V^T once more, and in exchange nothing is
//     accumulated across blocks (no atomics, no f32 scratch, the same
//     result every run).
// The mask predicate is the forward's; tiles it leaves dead are never
// loaded.
//
// Bound on an H100 SXM: q, k, v, o, dO and the lse read once and dq, dk, dv
// written once are about 0.040 ms at olmo-1b's training shape (B=8, S=512,
// 16x128 heads, bf16, causal), the five products over the causal pairs
// 0.022 ms at the bf16 tensor-core rate: bound by bytes.  The two-kernel
// split runs seven products (S and dP once more for dQ), 0.030 ms at that
// rate, still below the byte bound.
//
// float32 at every head dim and bfloat16 at (16, 16), (32, 32), (48, 32)
// (tc::flash_bwd_dq_kernel_mma, tc::flash_bwd_dkdv_kernel_mma): the
// forward's fragments, 3xTF32 split and 32-row tiles.
//   * Two launches a call.  The dQ kernel runs first and computes delta for
//     its own rows from O and dO, under its first copies, and writes it
//     out; the dK/dV kernel reads it with each q tile's lse.  The v1
//     backward's separate delta pre-pass is gone, and with it a launch:
//     at the reduced configs' shapes (B=4, S=32) a call is launches and
//     serial tails, not products.
//   * dK/dV works transposed (rows are keys): each warp of a pair owns 16
//     of the block's 32 keys, computes S^T = K q^T and dP^T = V dO^T, forms
//     P^T and dS^T in registers and accumulates dV += P^T dO and dK += dS^T
//     q, P^T and dS^T entering from registers as A operands.  q and dO
//     stream through two cp.async stages (32 rows a step, 16 at (128, 128)
//     and (192, 128), where the dK and dV accumulators take 128-160
//     registers a thread).
//   * dQ: each warp of a pair owns 16 q rows; K and V stream through two
//     stages.
//   * Both run the forward's G warp pairs, pair j taking every G-th step or
//     tile; pair 0 adds the others' dK, dV or dQ in a fixed order.
//   * bf16 tiles stay bf16 in shared memory.  In bf16, P and dS enter the
//     tensor cores in one term each, dS formed from the rounded P, as the
//     wgmma backward (tests/test_torch_flash_bwd_rounding.py).
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
  float* delta;      // (B, H, S), written by the pre-pass (wgmma) or the dQ kernel
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

__device__ __forceinline__ bool visible(const BwdParams& p, int n_valid, int m, int n) {
  bool ok = m < p.S && n < n_valid;
  if (p.causal) ok = ok && n <= m;
  if (p.window > 0) ok = ok && n > m - p.window;
  return ok;
}

namespace tc {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// dQ: q and dO of the block's 32 rows, then two stages of a round's G K
// tiles and G V tiles; after the loop the stages hold pairs 1 .. G-1's dQ.
template <typename T, int DQK, int DV>
struct DqCfg {
  static constexpr int G = groups<T, DQK, DV>();
  static constexpr int kThreads = kPair * G;
  static constexpr int kKeys = tile_keys<T, DQK, DV>();
  static constexpr int kQ = kRows * pitch<T, DQK>();
  static constexpr int kDo = kRows * pitch<T, DV>();
  static constexpr int kK = kKeys * pitch<T, DQK>();
  static constexpr int kV = kKeys * pitch<T, DV>();
  static constexpr int kStage = G * (kK + kV);
  static constexpr size_t kSmemBytes = sizeof(T) * (kQ + kDo + 2 * kStage);
  static_assert(sizeof(float) * (G - 1) * kRows * DQK <= sizeof(T) * 2 * kStage,
                "the merge fits the stages");
};

// dK/dV: K and V of the block's 32 keys, then two stages of a round's G
// (q, dO) slots of kStep q rows, then the slots' (lse, delta).  At (192,
// 128) and (128, 128) a step is 16 rows, which keeps the dK and dV
// accumulators with S^T and dP^T in registers; 32 rows elsewhere.  After
// the loop the stages hold pairs 1 .. G-1's dK and dV.
template <typename T, int DQK, int DV>
struct DkdvCfg {
  static constexpr int G = groups<T, DQK, DV>();
  static constexpr int kThreads = kPair * G;
  static constexpr int kStep = DQK + DV >= 256 ? 16 : 32;
  static constexpr int kK = kRows * pitch<T, DQK>();
  static constexpr int kV = kRows * pitch<T, DV>();
  static constexpr int kQ = kStep * pitch<T, DQK>();
  static constexpr int kSlot = kQ + kStep * pitch<T, DV>();  // a step's q, then its dO
  static constexpr int kStage = G * kSlot;
  static constexpr size_t kTileBytes = sizeof(T) * (kK + kV + 2 * kStage);
  static constexpr size_t kSmemBytes = kTileBytes + sizeof(float) * 2 * G * 2 * kStep;
  static_assert(kTileBytes % 16 == 0, "the stats follow 16-byte tiles");
  static_assert(sizeof(float) * (G - 1) * kRows * (DQK + DV) <= sizeof(T) * 2 * kStage,
                "the merge fits the stages");
};

// dQ per (32-row q tile, head, b), launched first: delta = rowsum(dO O) of
// its rows in float32 (written out for the dK/dV kernel), then over the key
// tiles the forward walks, in rounds of G tiles through two cp.async
// stages (pair j takes tile r G + j): S = q K^T, dP = dO V^T, P =
// exp2(S scale log2e - lse log2e), dS = P (dP - delta) in registers, dQ +=
// dS K.  Each warp owns 16 of the rows; pair 0 sums the pairs' dQ in order.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(DqCfg<T, DQK, DV>::kThreads, 1)
    flash_bwd_dq_kernel_mma(BwdParams p) {
  using C = DqCfg<T, DQK, DV>;
  constexpr int G = C::G, NT = C::kThreads, kKeys = C::kKeys;
  constexpr int NS = kKeys / 8;
  constexpr int NQ = DQK / 8;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __shared__ float lse_s[kRows], delta_s[kRows];
  T* qs = reinterpret_cast<T*>(tc_smem);
  T* dos = qs + C::kQ;
  T* stages = dos + C::kDo;

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest causal chains first
  const int kvh = h / (p.H / p.KV);
  const int pair = threadIdx.x / kPair;
  const int warp = threadIdx.x / 32 % 2, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int n_valid = min(p.kv_len, p.T);
  int kv_end = n_valid;
  if (p.causal) kv_end = min(kv_end, m0 + kRows);
  int kv_start = 0;
  if (p.window > 0) kv_start = max(0, m0 - p.window + 1) / kKeys * kKeys;
  const int n_tiles = kv_end > kv_start ? (kv_end - kv_start + kKeys - 1) / kKeys : 0;
  const int n_rounds = (n_tiles + G - 1) / G;

  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto load_round = [&](int r) {
    T* st = stages + (r & 1) * C::kStage;
    for (int slot = 0; slot < G && r * G + slot < n_tiles; ++slot) {
      const int n0 = kv_start + (r * G + slot) * kKeys;
      load_tile<T, kKeys, DQK, NT>(st + slot * C::kK, k, p.k_ss, n0, p.T);
      load_tile<T, kKeys, DV, NT>(st + G * C::kK + slot * C::kV, v, p.v_ss, n0, p.T);
    }
  };
  load_tile<T, kRows, DQK, NT>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                               m0, p.S);
  load_tile<T, kRows, DV, NT>(dos, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
                              p.do_ss, m0, p.S);
  if (n_rounds > 0) load_round(0);
  cp_async_commit();

  if (threadIdx.x < kPair) {  // delta and lse of the tile's rows, two threads a row
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int m = m0 + r;
    const long long stat = ((long long)b * p.H + h) * p.S + m;
    float acc = 0.f;
    if (m < p.S) {
      const T* o = static_cast<const T*>(p.o) + b * p.o_sb + m * p.o_ss + h * p.o_sh + half * (DV / 2);
      const T* go = static_cast<const T*>(p.dout) + b * p.do_sb + m * p.do_ss + h * p.do_sh +
                    half * (DV / 2);
#pragma unroll
      for (int d = 0; d < DV / 2; ++d) acc = fmaf(to_float(go[d]), to_float(o[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[r] = acc;
      lse_s[r] = m < p.S ? p.lse[stat] * kLog2e : 0.f;
      if (m < p.S) p.delta[stat] = acc;
    }
  }
  __syncthreads();

  const int row0 = 16 * warp;
  const bool live = m0 + row0 < p.S;
  const float scale_log2 = p.scale * kLog2e;
  const float lse_r[2] = {lse_s[row0 + g], lse_s[row0 + g + 8]};
  const float delta_r[2] = {delta_s[row0 + g], delta_s[row0 + g + 8]};
  float dq[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) load_round(r + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i = r * G + pair;
    if (live && i < n_tiles) {
      const int n0 = kv_start + i * kKeys;
      const T* kt = stages + (r & 1) * C::kStage + pair * C::kK;
      float s[NS][4], dp[NS][4];
      gemm_rows<T, NS, DQK>(s, qs, row0, kt, g, qd);
      gemm_rows<T, NS, DV>(dp, dos, row0, stages + (r & 1) * C::kStage + G * C::kK + pair * C::kV,
                           g, qd);
      const bool masked = n0 + kKeys > n_valid || m0 + kRows > p.S ||
                          (p.causal && n0 + kKeys - 1 > m0) ||
                          (p.window > 0 && n0 <= m0 + kRows - 1 - p.window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          float pr = exp2f(s[j][e] * scale_log2 - lse_r[rr]);
          if (masked && !visible(p, n_valid, m0 + row0 + g + 8 * rr, n0 + 8 * j + 2 * qd + (e & 1)))
            pr = 0.f;
          if constexpr (sizeof(T) == 2) pr = round16<T>(pr);  // dS from the P a 16-bit product sees
          s[j][e] = pr * (dp[j][e] - delta_r[rr]);            // dS
        }
      gemm_acc<T, NS, NQ, false>(dq, s, kt, g, qd);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (G > 1) {  // pair 0 adds the others' dQ, in order
    __syncthreads();
    float* merge = reinterpret_cast<float*>(stages);
    if (pair > 0) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float* row = merge + ((pair - 1) * kRows + row0 + g + 8 * r2) * DQK;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          row[8 * j + 2 * qd] = dq[j][2 * r2];
          row[8 * j + 2 * qd + 1] = dq[j][2 * r2 + 1];
        }
      }
    }
    __syncthreads();
    if (pair > 0) return;
    for (int other = 1; other < G; ++other)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float* row = merge + ((other - 1) * kRows + row0 + g + 8 * r2) * DQK;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          dq[j][2 * r2] += row[8 * j + 2 * qd];
          dq[j][2 * r2 + 1] += row[8 * j + 2 * qd + 1];
        }
      }
  }

  if (!live) return;
  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int m = m0 + row0 + g + 8 * r2;
    if (m >= p.S) continue;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      store2(dqp + m * p.dq_ss + 8 * j + 2 * qd, dq[j][2 * r2] * p.scale,
             dq[j][2 * r2 + 1] * p.scale);
  }
}

// dK/dV per (32-key tile, kv head, b), after the dQ kernel: K and V are
// loaded once; the q and dO rows of every q tile that sees the keys, over
// every q head of the GQA group (the group's sum needs no atomics), stream
// in rounds of G steps through two cp.async stages with their lse and
// delta (pair j takes step r G + j).  The work is transposed (rows are
// keys): each warp owns 16 keys and computes S^T = K q^T and dP^T = V dO^T,
// P^T and dS^T = P^T (dP^T - delta) in registers, dV += P^T dO and dK +=
// dS^T q.  Pair 0 sums the pairs' dK and dV in order.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(DkdvCfg<T, DQK, DV>::kThreads, 1)
    flash_bwd_dkdv_kernel_mma(BwdParams p) {
  using C = DkdvCfg<T, DQK, DV>;
  constexpr int G = C::G, NT = C::kThreads;
  constexpr int kStep = C::kStep;
  constexpr int NS = kStep / 8;
  constexpr int NK = DQK / 8, NV = DV / 8;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  T* ks = reinterpret_cast<T*>(tc_smem);
  T* vs = ks + C::kK;
  T* stages = vs + C::kV;
  float* stats = reinterpret_cast<float*>(tc_smem + C::kTileBytes);  // [stage][slot][lse, delta]

  const int kvh = blockIdx.x % p.KV;
  const int b = blockIdx.x / p.KV;
  const int n0 = blockIdx.y * kRows;  // the first key tiles see the most rows: launched first
  const int group = p.H / p.KV;
  const int pair = threadIdx.x / kPair;
  const int warp = threadIdx.x / 32 % 2, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int n_valid = min(p.kv_len, p.T);
  // The q rows that see a key of this tile, in steps of kStep rows.
  int m_begin = 0, m_end = n0 < n_valid ? p.S : 0;
  if (p.causal) m_begin = n0;                                        // rows >= first key
  if (p.window > 0) m_end = min(m_end, n0 + kRows - 1 + p.window);  // rows < last key + window
  m_begin = m_begin / kStep * kStep;
  const int per_head = m_end > m_begin ? (m_end - m_begin + kStep - 1) / kStep : 0;
  const int n_steps = group * per_head;
  const int n_rounds = (n_steps + G - 1) / G;

  load_tile<T, kRows, DQK, NT>(ks, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
                               p.k_ss, n0, p.T);
  load_tile<T, kRows, DV, NT>(vs, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                              p.v_ss, n0, p.T);
  // Step i: q head kvh * group + i / per_head, rows from m_begin + (i % per_head) kStep.
  auto load_round = [&](int r) {
    for (int slot = 0; slot < G && r * G + slot < n_steps; ++slot) {
      const int i = r * G + slot;
      const int hq = kvh * group + i / per_head;
      const int m = m_begin + (i % per_head) * kStep;
      T* qt = stages + (r & 1) * C::kStage + slot * C::kSlot;
      load_tile<T, kStep, DQK, NT>(qt, static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh,
                                   p.q_ss, m, p.S);
      load_tile<T, kStep, DV, NT>(qt + C::kQ,
                                  static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh,
                                  p.do_ss, m, p.S);
      if (threadIdx.x < 2 * kStep) {  // lse, then delta
        const int rr = threadIdx.x % kStep;
        const bool valid = m + rr < p.S;
        const float* src = threadIdx.x < kStep ? p.lse : p.delta;
        cp_async4(stats + ((r & 1) * G + slot) * 2 * kStep + threadIdx.x,
                  src + ((long long)b * p.H + hq) * p.S + (valid ? m + rr : 0), valid);
      }
    }
  };
  if (n_rounds > 0) load_round(0);
  cp_async_commit();

  const int row0 = 16 * warp;  // the warp's first key in the tile
  const bool live = n0 + row0 < n_valid;
  const float scale_log2 = p.scale * kLog2e;
  float dk[NK][4], dv[NV][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;

  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) load_round(r + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i = r * G + pair;
    if (live && i < n_steps) {
      const int m0 = m_begin + (i % per_head) * kStep;
      const T* qt = stages + (r & 1) * C::kStage + pair * C::kSlot;
      const T* dot = qt + C::kQ;
      const float* sl = stats + ((r & 1) * G + pair) * 2 * kStep;
      float s[NS][4], dp[NS][4];
      gemm_rows<T, NS, DQK>(s, ks, row0, qt, g, qd);   // S^T
      gemm_rows<T, NS, DV>(dp, vs, row0, dot, g, qd);  // dP^T
      const bool masked = n0 + kRows > n_valid || m0 + kStep > p.S ||
                          (p.causal && n0 + kRows - 1 > m0) ||
                          (p.window > 0 && n0 <= m0 + kStep - 1 - p.window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * qd + c;  // the q row in the step
          const float lse = sl[col] * kLog2e, delta = sl[kStep + col];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int e = 2 * rr + c;
            float pr = exp2f(s[j][e] * scale_log2 - lse);
            if (masked && !visible(p, n_valid, m0 + col, n0 + row0 + g + 8 * rr)) pr = 0.f;
            if constexpr (sizeof(T) == 2) pr = round16<T>(pr);
            s[j][e] = pr;                        // P^T
            dp[j][e] = pr * (dp[j][e] - delta);  // dS^T
          }
        }
      gemm_acc<T, NS, NV, false>(dv, s, dot, g, qd);
      gemm_acc<T, NS, NK, false>(dk, dp, qt, g, qd);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (G > 1) {  // pair 0 adds the others' dK and dV, in order
    __syncthreads();
    float* merge = reinterpret_cast<float*>(stages);
    constexpr int MP = DQK + DV;
    if (pair > 0) {
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float* row = merge + ((pair - 1) * kRows + row0 + g + 8 * r2) * MP;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          row[8 * j + 2 * qd] = dk[j][2 * r2];
          row[8 * j + 2 * qd + 1] = dk[j][2 * r2 + 1];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          row[DQK + 8 * j + 2 * qd] = dv[j][2 * r2];
          row[DQK + 8 * j + 2 * qd + 1] = dv[j][2 * r2 + 1];
        }
      }
    }
    __syncthreads();
    if (pair > 0) return;
    for (int other = 1; other < G; ++other)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float* row = merge + ((other - 1) * kRows + row0 + g + 8 * r2) * MP;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          dk[j][2 * r2] += row[8 * j + 2 * qd];
          dk[j][2 * r2 + 1] += row[8 * j + 2 * qd + 1];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          dv[j][2 * r2] += row[DQK + 8 * j + 2 * qd];
          dv[j][2 * r2 + 1] += row[DQK + 8 * j + 2 * qd + 1];
        }
      }
  }

  // Keys past n_valid (but inside T) get zeros.
  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int n = n0 + row0 + g + 8 * r2;
    if (n >= p.T) continue;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      store2(dkp + n * p.dk_ss + 8 * j + 2 * qd, dk[j][2 * r2] * p.scale,
             dk[j][2 * r2 + 1] * p.scale);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      store2(dvp + n * p.dv_ss + 8 * j + 2 * qd, dv[j][2 * r2], dv[j][2 * r2 + 1]);
  }
}

// dQ (which writes delta), then dK/dV.  Returns a cudaError_t, or
// kTensorMapRejected when q, k, v or dO breaks the 16-byte rule.
template <typename T, int DQK, int DV>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  using Dq = DqCfg<T, DQK, DV>;
  using Dkdv = DkdvCfg<T, DQK, DV>;
  constexpr int e = sizeof(T);
  if (!rows_16b(p.q, p.q_sb, p.q_ss, p.q_sh, B, p.S, p.H, e) ||
      !rows_16b(p.k, p.k_sb, p.k_ss, p.k_sh, B, p.T, p.KV, e) ||
      !rows_16b(p.v, p.v_sb, p.v_ss, p.v_sh, B, p.T, p.KV, e) ||
      !rows_16b(p.dout, p.do_sb, p.do_ss, p.do_sh, B, p.S, p.H, e))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(flash_bwd_dq_kernel_mma<T, DQK, DV>, Dq::kSmemBytes);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel_mma<T, DQK, DV>, Dkdv::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid_q(p.H * B, (p.S + kRows - 1) / kRows);
  flash_bwd_dq_kernel_mma<T, DQK, DV><<<grid_q, Dq::kThreads, Dq::kSmemBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv(p.KV * B, (p.T + kRows - 1) / kRows);
  flash_bwd_dkdv_kernel_mma<T, DQK, DV><<<grid_kv, Dkdv::kThreads, Dkdv::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc

namespace sm90 {

constexpr int kDkdvStages = 3;  // Q/dO tile pairs in flight (dK/dV)
constexpr int kDqStages = 2;    // K/V tile pairs in flight (dQ)

// 64-row bf16 tiles of q and K (head dim DQK) and of V and dO (DV), each
// DQK/64 or DV/64 swizzled chunks x 64 rows x 128 B.
template <int DQK, int DV>
struct BwdTiles {
  static constexpr uint32_t kQk = 64 * DQK * 2;  // a q or K tile
  static constexpr uint32_t kV = 64 * DV * 2;    // a V or dO tile
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "tiles are whole swizzle chunks");
};

// dK/dV: two consumer warpgroups (warps 0-7) and one producer warp.  Shared
// memory (1024-byte aligned base):
//   K, V      the block's 64 keys
//   ring      kDkdvStages x (Q tile, dO tile) of 64 q rows
//   P         kDkdvStages x P^T as warpgroup 0's bf16 fragments, 16 x 128 words
//   stats     kDkdvStages x (64 lse in log2 units, 64 delta)
//   barriers  K/V, full[stage], free[stage], P ready[stage]
// 186 KB at DQK 192, DV 128.
template <int DQK, int DV>
struct DkdvCfg : BwdTiles<DQK, DV> {
  using Tiles = BwdTiles<DQK, DV>;
  static constexpr int kThreads = 288;
  static constexpr int kProducerWarp = 8;
  static constexpr uint32_t kOffRing = Tiles::kQk + Tiles::kV;
  static constexpr uint32_t kStageBytes = Tiles::kQk + Tiles::kV;
  static constexpr uint32_t kOffP = kOffRing + kDkdvStages * kStageBytes;
  static constexpr uint32_t kOffStats = kOffP + kDkdvStages * 16 * 128 * 4;
  static constexpr uint32_t kOffBar = kOffStats + kDkdvStages * 2 * 64 * sizeof(float);
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 3 * kDkdvStages) + 1024;
  static_assert(kSmemBytes <= 232448, "one block must fit an SM's shared memory");
};

// dQ: one consumer warpgroup (warps 0-3) and one producer warp.  Shared
// memory: Q and dO of the block's 64 rows, then kDqStages x (K tile, V
// tile), then barriers Q/dO, full[stage], free[stage].  Two blocks share
// an SM up to DQK = DV = 128 (99 KB each).  At DQK 192, DV 128 a block
// takes 121 KB and runs alone on its SM: it keeps both stages, so the next
// key tile still loads under the current one's four products, and its dQ
// accumulator (96 registers) with S, dP and dS (80) fits the 255 registers
// a lone block may hold without spilling; one stage would let two blocks
// share the SM but serialize each block's loads with its products.
template <int DQK, int DV>
struct DqCfg : BwdTiles<DQK, DV> {
  using Tiles = BwdTiles<DQK, DV>;
  static constexpr int kThreads = 160;
  static constexpr int kProducerWarp = 4;
  static constexpr uint32_t kOffRing = Tiles::kQk + Tiles::kV;
  static constexpr uint32_t kStageBytes = Tiles::kQk + Tiles::kV;
  static constexpr uint32_t kOffBar = kOffRing + kDqStages * kStageBytes;
  static constexpr uint32_t kSmemBytes = kOffBar + 8 * (1 + 2 * kDqStages) + 1024;
  static constexpr int kMinBlocks = 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;
  static_assert(kSmemBytes <= 232448, "one block must fit an SM's shared memory");
};

// 2^x on the special-function unit; -inf gives 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An m64n64 accumulator as the A fragments of the next wgmma, one term in
// T: consecutive pairs, as to_fragments packs them.
template <typename T>
__device__ __forceinline__ void to_fragments1(const float (&x)[32], uint32_t (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = pack2<T>(x[2 * i], x[2 * i + 1]);
}

// d (64 x N) += A (64 x 64, registers, one term in T) B (64 x N, smem,
// MN-major: a 64-row tile read along its rows), issued and committed, not
// waited.  A's columns 16*kk .. 16*kk + 15 are fragments [4*kk, 4*kk + 4).
template <typename T, int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2], const uint32_t (&a)[16],
                                         uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_rs_tb<T, N>(d, f, desc_sw128(b_base + kk * 16 * kRowBytes, 64 * kRowBytes, 1024));
  }
  wgmma_commit();
}

// Some (q row, key) pair of the 64 x 64 tile at (m0, n0) is masked.
__device__ __forceinline__ bool crosses_edge(const BwdParams& p, int n_valid, int m0, int n0) {
  return n0 + 64 > n_valid || m0 + 64 > p.S || (p.causal && n0 + 63 > m0) ||
         (p.window > 0 && n0 <= m0 + 63 - p.window);
}

// What a dK/dV consumer warpgroup needs of its block.
struct DkdvBlock {
  uint32_t base;       // the aligned shared-memory base: K, then V
  uint32_t ring;       // the ring's first stage
  uint32_t bar_full, bar_free, bar_p;
  const float* stats;  // kDkdvStages x (lse in log2 units, delta)
  uint32_t* pbuf;      // kDkdvStages x P^T fragments
  int n0, kvh, b, n_valid, m_begin, q_tiles, n_iters;
};

// One consumer warpgroup's loop and store.  Warpgroup 0 (WG = 0) computes
// S^T = K Q^T (a depth of DQK) and P^T, hands P^T to warpgroup 1 and
// accumulates dV += P^T dO (N = DV columns); warpgroup 1 computes dP^T =
// V dO^T (a depth of DV), dS^T = P^T (dP^T - delta) and accumulates dK +=
// dS^T Q (N = DQK).  WG = -1: the warpgroup is picked at run time, for DQK
// = DV, where both run the same code and no branch separates a wgmma from
// its wait.  T: bfloat16 or float16.
template <int DQK, int DV, int WG, typename T>
__device__ __forceinline__ void dkdv_consume(const BwdParams& p, const DkdvBlock& k) {
  using Tiles = BwdTiles<DQK, DV>;
  constexpr int kDepth = WG == 1 ? DV : DQK;  // of S^T (0) or dP^T (1)
  constexpr int N = WG == 1 ? DQK : DV;       // columns of dV (0) or dK (1)
  static_assert(WG >= 0 || DQK == DV, "a run-time warpgroup needs one head dim");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = WG >= 0 ? WG : warp / 4;
  const int t = threadIdx.x % 128;
  const int key0 = k.n0 + 16 * (warp % 4) + lane / 4;    // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = p.scale * kLog2e;
  // Every q tile the block walks sees one of its keys (m_begin and m_end
  // are the diagonal's and the window's edges).
  float acc[N / 2];                                        // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  float x[32];                                             // S^T (0) or dP^T (1)
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.f;
  uint32_t frag[16];                                       // P^T (0) or dS^T (1), in T
  mbar_wait(k.base + DkdvCfg<DQK, DV>::kOffBar, 0);        // K and V landed

  for (int i = 0; i < k.n_iters; ++i) {
    const int s = i % kDkdvStages;
    const int m0 = k.m_begin + (i % k.q_tiles) * 64;
    const uint32_t q_base = k.ring + s * DkdvCfg<DQK, DV>::kStageBytes;  // dO at + Tiles::kQk
    uint32_t* pslot = k.pbuf + s * 16 * 128 + t;           // fragment f at pslot[128 f]
    const bool masked = crosses_edge(p, k.n_valid, m0, k.n0);
    mbar_wait(k.bar_full + 8 * s, (i / kDkdvStages) & 1);
    wgmma_fence();
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1).
    issue_qk<T, kDepth>(x, k.base + wg * Tiles::kQk, q_base + wg * Tiles::kQk);
    wgmma_wait<0>();
    fence_regs(x);
    if (wg == 0) {
      // P^T: rows are keys key0 + 8r, columns q rows m0 + 8j + col0 + c.
      const float* lse2 = k.stats + s * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            float pr = ex2_approx(fmaf(x[e], scale_log2, -(c ? l.y : l.x)));
            if (masked && !visible(p, k.n_valid, m0 + 8 * j + col0 + c, key0 + 8 * r)) pr = 0.f;
            x[e] = pr;
          }
      }
      to_fragments1<T>(x, frag);
#pragma unroll
      for (int f = 0; f < 16; ++f) pslot[128 * f] = frag[f];
      mbar_arrive(k.bar_p + 8 * s);
    } else {
      // dS^T = P^T (dP^T - delta), from warpgroup 0's rounded P^T.
      const float* delta = k.stats + s * 128 + 64;
      mbar_wait(k.bar_p + 8 * s, (i / kDkdvStages) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pp = unpack2<T>(pslot[128 * (2 * j + r)]);
          x[4 * j + 2 * r] = pp.x * (x[4 * j + 2 * r] - dl.x);
          x[4 * j + 2 * r + 1] = pp.y * (x[4 * j + 2 * r + 1] - dl.y);
        }
      }
      to_fragments1<T>(x, frag);
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1).
    wgmma_fence();
    issue_rs<T, N>(acc, frag, q_base + (1 - wg) * Tiles::kQk);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(k.bar_free + 8 * s);
  }

  // Warpgroup 0 stores dV, warpgroup 1 dK (scaled).
  const float out_scale = wg == 0 ? 1.f : p.scale;
  T* dst = wg == 0 ? static_cast<T*>(p.dv) + k.b * p.dv_sb + k.kvh * p.dv_sh
                   : static_cast<T*>(p.dk) + k.b * p.dk_sb + k.kvh * p.dk_sh;
  const long long row_stride = wg == 0 ? p.dv_ss : p.dk_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = key0 + 8 * r;
    if (n >= p.T) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int e = 4 * j + 2 * r;
      *reinterpret_cast<Pair<T>*>(dst + n * row_stride + 8 * j + col0) =
          pair2<T>(acc[e] * out_scale, acc[e + 1] * out_scale);
    }
  }
}

// Block (blockIdx.x = kv head + KV*b, blockIdx.y = 64-key tile, the
// longest causal chain first): two consumer warpgroups share the block's 64
// keys and split each q tile's work (dkdv_consume).  Each holds one
// accumulator: 64 x D at DQK = DV = D, so both fit 168 registers; at DQK
// 192, DV 128, dV (64 registers) in warpgroup 0 and dK (96) in warpgroup
// 1, each in a branch of its own.  The producer warp comes last.  T:
// bfloat16 or float16.
template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(DkdvCfg<DQK, DV>::kThreads, 1)
    flash_bwd_dkdv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
  using C = DkdvCfg<DQK, DV>;
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
      mbar_expect_tx(bar_kv, C::kQk + C::kV);
      for (int c = 0; c < DQK / 64; ++c)
        tma_load_4d(base + c * 64 * kRowBytes, &tk, bar_kv, 64 * c, kvh, n0, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load_4d(base + C::kQk + c * 64 * kRowBytes, &tv, bar_kv, 64 * c, kvh, n0, b);
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
        for (int c = 0; c < DQK / 64; ++c)
          tma_load_4d(dst + c * 64 * kRowBytes, &tq, bar_full + 8 * s, 64 * c, hq, m0, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_load_4d(dst + C::kQk + c * 64 * kRowBytes, &tdo, bar_full + 8 * s, 64 * c, hq,
                      m0, b);
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  const DkdvBlock blk{base, base + C::kOffRing, bar_full, bar_free, bar_p, stats, pbuf,
                      n0, kvh, b, n_valid, m_begin, q_tiles, n_iters};
  if constexpr (DQK == DV) {
    dkdv_consume<DQK, DV, -1, T>(p, blk);
  } else if (warp < 4) {
    dkdv_consume<DQK, DV, 0, T>(p, blk);
  } else {
    dkdv_consume<DQK, DV, 1, T>(p, blk);
  }
}

// Block (blockIdx.x = h + H*b, blockIdx.y = 64-row q tile from the last):
// one consumer warpgroup owns the rows, the producer warp comes last.  T:
// bfloat16 or float16.
template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(DqCfg<DQK, DV>::kThreads, DqCfg<DQK, DV>::kMinBlocks)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
  using C = DqCfg<DQK, DV>;
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
      mbar_expect_tx(bar_q, C::kQk + C::kV);
      for (int c = 0; c < DQK / 64; ++c)
        tma_load_4d(base + c * 64 * kRowBytes, &tq, bar_q, 64 * c, h, m0, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load_4d(base + C::kQk + c * 64 * kRowBytes, &tdo, bar_q, 64 * c, h, m0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kDqStages;
        const int n0 = kv_start + i * 64;
        const uint32_t dst = base + C::kOffRing + s * C::kStageBytes;
        if (i >= kDqStages) mbar_wait(bar_free + 8 * s, (i / kDqStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, C::kStageBytes);
        for (int c = 0; c < DQK / 64; ++c)
          tma_load_4d(dst + c * 64 * kRowBytes, &tk, bar_full + 8 * s, 64 * c, kvh, n0, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_load_4d(dst + C::kQk + c * 64 * kRowBytes, &tv, bar_full + 8 * s, 64 * c, kvh,
                      n0, b);
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

  float dq[DQK / 2];
#pragma unroll
  for (int e = 0; e < DQK / 2; ++e) dq[e] = 0.f;
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
    issue_qk<T, DQK>(sc, base, k_stage);                   // S = Q K^T
    issue_qk<T, DV>(dp, base + C::kQk, k_stage + C::kQk);  // dP = dO V^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // dS = P (dP - delta), P rounded to T as the dK/dV kernel rounds it:
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
          pr = round16<T>(pr);
          dp[e] = pr * (dp[e] - delta[r]);
        }
    to_fragments1<T>(dp, dsf);
    wgmma_fence();
    issue_rs<T, DQK>(dq, dsf, k_stage);                    // dQ += dS K
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(bar_free + 8 * s);
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + 8 * r;
    if (m >= p.S) continue;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<Pair<T>*>(dqp + m * p.dq_ss + 8 * j + col0) =
          pair2<T>(dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
  }
}

// delta = rowsum(dO * O) in float32 for each (b, row, h): DV/8 lanes per
// row, each reading 8 adjacent elements of both with one 16-byte load (the
// rows are 16-byte aligned: TMA's rule holds for dO and, as the wrapper
// sees to, for O); the grid strides over the rows.  T: bfloat16 or float16.
template <int DV, typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel_sm90(BwdParams p, long long rows) {
  constexpr int kLanes = DV / 8;
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
          static_cast<const T*>(p.o) + b * p.o_sb + m * p.o_ss + h * p.o_sh + 8 * sub);
      const uint4 gv = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) +
                                                       b * p.do_sb + m * p.do_ss + h * p.do_sh +
                                                       8 * sub);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = unpack2<T>(ow[w]), g = unpack2<T>(gw[w]);
        acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0 && row < rows) p.delta[((long long)b * p.H + h) * p.S + m] = acc;
  }
}

// The delta pre-pass, then the dK/dV and dQ kernels.  Returns a
// cudaError_t, or kTensorMapRejected when q, k, v or dO breaks TMA's rule.
template <int DQK, int DV, typename T>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  using Dkdv = DkdvCfg<DQK, DV>;
  using Dq = DqCfg<DQK, DV>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<T>(encode, &tq, p.q, B, p.S, p.H, DQK, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !make_map<T>(encode, &tk, p.k, B, p.T, p.KV, DQK, p.k_sb, p.k_ss, p.k_sh, 64) ||
      !make_map<T>(encode, &tv, p.v, B, p.T, p.KV, DV, p.v_sb, p.v_ss, p.v_sh, 64) ||
      !make_map<T>(encode, &tdo, p.dout, B, p.S, p.H, DV, p.do_sb, p.do_ss, p.do_sh, 64))
    return kTensorMapRejected;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(flash_bwd_dkdv_kernel_sm90<DQK, DV, T>, Dkdv::kSmemBytes);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel_sm90<DQK, DV, T>, Dq::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)B * p.S * p.H;
  const long long blocks = (rows * (DV / 8) + 255) / 256;  // at most 16 to an SM, striding
  flash_bwd_delta_kernel_sm90<DV, T>
      <<<(unsigned)(blocks < 2112 ? blocks : 2112), 256, 0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv(p.KV * B, (p.T + 63) / 64);
  flash_bwd_dkdv_kernel_sm90<DQK, DV, T><<<grid_kv, Dkdv::kThreads, Dkdv::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q(p.H * B, (p.S + 63) / 64);
  flash_bwd_dq_kernel_sm90<DQK, DV, T><<<grid_q, Dq::kThreads, Dq::kSmemBytes, stream>>>(
      tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// The (Dqk, Dv) instances, which ops.py's HEAD_DIMS lists, in each element
// type this library holds (FLASH_ELEM): bf16 and f16 at (64, 64), (128,
// 128) and (192, 128) (DeepSeek-V2's MLA) on the wgmma kernels, and at the
// reduced configs' head dims, (16, 16) (hymba), (32, 32) (llama3-8b,
// whisper) and (48, 32) (deepseek's MLA), and at (256, 256) on the mma.sync
// kernels; float32 at all seven pairs on the mma.sync kernels.  ops.py pads
// a call's head dims up to the smallest pair that holds them.
template <typename T>
int forward_mma(int dqk, int dv, const Params& p, int B, cudaStream_t s) {
  if (dqk == 16 && dv == 16) return tc::launch_fwd<T, 16, 16>(p, B, s);
  if (dqk == 32 && dv == 32) return tc::launch_fwd<T, 32, 32>(p, B, s);
  if (dqk == 48 && dv == 32) return tc::launch_fwd<T, 48, 32>(p, B, s);
  if (dqk == 256 && dv == 256) return tc::launch_fwd<T, 256, 256>(p, B, s);
  if constexpr (sizeof(T) == 4) {
    if (dqk == 64 && dv == 64) return tc::launch_fwd<T, 64, 64>(p, B, s);
    if (dqk == 128 && dv == 128) return tc::launch_fwd<T, 128, 128>(p, B, s);
    if (dqk == 192 && dv == 128) return tc::launch_fwd<T, 192, 128>(p, B, s);
  } else {
    if (dqk == 64 && dv == 64) return sm90::launch<64, 64, T>(p, B, s);
    if (dqk == 128 && dv == 128) return sm90::launch<128, 128, T>(p, B, s);
    if (dqk == 192 && dv == 128) return sm90::launch<192, 128, T>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int backward_mma(int dqk, int dv, const BwdParams& p, int B, cudaStream_t s) {
  if (dqk == 16 && dv == 16) return tc::launch_bwd<T, 16, 16>(p, B, s);
  if (dqk == 32 && dv == 32) return tc::launch_bwd<T, 32, 32>(p, B, s);
  if (dqk == 48 && dv == 32) return tc::launch_bwd<T, 48, 32>(p, B, s);
  if (dqk == 256 && dv == 256) return tc::launch_bwd<T, 256, 256>(p, B, s);
  if constexpr (sizeof(T) == 4) {
    if (dqk == 64 && dv == 64) return tc::launch_bwd<T, 64, 64>(p, B, s);
    if (dqk == 128 && dv == 128) return tc::launch_bwd<T, 128, 128>(p, B, s);
    if (dqk == 192 && dv == 128) return tc::launch_bwd<T, 192, 128>(p, B, s);
  } else {
    if (dqk == 64 && dv == 64) return sm90::launch_bwd<64, 64, T>(p, B, s);
    if (dqk == 128 && dv == 128) return sm90::launch_bwd<128, 128, T>(p, B, s);
    if (dqk == 192 && dv == 128) return sm90::launch_bwd<192, 128, T>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16, 2 float16; a type this library does not
// hold is cudaErrorInvalidValue.
int forward_instance(int dtype, int dqk, int dv, const Params& p, int B, cudaStream_t s) {
#if FLASH_HAS(0)
  if (dtype == 0) return forward_mma<float>(dqk, dv, p, B, s);
#endif
#if FLASH_HAS(1)
  if (dtype == 1) return forward_mma<__nv_bfloat16>(dqk, dv, p, B, s);
#endif
#if FLASH_HAS(2)
  if (dtype == 2) return forward_mma<__half>(dqk, dv, p, B, s);
#endif
  return (int)cudaErrorInvalidValue;
}

int backward_instance(int dtype, int dqk, int dv, const BwdParams& p, int B, cudaStream_t s) {
#if FLASH_HAS(0)
  if (dtype == 0) return backward_mma<float>(dqk, dv, p, B, s);
#endif
#if FLASH_HAS(1)
  if (dtype == 1) return backward_mma<__nv_bfloat16>(dqk, dv, p, B, s);
#endif
#if FLASH_HAS(2)
  if (dtype == 2) return backward_mma<__half>(dqk, dv, p, B, s);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The entry point's arguments in one block, packed by ops.py as
// struct.Struct("=5Q12qQ11if"): no padding, 192 bytes.  One pointer
// argument keeps the host's cost of a ctypes call small.
//   dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o share
//   it); D and Dv: q's and k's head dim and v's (and o's), one of the
//   instances above.
//   Strides are in elements, (batch, sequence, head) for q, k, v and o in
//   that order; the head dim is contiguous.  q/k/v are taken at 16-byte
//   aligned addresses with 16-byte multiple strides (TMA's rule for the
//   bf16 wgmma instances, cp.async's for the others).
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
  int dtype, B, S, T, H, KV, D, Dv, causal, window, kv_len;
  float scale;
};
static_assert(sizeof(EntryArgs) == 192, "EntryArgs must match ops.py's packing");

// Returns a cudaError_t, or kTensorMapRejected (-1) when q, k or v breaks
// TMA's rule (bfloat16 wgmma) or the 16-byte rule of cp.async (the other
// instances); nothing is launched then.
int flash_attention_forward(const EntryArgs* a) {
  const int B = a->B;
  if (a->KV <= 0 || a->H % a->KV != 0 || B <= 0 || a->S <= 0 || a->T <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* st = a->strides;
  Params p{a->q, a->k, a->v, a->o, a->S, a->T, a->H, a->KV,
           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
           a->causal, a->window, a->kv_len, a->scale, a->lse};
  return forward_instance(a->dtype, a->D, a->Dv, p, B, static_cast<cudaStream_t>(a->stream));
}

// The backward's arguments, packed by ops.py as struct.Struct("=10Q24qQ11if"):
// 328 bytes.  Pointers q, k, v, o, dO (the forward's inputs and output and
// the output's gradient), lse (from the forward), delta (a (B, H, S) float32
// scratch), dq, dk, dv (outputs in q's dtype; dv and o, dO at Dv); strides
// in elements, (batch, sequence, head) for q, k, v, o, dO, dq, dk, dv in
// that order.
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
  int dtype, B, S, T, H, KV, D, Dv, causal, window, kv_len;
  float scale;
};
static_assert(sizeof(BwdEntryArgs) == 328, "BwdEntryArgs must match ops.py's packing");

// Launches the backward's kernels on the stream (the bf16 wgmma instances:
// the delta pre-pass, dK/dV, dQ; the mma.sync ones: dQ, which writes delta,
// then dK/dV); returns the first cudaError_t that is not cudaSuccess, or
// kTensorMapRejected (-1) when q, k, v or dO breaks TMA's rule (bfloat16
// wgmma) or the 16-byte rule of cp.async (the others: 16-byte aligned
// addresses and 16-byte multiple strides); nothing is launched then.
int flash_attention_backward(const BwdEntryArgs* a) {
  const int B = a->B;
  if (a->KV <= 0 || a->H % a->KV != 0 || B <= 0 || a->S <= 0 || a->T <= 0)
    return (int)cudaErrorInvalidValue;
  const long long* st = a->strides;
  BwdParams p{a->q, a->k, a->v, a->o, a->dout, a->lse, a->delta, a->dq, a->dk, a->dv,
              a->S, a->T, a->H, a->KV,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
              st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20], st[21],
              st[22], st[23], a->causal, a->window, a->kv_len, a->scale};
  return backward_instance(a->dtype, a->D, a->Dv, p, B, static_cast<cudaStream_t>(a->stream));
}

}  // extern "C"
