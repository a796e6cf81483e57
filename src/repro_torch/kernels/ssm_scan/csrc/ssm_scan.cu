// Mamba selective scan forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/ssm_scan.py:63 ssm_scan_kernel
//   (body _ssm_kernel; entry ops.py::ssm_scan)
// and computes the same function, per batch row b, channel d and state n,
// with A = -exp(log_a) and a float32 state h:
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] u_t[d]) B_t[n]
//   y_t[d]    = sum_n C_t[n] h_t[d, n]
// u/dt (B,T,D), B/C (B,T,N) and log_a (D,N) are float32; y (B,T,D) and the
// final state (B,D,N) are float32.  N = 16 only; any B, D and T >= 1.
//
// Bound on an H100 SXM (3.35 TB/s): at hymba-1.5b B=1, T=1024, D=3200,
// N=16 the function must read u and dt and write y, about 39.3 MB, plus B,
// C, log_a and the final state, about 0.6 MB: 39.9 MB, 11.9 us.  Its
// 16 T D = 52.4 M decays take 12.5 us at the SFU's 16 exponentials per
// clock and SM (132 SMs at 1.98 GHz), level with the bytes, so each decay
// is computed exactly once here.
//
// Structure.
//   * The grid is sized to the card: a block takes `cb` channels of one
//     batch row, cb = ceil(D / (SMs / B)), so at B=1 and D=3200 the 128
//     blocks of 25 channels each fill 128 of the 132 SMs with equal work,
//     one block per SM (v3: 400 blocks, 3 or 4 to an SM).
//   * Time is split within the block: it walks T in tiles of sb * kSeg
//     steps, and `sb` segments of kSeg = 8 steps each run side by side
//     (sb = 7 at B=1: 7 x 25 x 2 = 350 threads, launched as 352).  Two
//     threads share a (channel, segment), eight states each, so y_t is a
//     sum inside the thread plus one shuffle per two steps, with no
//     per-step butterfly; dt u is formed once per thread and step, and
//     B_t/C_t are 16-byte shared-memory broadcasts.
//   * Pass 1 scans each segment from h = 0 and keeps its 64 decays in
//     registers, with the local y; the segment's total decay P is
//     exp2(A log2(e) * the sum of its dt), one more exponential per state
//     and segment (an eighth of the decays' count).  The carry: each
//     thread folds the state entering the tile through its earlier
//     segments' (P, h) with the reference's combine, (a1 a2, b1 a2 + b2)
//     (models/hymba.py:209), into the state g entering its own segment.
//     Pass 2 runs g through the kept decays (g <- decay g) and adds C_t g
//     to the local y.  No decay is computed twice and no intermediate
//     leaves the SM; the state between tiles stays in shared memory.
//   * Inputs are staged per tile by TMA (one thread issues a 2-D box each
//     for u, dt, B and C; steps past T and channels past D come back as
//     zeros) in a ring of three tiles on mbarriers, so no compute thread
//     spends instructions or queue slots on copies.  Where a base or stride
//     breaks TMA's 16-byte rule the same ring is filled with 4-byte
//     cp.async copies.  A zero step has dt = 0: its decay is exactly 1 (A is
//     kept finite) and it leaves h unchanged.
//   * The decay is exp2(dt * A log2(e)) on the SFU (ex2.approx), log2(e)
//     folded into A once per thread.
//   * Optionally (a call that carries gradients) the state entering every
//     kBwdTile = 64 steps goes to a (B, T / 64, D, N) tensor, which the
//     backward in ssm_scan_backward.cu starts its tiles from: the thread
//     whose segment starts such a tile stores the state g it carried in.
//
// Cost per state update, as compiled (the TMA instance's SASS at the main
// case): about 1,080 warp instructions per thread and 64-update tile plus
// about 22 per earlier segment in the carry, so 17-18 per update: 9.3
// floating-point (1.125 of them exponentials, 59 M at the main case, 14.1
// us at the SFU rate), 1.7 shared-memory loads, 3 integer and 1.6 control
// (v3: about 19, over 400 unevenly placed blocks).  Device traffic is the
// function's 39.9 MB plus B/C re-read from L2 once per block.  Measured on
// the card it runs at about a quarter of the byte bound (PERF.md).
#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;             // state size: the only one taken
constexpr int kLanes = 2;          // threads per (channel, segment)
constexpr int kPer = kN / kLanes;  // states per thread
constexpr int kVec = kPer / 4;     // float4s per thread's states
constexpr int kSeg = 8;            // steps per segment
constexpr int kMaxGroups = 192;    // (channel, segment) groups per block
constexpr int kMaxThreads = kLanes * kMaxGroups;
constexpr int kMaxSegs = 16;       // segments per tile: tiles of at most 128 steps
constexpr int kStages = 3;         // tiles in the ring
constexpr int kMaxChunk = 128;     // the largest chunk the entry takes
constexpr int kBwdTile = 64;       // steps per tile of the backward (kTile there)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* u;
  const float* dt;
  const float* b;
  const float* c;
  const float* log_a;  // (D, N) contiguous
  float* y;            // (B, T, D) contiguous
  float* h;            // (B, D, N) contiguous
  float* tiles;        // (B, ceil(T / kBwdTile), D, N) contiguous, or null
  long long u_sb, u_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;  // 4-byte path only
  int T, D;
  int cb, sb;          // channels per block, segments per tile
};

// Floats per staged row of u or dt.  A TMA box must start on a 16-byte
// boundary, so a row holds columns [d0 & ~3, (d0 & ~3) + box_width): the
// block's channels plus up to 3 to their left, rounded up to 16 bytes.
__host__ __device__ inline int box_width(int cb) { return (cb + 3 + 3) / 4 * 4; }
__host__ __device__ inline int round32(int floats) { return (floats + 31) / 32 * 32; }

// One ring stage, in floats: u and dt as (rows, box_width), then B and C as
// (rows, 16), each region starting on 128 bytes.
struct Stage {
  int u, dt, b, c, floats;
  __host__ __device__ Stage(int cb, int rows) {
    const int ud = round32(rows * box_width(cb));
    const int bc = round32(rows * kN);
    u = 0;
    dt = ud;
    b = 2 * ud;
    c = 2 * ud + bc;
    floats = 2 * ud + 2 * bc;
  }
};

// Threads per block: a pair per (channel, segment), rounded up to whole
// warps (the spare threads compute nothing; TMA is issued from full warps).
__host__ __device__ inline int block_threads(int cb, int sb) {
  return (kLanes * cb * sb + 31) / 32 * 32;
}

// Shared memory in bytes: the ring, the segments' (P, h) twice, the carry
// twice, and one mbarrier per stage.
__host__ __device__ inline int smem_bytes(int cb, int sb) {
  const int threads = block_threads(cb, sb);
  const int agg = 2 * 2 * kVec * 4 * threads;    // (P, h) per thread, two tiles
  const int carry = 2 * kVec * 4 * kLanes * cb;  // two tiles
  const int floats = kStages * Stage(cb, sb * kSeg).floats + agg + carry;
  return 4 * floats + 8 * kStages + 128;  // + 128: the base is aligned up to 128 bytes
}

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

// Wait until the barrier's phase of parity `parity` has completed.  A phase
// that never completes is a bug: trap after about 2^34 cycles instead of
// hanging the card.
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

// One box of a 3-D map {inner, T, B} into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The four tensor maps, by address: each must stay in the kernel's
// parameter space (a __grid_constant__ parameter of its own).
struct Maps {
  const CUtensorMap *u, *dt, *b, *c;
};

// Stage time steps [t0, t0 + rows) of columns [a0, a0 + box_width) into `buf`.
// TMA: one thread, completing on `bar`.  Otherwise every thread issues
// 4-byte copies (zero-filled past T and D) as one cp.async group.
template <bool kTma>
__device__ __forceinline__ void load_tile(const Params& p, const Maps& maps, float* buf,
                                          uint32_t bar, int bidx, int a0, int t0) {
  const int cb = p.cb, rows = p.sb * kSeg, W = box_width(cb);
  const Stage st(cb, rows);
  if constexpr (kTma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, 4u * static_cast<uint32_t>(2 * rows * W + 2 * rows * kN));
      tma_load_3d(smem_u32(buf + st.u), maps.u, bar, a0, t0, bidx);
      tma_load_3d(smem_u32(buf + st.dt), maps.dt, bar, a0, t0, bidx);
      tma_load_3d(smem_u32(buf + st.b), maps.b, bar, 0, t0, bidx);
      tma_load_3d(smem_u32(buf + st.c), maps.c, bar, 0, t0, bidx);
    }
  } else {
    const float* u = p.u + bidx * p.u_sb;
    const float* dt = p.dt + bidx * p.dt_sb;
    const float* b = p.b + bidx * p.b_sb;
    const float* c = p.c + bidx * p.c_sb;
    for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
      const int r = idx / W, col = idx % W;
      const int t = t0 + r, d = a0 + col;
      const bool ok = t < p.T && d < p.D;
      cp_async4(buf + st.u + idx, ok ? u + t * p.u_st + d : p.u, ok);
      cp_async4(buf + st.dt + idx, ok ? dt + t * p.dt_st + d : p.dt, ok);
    }
    for (int idx = threadIdx.x; idx < rows * kN; idx += blockDim.x) {
      const int r = idx / kN, n = idx % kN;
      const int t = t0 + r;
      const bool ok = t < p.T;
      cp_async4(buf + st.b + idx, ok ? b + t * p.b_st + n : p.b, ok);
      cp_async4(buf + st.c + idx, ok ? c + t * p.c_st + n : p.c, ok);
    }
    cp_async_commit();
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ssm_scan_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tdt,
                    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // TMA writes boxes to 128-byte aligned shared memory.
  float* smem = reinterpret_cast<float*>(smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u));
  const Maps maps{&tu, &tdt, &tb, &tc};
  const int cb = p.cb, sb = p.sb, rows = sb * kSeg, W = box_width(cb);
  const int nthreads = blockDim.x;  // block_threads(cb, sb)
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;    // states kPer * lane .. kPer * lane + kPer - 1
  const int group = tid / kLanes;   // one (channel, segment)
  const bool active = group < cb * sb;
  const int s = active ? group / cb : 0;   // segment within the tile
  const int ch = active ? group % cb : 0;  // channel within the block
  const int d0 = blockIdx.x * cb;
  const int a0 = d0 & ~3;           // the first staged column
  const int col = d0 - a0 + ch;     // this channel's column in a staged row
  const int d = d0 + ch;
  const int bidx = blockIdx.y;
  const bool valid = active && d < p.D;

  const Stage st(cb, rows);
  // The segments' (P, h), [2][2 kVec][threads], and the carry, [2][kVec][kLanes cb].
  float4* agg = reinterpret_cast<float4*>(smem + kStages * st.floats);
  float4* carry = agg + 2 * 2 * kVec * nthreads;
  const uint32_t bars = smem_u32(carry + 2 * kVec * kLanes * cb);
  const int slot = kLanes * ch + lane;  // this thread's place in a carry row

  // A log2(e), finite even where exp(log_a) overflows: a zero-filled step
  // (dt = 0) then has decay exactly 1 instead of meeting 0 * inf.
  float a2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    a2[i] = valid ? fmaxf(-expf(p.log_a[d * kN + kPer * lane + i]) * kLog2e, -FLT_MAX) : 0.f;

  if (active && s == 0) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) carry[v * kLanes * cb + slot] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_tiles = (p.T + rows - 1) / rows;
  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles)
      load_tile<kTma>(p, maps, smem + k * st.floats, bars + 8 * k, bidx, a0, k * rows);
    else if constexpr (!kTma)
      cp_async_commit();  // an empty group keeps the group count per tile
  }
  float* y_out = p.y + (long long)bidx * p.T * p.D + d;

  for (int k = 0; k < n_tiles; ++k) {
    const int stage = k % kStages;
    const float* buf = smem + stage * st.floats;
    if constexpr (kTma) {
      mbar_wait(bars + 8 * stage, (k / kStages) & 1);
    } else {
      cp_async_wait<kStages - 2>();
      __syncthreads();
    }
    const float* us = buf + st.u + s * kSeg * W + col;
    const float* dts = buf + st.dt + s * kSeg * W + col;
    const float4* bs = reinterpret_cast<const float4*>(buf + st.b) + s * kSeg * 4 + kVec * lane;
    const float4* cs = reinterpret_cast<const float4*>(buf + st.c) + s * kSeg * 4 + kVec * lane;

    // Pass 1: the segment from h = 0; its decays kept in registers.  The
    // segment's total decay P is exp2(A log2(e) * the sum of its dt): one
    // exponential per state and segment instead of a product per step.
    float h[kPer], P[kPer], e[kSeg][kPer], yl[kSeg];
    float dt_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) h[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const float dtj = dts[j * W];
      const float du = dtj * us[j * W];
      dt_sum += dtj;
      float bv[kPer], cv[kPer];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 b4 = bs[j * 4 + v], c4 = cs[j * 4 + v];
        bv[4 * v] = b4.x; bv[4 * v + 1] = b4.y; bv[4 * v + 2] = b4.z; bv[4 * v + 3] = b4.w;
        cv[4 * v] = c4.x; cv[4 * v + 1] = c4.y; cv[4 * v + 2] = c4.z; cv[4 * v + 3] = c4.w;
      }
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        e[j][i] = fast_exp2(dtj * a2[i]);
        h[i] = fmaf(e[j][i], h[i], du * bv[i]);
        acc[i & 1] = fmaf(cv[i], h[i], acc[i & 1]);
      }
      yl[j] = acc[0] + acc[1];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) P[i] = fast_exp2(dt_sum * a2[i]);
    float4* agg_k = agg + (k & 1) * 2 * kVec * nthreads;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      agg_k[v * nthreads + tid] = make_float4(P[4 * v], P[4 * v + 1], P[4 * v + 2], P[4 * v + 3]);
      agg_k[(kVec + v) * nthreads + tid] =
          make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
    }
    __syncthreads();  // every segment's (P, h) is in shared memory

    // Stage `stage - 1` was last read by tile k - 1, which every thread has
    // finished: refill it with tile k + kStages - 1.
    if (k + kStages - 1 < n_tiles) {
      const int next = (k + kStages - 1) % kStages;
      load_tile<kTma>(p, maps, smem + next * st.floats, bars + 8 * next, bidx, a0,
                      (k + kStages - 1) * rows);
    } else if constexpr (!kTma) {
      cp_async_commit();
    }

    // The carry: the state entering the tile, folded through this
    // channel's earlier segments, is the state g entering this segment.
    float g[kPer];
    const float4* cin = carry + (k & 1) * kVec * kLanes * cb + slot;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const float4 x = cin[v * kLanes * cb];
      g[4 * v] = x.x; g[4 * v + 1] = x.y; g[4 * v + 2] = x.z; g[4 * v + 3] = x.w;
    }
    for (int sp = 0; sp < s; ++sp) {
      const int other = kLanes * (sp * cb + ch) + lane;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 pa = agg_k[v * nthreads + other], hb = agg_k[(kVec + v) * nthreads + other];
        g[4 * v] = fmaf(pa.x, g[4 * v], hb.x);
        g[4 * v + 1] = fmaf(pa.y, g[4 * v + 1], hb.y);
        g[4 * v + 2] = fmaf(pa.z, g[4 * v + 2], hb.z);
        g[4 * v + 3] = fmaf(pa.w, g[4 * v + 3], hb.w);
      }
    }
    if (p.tiles && valid && (k * rows + s * kSeg) % kBwdTile == 0 && k * rows + s * kSeg < p.T) {
      float4* out = reinterpret_cast<float4*>(
          p.tiles + (((long long)bidx * ((p.T + kBwdTile - 1) / kBwdTile) +
                      (k * rows + s * kSeg) / kBwdTile) * p.D + d) * kN) + kVec * lane;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        out[v] = make_float4(g[4 * v], g[4 * v + 1], g[4 * v + 2], g[4 * v + 3]);
    }
    if (active && s == sb - 1) {  // the state leaving the tile
      float4* cout = carry + ((k + 1) & 1) * kVec * kLanes * cb + slot;
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        cout[v * kLanes * cb] = make_float4(
            fmaf(P[4 * v], g[4 * v], h[4 * v]), fmaf(P[4 * v + 1], g[4 * v + 1], h[4 * v + 1]),
            fmaf(P[4 * v + 2], g[4 * v + 2], h[4 * v + 2]),
            fmaf(P[4 * v + 3], g[4 * v + 3], h[4 * v + 3]));
    }

    // Pass 2: g through the kept decays; y = local y + C_t g over the
    // thread's states.  Then a reduce-scatter over the kLanes threads of
    // the (channel, segment) sums the 16 states: each round a thread sends
    // its partner the half of its steps the partner keeps.
    float yv[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      float cv[kPer];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float4 c4 = cs[j * 4 + v];
        cv[4 * v] = c4.x; cv[4 * v + 1] = c4.y; cv[4 * v + 2] = c4.z; cv[4 * v + 3] = c4.w;
      }
      float acc[2] = {yl[j], 0.f};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        g[i] *= e[j][i];
        acc[i & 1] = fmaf(cv[i], g[i], acc[i & 1]);
      }
      yv[j] = acc[0] + acc[1];
    }
    int first = 0;  // the first of the steps this thread keeps
#pragma unroll
    for (int bit = kLanes / 2, n = kSeg / 2; bit >= 1; bit /= 2, n /= 2) {
      const bool upper = lane & bit;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float send = upper ? yv[i] : yv[i + n];
        yv[i] = (upper ? yv[i + n] : yv[i]) + __shfl_xor_sync(0xffffffffu, send, bit);
      }
      if (upper) first += n;
    }
#pragma unroll
    for (int i = 0; i < kSeg / kLanes; ++i) {
      const int t = k * rows + s * kSeg + first + i;
      if (valid && t < p.T) y_out[(long long)t * p.D] = yv[i];
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  __syncthreads();  // the last tile's carry is written
  if (valid && s == 0) {
    const float4* fin = carry + (n_tiles & 1) * kVec * kLanes * cb + slot;
    float4* hout = reinterpret_cast<float4*>(p.h + ((long long)bidx * p.D + d) * kN) + kVec * lane;
#pragma unroll
    for (int v = 0; v < kVec; ++v) hout[v] = fin[v * kLanes * cb];
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

// A float32 (B, T, inner) tensor, strides in elements, as the 3-D map
// {inner, T, B} with box {box_inner, rows, 1}.  A dimension of size 1 is
// never stepped; it gets the extent of the dimensions inside it as its
// stride, which TMA accepts whatever the tensor's own stride there is.
// False where TMA refuses the layout (a base or stride off 16 bytes).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int T, int inner,
              long long sb, long long st, int box_inner, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)T, (cuuint64_t)B};
  const long long elem_strides[2] = {st, sb};
  cuuint64_t strides[2];
  cuuint64_t extent = 4ull * inner;
  for (int i = 0; i < 2; ++i) {
    strides[i] = dims[i + 1] == 1 ? extent : 4ull * (cuuint64_t)elem_strides[i];
    if (strides[i] * dims[i + 1] > extent) extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)rows, 1};
  const cuuint32_t elem_step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, elem_step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTma>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, dim3 grid, int threads,
                   int bytes, cudaStream_t stream) {
  static bool configured[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(ssm_scan_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  ssm_scan_kernel<kTma><<<grid, threads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The entry's argument block, packed by ops.py.
struct EntryArgs {
  const void* in[4];      // u, dt, b, c: last dim contiguous
  const void* log_a;      // (D, N) contiguous
  void* y;                // (B, T, D) contiguous
  void* h;                // (B, D, N) contiguous
  void* tiles;            // (B, ceil(T / 64), D, N) contiguous, or null
  long long strides[8];   // (batch, time) of u, dt, b, c, in elements
  void* stream;
  int B, T, D, N, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 160, "EntryArgs must match ops.py's packing");

// Launches the scan; returns the first non-zero cudaError_t (0 on success).
int ssm_scan_forward(const EntryArgs* a) {
  if (a->N != kN || a->B <= 0 || a->T <= 0 || a->D <= 0 || a->chunk <= 0 ||
      a->chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int sm_count[64] = {0};
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Blocks per batch row such that the grid fills the SMs once; the
  // channels per block follow, and the segments fill the block.
  const int per_row = sm_count[dev] / a->B > 1 ? sm_count[dev] / a->B : 1;
  int cb = (a->D + per_row - 1) / per_row;
  if (cb > kMaxGroups) cb = kMaxGroups;
  int sb = kMaxGroups / cb;
  if (sb > kMaxSegs) sb = kMaxSegs;
  const int rows = sb * kSeg;

  const long long* st = a->strides;
  const Params p{static_cast<const float*>(a->in[0]), static_cast<const float*>(a->in[1]),
                 static_cast<const float*>(a->in[2]), static_cast<const float*>(a->in[3]),
                 static_cast<const float*>(a->log_a), static_cast<float*>(a->y),
                 static_cast<float*>(a->h), static_cast<float*>(a->tiles),
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 a->T, a->D, cb, sb};
  const dim3 grid((a->D + cb - 1) / cb, a->B);
  const int threads = block_threads(cb, sb);
  const int bytes = smem_bytes(cb, sb);
  const cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  CUtensorMap maps[4];  // u, dt, b, c
  EncodeTiled encode = encode_tiled();
  const int W = box_width(cb);
  const bool tma =
      encode != nullptr &&
      make_map(encode, &maps[0], a->in[0], a->B, a->T, a->D, st[0], st[1], W, rows) &&
      make_map(encode, &maps[1], a->in[1], a->B, a->T, a->D, st[2], st[3], W, rows) &&
      make_map(encode, &maps[2], a->in[2], a->B, a->T, kN, st[4], st[5], kN, rows) &&
      make_map(encode, &maps[3], a->in[3], a->B, a->T, kN, st[6], st[7], kN, rows);
  err = tma ? launch<true>(maps, p, grid, threads, bytes, stream)
            : launch<false>(maps, p, grid, threads, bytes, stream);
  return static_cast<int>(err);
}

}  // extern "C"
