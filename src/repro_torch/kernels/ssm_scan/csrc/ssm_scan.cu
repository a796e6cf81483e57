// Mamba selective scan forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_kernel
//   (body _ssm_kernel; entry ops.py::ssm_scan)
// and computes the same function, per batch row b, channel d and state n,
// with A = -exp(log_a) and a float32 state h:
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] u_t[d]) B_t[n]
//   y_t[d]    = sum_n C_t[n] h_t[d, n]
// u/dt (B,T,D), B/C (B,T,N) and log_a (D,N) are float32; y (B,T,D) and the
// final state (B,D,N) are float32.  N = 16 only; any D, any T >= 1.
//
// What it does differently from the TPU kernel:
//   * The TPU grid (B, D/d_block, chunks) runs its chunk axis in order and
//     keeps a (d_block, N) state tile in VMEM, advancing it one step at a
//     time across the whole tile on the VPU.  On Hopper one thread per
//     channel would give only B*D threads (3,200 at hymba-1.5b's B=1) for
//     132 SMs.  Here one lane holds one (channel, state) pair: 16 lanes per
//     channel keep h in a register, A = -exp(log_a) is computed once per
//     lane, and time is a loop inside the block.  A block of 128 threads
//     holds 8 channels, so hymba-1.5b at B=1 runs 400 blocks, all resident
//     at once (3 or 4 per SM).
//   * y_t is a sum over a channel's 16 lanes.  The lanes run 16 steps with
//     no cross-lane traffic and no store, keeping h_t C_t for each in
//     registers, and then one butterfly reduce-scatter (15 shuffles)
//     leaves lane n holding y at the group's step n.  Reducing every step
//     instead (four shuffles and a store per step) took about twice as
//     long at the main case (PERF.md).
//   * Each time tile (the chunk) of (u, dt) for the block's channels and
//     of (B, C) (shared by every channel) is staged in shared memory as
//     interleaved pairs, with 4-byte cp.async copies read through the
//     inputs' strides; the next tile is copied into a second buffer while
//     the current one computes.
//   * Any D: the last channel tile is masked (zero-filled, never written).
//     Any T: tiles are zero-filled past T and past the chunk up to a
//     whole group of 16 rows, with no padding copies.  A zero row has
//     dt = 0, so it leaves h exactly as it is (A is kept finite) and the
//     final state equals the padded form's; its y is not stored.
//   * expf, not __expf: the accurate exponential keeps the 1e-5 tolerance.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 off the tensor
// cores): at hymba-1.5b B=1, T=1024, D=3200, N=16 the function must read
// u and dt and write y, about 39.3 MB, plus B, C, log_a and the final
// state, about 0.6 MB: 39.9 MB, about 11.9 us.  Its 16 T D = 52.4 M
// state updates of about seven float32 operations each (the exponential
// counted as one) are 0.37 GFLOP, about 5.5 us at the float32 rate, so
// bytes bind; at the SFU's 16 exponentials per clock
// and SM (132 SMs at 1.98 GHz, 4.2 T/s) the exponentials alone take about
// 12.5 us, level with the bytes.
//
// What this design does about that bound: every lane streams its inputs
// from shared memory once and keeps its state in a register, so device
// memory sees each input once, and a group's 16 steps share nothing but
// h, so their loads and exponentials overlap.  It is still far from the
// bound: each step spends an accurate expf (about nine instructions) and
// two 8-byte shared-memory loads per lane, the lane's loop is sequential in
// time, and at B=1 the 400 blocks fill the SMs unevenly (3 or 4 each).  A
// chunk-parallel two-pass scan is later work.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;                     // state size: the only one taken
constexpr int kChannels = 8;               // channels per block
constexpr int kThreads = kN * kChannels;   // 128
constexpr int kMaxChunk = 128;             // time steps per staged tile
constexpr int kGroup = 16;                 // steps reduced together (= kN)
// One buffer row: (u, dt) pairs for the block's channels and (B, C) pairs
// for the states.
constexpr int kRowFloats = 2 * kChannels + 2 * kN;

struct Params {
  const float* u;
  const float* dt;
  const float* b;
  const float* c;
  const float* log_a;  // (D, N) contiguous
  float* y;            // (B, T, D) contiguous
  float* h;            // (B, D, N) contiguous
  int T, D, C;
  long long u_sb, u_st;
  long long dt_sb, dt_st;
  long long b_sb, b_st;
  long long c_sb, c_st;
};

// Tile rows: the chunk rounded up to whole groups of kGroup steps.
__host__ __device__ inline int tile_rows(int C) { return (C + kGroup - 1) / kGroup * kGroup; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_size = valid ? 4 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy time steps [t0, t0 + C) of the block's channels into one buffer of
// tile_rows(C) rows: ud (rows, kChannels, 2) and bc (rows, kN, 2).  Rows at
// or past C, or past T, and channels past D read as 0.
__device__ __forceinline__ void load_tile(const Params& p, int bidx, int d0, int t0, float* buf) {
  const int C = p.C;
  const int rows = tile_rows(C);
  float* ud = buf;
  float* bc = ud + rows * 2 * kChannels;
  const float* u = p.u + bidx * p.u_sb;
  const float* dt = p.dt + bidx * p.dt_sb;
  const float* b = p.b + bidx * p.b_sb;
  const float* c = p.c + bidx * p.c_sb;
  for (int idx = threadIdx.x; idx < rows * kChannels; idx += kThreads) {
    const int r = idx / kChannels, ch = idx % kChannels;
    const int t = t0 + r, d = d0 + ch;
    const bool ok = r < C && t < p.T && d < p.D;
    cp_async4(ud + 2 * idx, ok ? u + t * p.u_st + d : p.u, ok);
    cp_async4(ud + 2 * idx + 1, ok ? dt + t * p.dt_st + d : p.dt, ok);
  }
  for (int idx = threadIdx.x; idx < rows * kN; idx += kThreads) {
    const int r = idx / kN, n = idx % kN;
    const int t = t0 + r;
    const bool ok = r < C && t < p.T;
    cp_async4(bc + 2 * idx, ok ? b + t * p.b_st + n : p.b, ok);
    cp_async4(bc + 2 * idx + 1, ok ? c + t * p.c_st + n : p.c, ok);
  }
  cp_async_commit();
}

// One butterfly stage over lanes n and n ^ HALF: each keeps the half of
// the HALF * 2 step sums it owns and adds its partner's copy of it.
template <int HALF>
__device__ __forceinline__ void reduce_stage(float (&part)[kGroup], int lane_n) {
  const bool upper = lane_n & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? part[j] : part[j + HALF];
    const float keep = upper ? part[j + HALF] : part[j];
    part[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Lane n of a channel's 16 holds part[j] = h_{s0+j}[n] * C_{s0+j}[n] for 16
// steps j.  Four butterfly stages (8 + 4 + 2 + 1 shuffles) leave it holding
// y at step s0 + n, the sum over the 16 lanes.
__device__ __forceinline__ float reduce_scatter16(float (&part)[kGroup], int lane_n) {
  reduce_stage<8>(part, lane_n);
  reduce_stage<4>(part, lane_n);
  reduce_stage<2>(part, lane_n);
  reduce_stage<1>(part, lane_n);
  return part[0];
}

__global__ void __launch_bounds__(kThreads, 4) ssm_scan_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int C = p.C;
  const int rows = tile_rows(C);
  const int lane_n = threadIdx.x % kN;      // state index
  const int ch = threadIdx.x / kN;          // channel within the block
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const int bidx = blockIdx.y;
  const bool valid = d < p.D;

  // Finite even where exp(log_a) overflows: a zero-filled step (dt = 0)
  // then leaves h exactly unchanged instead of meeting 0 * inf.
  const float a = valid ? fmaxf(-expf(p.log_a[d * kN + lane_n]), -FLT_MAX) : 0.f;
  float h = 0.f;
  float* y = p.y + (long long)bidx * p.T * p.D + d;

  const int buf_floats = rows * kRowFloats;
  load_tile(p, bidx, d0, 0, smem);
  for (int t0 = 0, i = 0; t0 < p.T; t0 += C, ++i) {
    const float* cur = smem + (i & 1) * buf_floats;
    if (t0 + C < p.T) {
      load_tile(p, bidx, d0, t0 + C, smem + ((i + 1) & 1) * buf_floats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the current tile is in shared memory for every thread

    const float2* ud = reinterpret_cast<const float2*>(cur);
    const float2* bc = reinterpret_cast<const float2*>(cur + rows * 2 * kChannels);
    const int steps = min(C, p.T - t0);
    // Whole groups of 16 steps: the rows past `steps` are zero-filled, so
    // they leave h as it is and their y is not stored.
    for (int s0 = 0; s0 < steps; s0 += kGroup) {
      float part[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float2 x = ud[(s0 + j) * kChannels + ch];   // (u, dt)
        const float2 w = bc[(s0 + j) * kN + lane_n];      // (B, C)
        h = expf(x.y * a) * h + (x.y * x.x) * w.x;
        part[j] = h * w.y;
      }
      const float y_t = reduce_scatter16(part, lane_n);
      if (valid && s0 + lane_n < steps) y[(long long)(t0 + s0 + lane_n) * p.D] = y_t;
    }
    __syncthreads();  // every thread is done with cur before it is refilled
  }
  if (valid) p.h[((long long)bidx * p.D + d) * kN + lane_n] = h;
}

}  // namespace

extern "C" {

// Strides are in elements; the last dim of u, dt, b and c is contiguous,
// log_a is a contiguous (D, 16), y and h are written contiguous.  Returns
// a cudaError_t.
int ssm_scan_forward(const void* u, const void* dt, const void* b, const void* c,
                     const void* log_a, void* y, void* h,
                     int B, int T, int D, int N, int chunk,
                     long long u_sb, long long u_st, long long dt_sb, long long dt_st,
                     long long b_sb, long long b_st, long long c_sb, long long c_st,
                     void* stream) {
  if (N != kN || B <= 0 || T <= 0 || D <= 0 || chunk <= 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(u), static_cast<const float*>(dt),
           static_cast<const float*>(b), static_cast<const float*>(c),
           static_cast<const float*>(log_a), static_cast<float*>(y), static_cast<float*>(h),
           T, D, chunk, u_sb, u_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st};
  static bool configured = false;
  if (!configured) {
    const int max_bytes = static_cast<int>(2 * tile_rows(kMaxChunk) * kRowFloats * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const size_t bytes = 2 * static_cast<size_t>(tile_rows(chunk)) * kRowFloats * sizeof(float);
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  ssm_scan_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
