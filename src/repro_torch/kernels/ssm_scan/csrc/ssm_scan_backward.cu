// Mamba selective scan backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// The gradient of the forward in ssm_scan.cu (which replaces the Pallas TPU
// kernel src/repro/kernels/ssm_scan/ssm_scan.py:63 ssm_scan_kernel; the
// reference differentiates its plain chunked scan).  Per batch row b,
// channel d and state n, with A = -exp(log_a), a_t = exp(dt_t A), x_t =
// dt_t u_t, h_t = a_t h_{t-1} + x_t B_t from h = 0, and Gh_t = dL/dh_t =
// dy_t C_t + a_{t+1} Gh_{t+1} starting from the final state's gradient
// (zero when none is given):
//   dC_t[n]   = sum_d dy_t[d] h_t[d, n]
//   dB_t[n]   = sum_d Gh_t[d, n] x_t[d]
//   du_t[d]   = dt_t[d] sum_n Gh_t[d, n] B_t[n]
//   ddt_t[d]  = u_t[d] sum_n Gh_t B_t + sum_n Gh_t h_{t-1} a_t A
//   dlog_a    = A sum_{b,t} Gh_t h_{t-1} a_t dt_t
// u/dt/dy (B,T,D) and B/C (B,T,N) are float32, read in place through their
// (batch, time) strides with the last dim contiguous (any alignment);
// log_a (D,N) and the final state's gradient (B,D,N) contiguous.  N = 16
// only, as the forward.
//
// Bound on an H100 SXM at one node's training slice of hymba-1.5b (B=40,
// T=512, D=3200, N=16): the function reads u, dt and dy and writes du and
// ddt, 5 x 262.1 MB = 1.31 GB, 0.39 ms at 3.35 TB/s (B, C, dB and dC add
// 5.2 MB); its recurrences do about 16 operations per (b, t, d, n) with an
// exponential, 16.8 GFLOP, 0.25 ms at the float32 rate: bound by bytes.
//
// Design (v2; v1 walked all T steps in order, one 256-thread block a SM at
// 238 registers, through a 524 MB checkpoint of every 8-step segment's
// state).  Both recurrences are linear with the same decays, so time is cut
// into segments of kSeg = 8 steps that run side by side, as in the forward
// (plain form: ref.py::ssm_scan_backward_segments):
//   * A block is one batch row and kBlockChannels = 128 channels: 256
//     threads, warp w = segment w of a tile of kSegs * kSeg = 64 steps,
//     lane = 8 channels x 4 threads of 4 states each.  The block walks its
//     channels 8 at a time (a sub-block); every input of a sub-block's tile
//     is staged in shared memory by 4-byte cp.async (zero past T and D,
//     where dt = 0 makes the step an identity), the next one while this one
//     computes.
//   * The state entering each tile comes from the forward, which keeps it
//     under autograd (ssm_scan.cu; B x T / 64 x D x N, 65.5 MB at the
//     training slice, where v1's checkpoint of every 8-step segment was
//     524 MB).
//   * Tiles backward: each segment runs from zero, keeping its 8 x 4
//     decays in registers, the product P of its decays (the running
//     product of the per-step decays, as ref.py's form), its local end
//     state and its local left-exit gradient gl = sum_j (a_0 ... a_j) dy_j
//     C_j; the state entering it is folded from the tile's entering state
//     through the earlier segments, h_in <- P h_in + h, and the gradient
//     arriving at its right end backward, g_in <- P g_in + gl, from the
//     tile's
//     right-hand carry (the final state's gradient for the last tile).  It
//     then runs its true states forward through the kept decays (into
//     shared memory, which keeps the kernel at 128 registers, two blocks an
//     SM) and walks back forming every output; segment 0's walk leaves the
//     tile's left-exit gradient for the tile before it.
//   * du and ddt sum a step's 16 states over the four threads of a channel
//     (two shuffles each).  dB and dC sum over the 8 channels of a warp (a
//     reduce-scatter a step) and over the block's sub-blocks in registers,
//     so each block writes one partial per (b, t) and slot; dlog_a's block
//     part sums in shared memory; the reduce kernel sums the blocks'
//     partials and dlog_a's batch rows, each in a fixed order.  No float
//     atomics anywhere: two calls give the same bits.
//   * 2 kernels a call: ssm_bwd_kernel, ssm_bwd_reduce_kernel.  The design's
//     own bytes at the training slice: u, dt, dy, du and ddt once (1.31
//     GB), the tile states (0.07 GB) and the blocks' partials (0.13 GB);
//     the right-hand carries stay in shared memory.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;             // state size: the only one taken
constexpr int kLanes = 4;          // threads per (channel, segment)
constexpr int kPer = kN / kLanes;  // states per thread
constexpr int kSeg = 8;            // steps per segment
constexpr int kSegs = 8;           // segments per tile: one per warp
constexpr int kTile = kSeg * kSegs;
constexpr int kSub = 8;            // channels per sub-block: the lanes of a warp / kLanes
constexpr int kThreads = 32 * kSegs;
constexpr int kBlockChannels = 128;
constexpr int kSlots = 2 * kN;     // dB then dC per (b, t)
constexpr int kMaxChunk = 128;     // the forward's limit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const float* u;
  const float* dt;
  const float* b;
  const float* c;
  const float* dy;
  const float* log_a;  // (D, N)
  const float* dh;     // (B, D, N) or null
  float* du;           // (B, T, D) contiguous, as is ddt
  float* ddt;
  float* db;           // (B, T, N) contiguous, as is dc
  float* dc;
  float* dlog_a;       // (D, N)
  const float* tiles;  // (B, n_tiles, D, N): the state entering each tile
  float* part_bc;      // (B, T, n_blocks, 2N): per block, dB then dC
  float* part_a;       // (B, D, N): dlog_a per batch row
  long long u_sb, u_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st, dy_sb, dy_st;
  int B, T, D, n_tiles, n_blocks;
};

// Shared memory: two stages of a sub-block's tile (dt, u, dy, 0 per (step,
// channel)), log_a rows and entering states, two tiles of B and C (by tile
// parity), the segments' (P, h, gl), each thread's true states over its
// segment, dlog_a's per-segment parts, and per channel of the block the
// gradient carried into the tile from its right and dlog_a over the tiles
// so far.
struct Smem {
  float4 uvd[2][kTile][kSub];
  float la[2][kSub][kN];
  float hin[2][kSub][kN];
  float bc[2][kTile][kSlots];
  float4 agg[3][kSegs][32];
  float4 hs[kSegs][kSeg][32];
  float4 red[kSegs][32];
  float carry[kBlockChannels][kN];
  float acc_a[kBlockChannels][kN];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage the sub-block of kSub channels from d0 of tile k (steps k * kTile
// ..): dt, u and dy into uvd[stage], log_a's rows into la[stage].  Zero
// past T and D.
__device__ __forceinline__ void load_sub(const Params& p, Smem& sm, int stage, int bidx, int d0,
                                         int k) {
  for (int idx = threadIdx.x; idx < kTile * kSub; idx += kThreads) {
    const int j = idx / kSub, ch = idx % kSub;
    const int t = k * kTile + j, d = d0 + ch;
    const bool ok = t < p.T && d < p.D;
    float* dst = reinterpret_cast<float*>(&sm.uvd[stage][j][ch]);
    cp_async4(dst, ok ? p.dt + bidx * p.dt_sb + t * p.dt_st + d : p.dt, ok);
    cp_async4(dst + 1, ok ? p.u + bidx * p.u_sb + t * p.u_st + d : p.u, ok);
    cp_async4(dst + 2, ok ? p.dy + bidx * p.dy_sb + t * p.dy_st + d : p.dy, ok);
  }
  if (threadIdx.x < kSub * kN) {
    const int ch = threadIdx.x / kN, n = threadIdx.x % kN, d = d0 + ch;
    cp_async4(&sm.la[stage][ch][n], d < p.D ? p.log_a + d * kN + n : p.log_a, d < p.D);
    cp_async4(&sm.hin[stage][ch][n],
              d < p.D ? p.tiles + (((long long)bidx * p.n_tiles + k) * p.D + d) * kN + n : p.log_a,
              d < p.D);
  }
}

// Stage tile k's B and C into bc[k & 1].
__device__ __forceinline__ void load_bc(const Params& p, Smem& sm, int bidx, int k) {
  for (int idx = threadIdx.x; idx < kTile * kN; idx += kThreads) {
    const int j = idx / kN, n = idx % kN;
    const int t = k * kTile + j;
    const bool ok = t < p.T;
    cp_async4(&sm.bc[k & 1][j][n], ok ? p.b + bidx * p.b_sb + t * p.b_st + n : p.b, ok);
    cp_async4(&sm.bc[k & 1][j][kN + n], ok ? p.c + bidx * p.c_sb + t * p.c_st + n : p.c, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void to_array(const float4 v, float (&a)[kPer]) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

__device__ __forceinline__ float4 to_float4(const float (&a)[kPer]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}

// x <- P x + y over the thread's states, with (P, y) from shared memory.
__device__ __forceinline__ void fold(float (&x)[kPer], const float4 P, const float4 y) {
  x[0] = fmaf(P.x, x[0], y.x);
  x[1] = fmaf(P.y, x[1], y.y);
  x[2] = fmaf(P.z, x[2], y.z);
  x[3] = fmaf(P.w, x[3], y.w);
}

// One (b, kBlockChannels) block, tiles backward; see the note at the top.
__global__ void __launch_bounds__(kThreads, 2) ssm_bwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  Smem& sm = *reinterpret_cast<Smem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, s = tid >> 5;  // s: the segment
  const int ch = lane / kLanes, q = lane % kLanes, n0 = kPer * q;
  const int bidx = blockIdx.y;
  const int c0 = blockIdx.x * kBlockChannels;
  const int n_sub = (min(kBlockChannels, p.D - c0) + kSub - 1) / kSub;
  const int n_tiles = p.n_tiles;

  // The gradients, tiles backward.
  for (int idx = tid; idx < kBlockChannels * kN; idx += kThreads) {
    const int d = c0 + idx / kN;
    sm.carry[idx / kN][idx % kN] =
        p.dh && d < p.D ? p.dh[((long long)bidx * p.D + d) * kN + idx % kN] : 0.f;
  }
  load_sub(p, sm, 0, bidx, c0, n_tiles - 1);
  load_bc(p, sm, bidx, n_tiles - 1);
  cp_async_commit();
  int it = 0;  // iterations so far: the stage is it & 1
  // Lane `lane` of warp s keeps slot `slot` of dB/dC for the segment's 8
  // steps, summed over the block's channels.
  int first = 0;  // after the reduce-scatter: the value index this lane holds
  first += (lane & 16) ? 4 : 0;
  first += (lane & 8) ? 2 : 0;
  first += (lane & 4) ? 1 : 0;
  const int slot = first < kPer ? n0 + first : kN + n0 + first - kPer;
  for (int k = n_tiles - 1; k >= 0; --k) {
    float acc[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) acc[j] = 0.f;
    for (int sub = 0; sub < n_sub; ++sub, ++it) {
      cp_async_wait_all();
      __syncthreads();
      {
        const bool last = sub + 1 == n_sub;
        if (!(last && k == 0)) {
          const int nk = last ? k - 1 : k, ns = last ? 0 : sub + 1;
          load_sub(p, sm, (it + 1) & 1, bidx, c0 + ns * kSub, nk);
          if (last) load_bc(p, sm, bidx, nk);
        }
        cp_async_commit();
      }
      const int d = c0 + sub * kSub + ch;
      const bool valid = d < p.D;
      float a2[kPer];  // A log2(e); the sums over A are taken in these units
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        a2[i] = valid ? fmaxf(-expf(sm.la[it & 1][ch][n0 + i]) * kLog2e, -FLT_MAX) : 0.f;
      const float4* uvd = sm.uvd[it & 1][s * kSeg];
      const float* bcs = sm.bc[k & 1][s * kSeg];

      // The segment from zero: decays kept, P, local end state, gl.
      float e[kSeg][kPer];
      float h[kPer] = {0.f, 0.f, 0.f, 0.f}, P[kPer] = {1.f, 1.f, 1.f, 1.f};
      float gl[kPer] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const float4 f = uvd[j * kSub + ch];
        const float x = f.x * f.y;
        float bv[kPer], cv[kPer];
        to_array(ld4(bcs + j * kSlots + n0), bv);
        to_array(ld4(bcs + j * kSlots + kN + n0), cv);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          e[j][i] = fast_exp2(f.x * a2[i]);
          h[i] = fmaf(e[j][i], h[i], x * bv[i]);
          P[i] *= e[j][i];
          gl[i] = fmaf(P[i], f.z * cv[i], gl[i]);
        }
      }
      sm.agg[0][s][lane] = to_float4(P);
      sm.agg[1][s][lane] = to_float4(h);
      sm.agg[2][s][lane] = to_float4(gl);
      __syncthreads();

      // The carries: the state entering this segment, the gradient arriving
      // at its right end.
      float hin[kPer], g[kPer];
      to_array(ld4(&sm.hin[it & 1][ch][n0]), hin);
      to_array(ld4(&sm.carry[sub * kSub + ch][n0]), g);
      for (int sp = 0; sp < s; ++sp) fold(hin, sm.agg[0][sp][lane], sm.agg[1][sp][lane]);
      for (int sp = kSegs - 1; sp > s; --sp) fold(g, sm.agg[0][sp][lane], sm.agg[2][sp][lane]);

      // The true states, forward through the kept decays, into shared
      // memory (sm.hs[s][j][lane]: the state after the segment's step j).
      {
        float hcur[kPer] = {hin[0], hin[1], hin[2], hin[3]};
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const float4 f = uvd[j * kSub + ch];
          const float x = f.x * f.y;
          float bv[kPer];
          to_array(ld4(bcs + j * kSlots + n0), bv);
#pragma unroll
          for (int i = 0; i < kPer; ++i) hcur[i] = fmaf(e[j][i], hcur[i], x * bv[i]);
          sm.hs[s][j][lane] = to_float4(hcur);
        }
      }

      // The walk back.  dA: dlog_a / A of this segment.
      float dA[kPer] = {0.f, 0.f, 0.f, 0.f};
      float hj[kPer];  // the state after step j
      to_array(sm.hs[s][kSeg - 1][lane], hj);
#pragma unroll
      for (int j = kSeg - 1; j >= 0; --j) {
        const float4 f = uvd[j * kSub + ch];
        const float x = f.x * f.y;
        float hp[kPer];  // the state before step j
        if (j) {
          to_array(sm.hs[s][j - 1][lane], hp);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) hp[i] = hin[i];
        }
        float bv[kPer], cv[kPer], v[2 * kPer];
        to_array(ld4(bcs + j * kSlots + n0), bv);
        to_array(ld4(bcs + j * kSlots + kN + n0), cv);
        float sb = 0.f, qq = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float gh = fmaf(f.z, cv[i], g[i]);
          sb = fmaf(gh, bv[i], sb);
          const float ghe = gh * (e[j][i] * hp[i]);
          qq = fmaf(ghe, a2[i], qq);
          dA[i] = fmaf(ghe, f.x, dA[i]);
          v[i] = gh * x;                 // dB's term
          v[kPer + i] = f.z * hj[i];     // dC's term
          g[i] = e[j][i] * gh;
        }
        // du and ddt: the four threads of the channel sum their states;
        // thread j % 4 writes step j.
        sb += __shfl_xor_sync(0xffffffffu, sb, 1);
        qq += __shfl_xor_sync(0xffffffffu, qq, 1);
        sb += __shfl_xor_sync(0xffffffffu, sb, 2);
        qq += __shfl_xor_sync(0xffffffffu, qq, 2);
        {
          const int t = k * kTile + s * kSeg + j;
          if ((j & 3) == q && valid && t < p.T) {
            const long long o = ((long long)bidx * p.T + t) * p.D + d;
            p.du[o] = f.x * sb;
            p.ddt[o] = fmaf(f.y, sb, qq * kLn2);
          }
        }
        // Sum the 8 channels of the warp: lane keeps value `first`.
#pragma unroll
        for (int mask = 16, nv = kPer; mask >= 4; mask /= 2, nv /= 2) {
          const bool upper = lane & mask;
#pragma unroll
          for (int i = 0; i < nv; ++i) {
            const float send = upper ? v[i] : v[i + nv];
            v[i] = (upper ? v[i + nv] : v[i]) + __shfl_xor_sync(0xffffffffu, send, mask);
          }
        }
        acc[j] += v[0];
#pragma unroll
        for (int i = 0; i < kPer; ++i) hj[i] = hp[i];
      }
      sm.red[s][lane] = to_float4(dA);
      __syncthreads();  // every fold has read the carry; dA's parts are in smem
      if (s == 0) *reinterpret_cast<float4*>(&sm.carry[sub * kSub + ch][n0]) = to_float4(g);
      if (tid < kSub * kN) {
        const int c = tid / kN, n = tid % kN, dd = c0 + sub * kSub + c;
        if (dd < p.D) {
          float sum = 0.f;
#pragma unroll
          for (int sp = 0; sp < kSegs; ++sp) {
            const float4 r = sm.red[sp][c * kLanes + n / kPer];
            sum += (n % kPer == 0 ? r.x : n % kPer == 1 ? r.y : n % kPer == 2 ? r.z : r.w);
          }
          const float av = fmaxf(-expf(sm.la[it & 1][c][n]), -FLT_MAX);
          float& pa = sm.acc_a[sub * kSub + c][n];
          pa = (k == n_tiles - 1 ? 0.f : pa) + av * sum;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int t = k * kTile + s * kSeg + j;
      if (t < p.T)
        p.part_bc[(((long long)bidx * p.T + t) * p.n_blocks + blockIdx.x) * kSlots + slot] = acc[j];
    }
  }
  __syncthreads();  // dlog_a's block parts are in shared memory
  for (int idx = tid; idx < n_sub * kSub * kN; idx += kThreads) {
    const int d = c0 + idx / kN;
    if (d < p.D) p.part_a[((long long)bidx * p.D + d) * kN + idx % kN] = sm.acc_a[idx / kN][idx % kN];
  }
}

// dB and dC (B * T * 2N sums over the blocks) and dlog_a (D * N sums over
// the batch rows), one output per thread, each in a fixed order.
__global__ void ssm_bwd_reduce_kernel(Params p) {
  const long long n_bc = (long long)p.B * p.T * kSlots;
  const long long n_a = (long long)p.D * kN;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n_bc + n_a;
       idx += (long long)gridDim.x * blockDim.x) {
    if (idx < n_bc) {
      const long long bt = idx / kSlots;
      const int slot = static_cast<int>(idx % kSlots);
      const float* src = p.part_bc + bt * p.n_blocks * kSlots + slot;
      float sum = 0.f;
      for (int blk = 0; blk < p.n_blocks; ++blk) sum += src[blk * kSlots];
      float* dst = slot < kN ? p.db : p.dc;
      dst[bt * kN + slot % kN] = sum;
    } else {
      const long long dn = idx - n_bc;
      float sum = 0.f;
      for (int b = 0; b < p.B; ++b) sum += p.part_a[(long long)b * n_a + dn];
      p.dlog_a[dn] = sum;
    }
  }
}

}  // namespace

extern "C" {

// The entry's argument block, packed by ops.py (_BACKWARD_ARGS).
struct EntryArgs {
  const void* in[5];      // u, dt, b, c, dy: last dim contiguous
  const void* log_a;      // (D, N) contiguous
  const void* dh;         // (B, D, N) contiguous, or null
  const void* tiles;      // (B, ceil(T / 64), D, N) contiguous: from the forward
  void* out[5];           // du, ddt (B, T, D); db, dc (B, T, N); dlog_a (D, N)
  void* scratch;          // float32: part_bc, part_a
  long long strides[10];  // (batch, time) of u, dt, b, c, dy, in elements
  void* stream;
  int B, T, D, N, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 224, "EntryArgs must match ops.py's packing");

// Floats of scratch the entry needs (ops.py sizes the buffer with it): the
// blocks' dB/dC partials and dlog_a's batch rows.
long long ssm_scan_backward_scratch(int B, int T, int D) {
  const long long n_blocks = (D + kBlockChannels - 1) / kBlockChannels;
  return (long long)B * T * n_blocks * kSlots + (long long)B * D * kN;
}

// Launches the two kernels; returns the first non-zero cudaError_t (0 on
// success), cudaErrorInvalidValue for a call outside the forward's limits
// or without the tile states.
int ssm_scan_backward(const EntryArgs* a) {
  if (a->N != kN || a->B <= 0 || a->T <= 0 || a->D <= 0 || a->chunk <= 0 || !a->tiles ||
      (a->chunk < a->T ? a->chunk : a->T) > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = static_cast<const float*>(a->in[0]);
  p.dt = static_cast<const float*>(a->in[1]);
  p.b = static_cast<const float*>(a->in[2]);
  p.c = static_cast<const float*>(a->in[3]);
  p.dy = static_cast<const float*>(a->in[4]);
  p.log_a = static_cast<const float*>(a->log_a);
  p.dh = static_cast<const float*>(a->dh);
  p.du = static_cast<float*>(a->out[0]);
  p.ddt = static_cast<float*>(a->out[1]);
  p.db = static_cast<float*>(a->out[2]);
  p.dc = static_cast<float*>(a->out[3]);
  p.dlog_a = static_cast<float*>(a->out[4]);
  const long long* st = a->strides;
  p.u_sb = st[0]; p.u_st = st[1]; p.dt_sb = st[2]; p.dt_st = st[3];
  p.b_sb = st[4]; p.b_st = st[5]; p.c_sb = st[6]; p.c_st = st[7];
  p.dy_sb = st[8]; p.dy_st = st[9];
  p.B = a->B;
  p.T = a->T;
  p.D = a->D;
  p.n_tiles = (a->T + kTile - 1) / kTile;
  p.n_blocks = (a->D + kBlockChannels - 1) / kBlockChannels;
  p.part_bc = static_cast<float*>(a->scratch);
  p.part_a = p.part_bc + (long long)a->B * a->T * p.n_blocks * kSlots;
  p.tiles = static_cast<const float*>(a->tiles);
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_kernel<<<dim3(p.n_blocks, a->B), kThreads, sizeof(Smem), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)a->B * a->T * kSlots + (long long)a->D * kN;
  const unsigned blocks = static_cast<unsigned>(items / 256 < 4096 ? items / 256 + 1 : 4096);
  ssm_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
