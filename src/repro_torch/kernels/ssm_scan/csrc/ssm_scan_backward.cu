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
// (batch, time) strides with the last dim contiguous; log_a (D,N) and the
// final state's gradient (B,D,N) contiguous.  N = 16 only, as the forward.
//
// Design: a simple walk over time, two threads per channel (eight states
// each), the states in registers.
//   * ssm_bwd_ckpt_kernel (forward in time): recomputes h and stores the
//     state entering every segment of kSeg = 8 steps, (B, n_seg, D, N).
//   * ssm_bwd_grad_kernel (backward in time): grid (D / 128, B), 256
//     threads.  For each segment, last first: recompute its 8 states from
//     the stored one (kept in registers), then walk the segment in reverse
//     carrying a_{t+1} Gh_{t+1}.  du and ddt are sums over the thread's 8
//     states plus one shuffle; dlog_a's (b, d) part accumulates in
//     registers.  dB and dC sum over channels: a reduce-scatter over the 16
//     channels of a warp (15 shuffles a step), then the block's 8 warps in
//     order through shared memory, written as one partial per (b, t, block).
//   * ssm_bwd_reduce_kernel: dB and dC sum their blocks' partials, dlog_a
//     its batch rows' parts, each in a fixed order.  No float atomics
//     anywhere: two calls give the same bits.
// Bound on an H100 SXM at one node's training slice of hymba-1.5b (B=40,
// T=512, D=3200, N=16): the function reads u, dt and dy and writes du and
// ddt, 5 x 262.1 MB = 1.31 GB, 0.39 ms at 3.35 TB/s (B, C, dB and dC add
// 5.2 MB); its recurrences do about 16 operations per (b, t, d, n)
// (the forward's state update again, the carried gradient, the four
// products and the decay) with two exponentials, 16.8 GFLOP, 0.25 ms at
// the float32 rate: bound by bytes.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;             // state size: the only one taken
constexpr int kLanes = 2;          // threads per channel
constexpr int kPer = kN / kLanes;  // states per thread
constexpr int kSeg = 8;            // steps per segment
constexpr int kThreads = 256;
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;     // the forward's limit
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* u;
  const float* dt;
  const float* b;
  const float* c;
  const float* dy;
  const float* log_a;  // (D, N)
  const float* dh;     // (B, D, N) or null
  float* ckpt;         // (B, n_seg, D, N): the state entering each segment
  float* du;           // (B, T, D) contiguous, as is ddt
  float* ddt;
  float* db;           // (B, T, N) contiguous, as is dc
  float* dc;
  float* dlog_a;       // (D, N)
  float* part_bc;      // (B, T, n_blocks, 2N): per block, dB then dC
  float* part_a;       // (B, D, N): dlog_a per batch row
  long long u_sb, u_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st, dy_sb, dy_st;
  int B, T, D, n_seg, n_blocks;
};

// A, and A log2(e) for exp2, finite even where exp(log_a) overflows (the
// forward's rule).
__device__ __forceinline__ void load_a(const Params& p, int d, int lane, float (&A)[kPer],
                                       float (&A2)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float a = d < p.D ? fmaxf(-expf(p.log_a[d * kN + kPer * lane + i]), -FLT_MAX) : 0.f;
    A[i] = a;
    A2[i] = fmaxf(a * kLog2e, -FLT_MAX);
  }
}

__global__ void __launch_bounds__(kThreads) ssm_bwd_ckpt_kernel(Params p) {
  const int tid = threadIdx.x, lane = tid % kLanes;
  const int d = blockIdx.x * kChannels + tid / kLanes;
  const int bidx = blockIdx.y;
  float A[kPer], A2[kPer], h[kPer];
  load_a(p, d, lane, A, A2);
#pragma unroll
  for (int i = 0; i < kPer; ++i) h[i] = 0.f;
  const bool valid = d < p.D;
  const float* u = p.u + bidx * p.u_sb + d;
  const float* dt = p.dt + bidx * p.dt_sb + d;
  const float* bt = p.b + bidx * p.b_sb + kPer * lane;
  for (int seg = 0; seg < p.n_seg; ++seg) {
    if (valid) {
      float4* out = reinterpret_cast<float4*>(
          p.ckpt + (((long long)bidx * p.n_seg + seg) * p.D + d) * kN + kPer * lane);
      out[0] = make_float4(h[0], h[1], h[2], h[3]);
      out[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
    float dtv[kSeg], xv[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int t = seg * kSeg + j;
      const bool ok = valid && t < p.T;
      dtv[j] = ok ? dt[t * p.dt_st] : 0.f;
      xv[j] = ok ? dtv[j] * u[t * p.u_st] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int t = seg * kSeg + j;
      if (t >= p.T) break;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        h[i] = fmaf(exp2f(dtv[j] * A2[i]), h[i], xv[j] * bt[t * p.b_st + i]);
    }
  }
}

// The reduce-scatter of 16 values over the 16 channels (lanes with one
// parity) of a warp: on return v[0] holds the warp's sum of value `first`.
__device__ __forceinline__ int reduce_scatter(float (&v)[2 * kPer], int lane) {
  int first = 0;
#pragma unroll
  for (int mask = 16, n = kPer; mask >= 2; mask /= 2, n /= 2) {
    const bool upper = lane & mask;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      v[i] = (upper ? v[i + n] : v[i]) + __shfl_xor_sync(0xffffffffu, send, mask);
    }
    if (upper) first += n;
  }
  return first;
}

__global__ void __launch_bounds__(kThreads) ssm_bwd_grad_kernel(Params p) {
  __shared__ float bs[kSeg][kN];
  __shared__ float cs[kSeg][kN];
  __shared__ float red[kWarps][kSeg][2 * kN];
  const int tid = threadIdx.x, lane = tid % kLanes, wl = tid & 31, warp = tid >> 5;
  const int d = blockIdx.x * kChannels + tid / kLanes;
  const int bidx = blockIdx.y;
  const bool valid = d < p.D;
  const int n0 = kPer * lane;
  float A[kPer], A2[kPer], g[kPer], dA[kPer];
  load_a(p, d, lane, A, A2);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    g[i] = (valid && p.dh) ? p.dh[((long long)bidx * p.D + d) * kN + n0 + i] : 0.f;
    dA[i] = 0.f;
  }
  const float* u = p.u + bidx * p.u_sb + d;
  const float* dt = p.dt + bidx * p.dt_sb + d;
  const float* dy = p.dy + bidx * p.dy_sb + d;
  for (int seg = p.n_seg - 1; seg >= 0; --seg) {
    const int t0 = seg * kSeg;
    __syncthreads();  // the last segment's B, C and reduction are read
    if (tid < kSeg * kN) {
      const int j = tid / kN, n = tid % kN, t = t0 + j;
      bs[j][n] = t < p.T ? p.b[bidx * p.b_sb + t * p.b_st + n] : 0.f;
    } else if (tid < 2 * kSeg * kN) {
      const int j = (tid - kSeg * kN) / kN, n = tid % kN, t = t0 + j;
      cs[j][n] = t < p.T ? p.c[bidx * p.c_sb + t * p.c_st + n] : 0.f;
    }
    float uv[kSeg], dtv[kSeg], dyv[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const int t = t0 + j;
      const bool ok = valid && t < p.T;
      uv[j] = ok ? u[t * p.u_st] : 0.f;
      dtv[j] = ok ? dt[t * p.dt_st] : 0.f;
      dyv[j] = ok ? dy[t * p.dy_st] : 0.f;
    }
    float hs[kSeg + 1][kPer];  // hs[j] = h_{t0 + j - 1}
    if (valid) {
      const float4* in = reinterpret_cast<const float4*>(
          p.ckpt + (((long long)bidx * p.n_seg + seg) * p.D + d) * kN + n0);
      const float4 x0 = in[0], x1 = in[1];
      hs[0][0] = x0.x; hs[0][1] = x0.y; hs[0][2] = x0.z; hs[0][3] = x0.w;
      hs[0][4] = x1.x; hs[0][5] = x1.y; hs[0][6] = x1.z; hs[0][7] = x1.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) hs[0][i] = 0.f;
    }
    __syncthreads();  // B and C are staged
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const float x = dtv[j] * uv[j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        hs[j + 1][i] = fmaf(exp2f(dtv[j] * A2[i]), hs[j][i], x * bs[j][n0 + i]);
    }
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      // Past T every input is 0: the decay is 1 and g passes unchanged.
      const int t = t0 + j;
      const float x = dtv[j] * uv[j];
      float gh[kPer], e[kPer], v[2 * kPer];
      float sb = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        gh[i] = fmaf(dyv[j], cs[j][n0 + i], g[i]);
        e[i] = exp2f(dtv[j] * A2[i]);
        sb = fmaf(gh[i], bs[j][n0 + i], sb);
        const float ghe = gh[i] * hs[j][i] * e[i];
        q = fmaf(ghe, A[i], q);
        dA[i] = fmaf(ghe, dtv[j], dA[i]);
        v[i] = gh[i] * x;                 // dB's term
        v[kPer + i] = dyv[j] * hs[j + 1][i];  // dC's term
        g[i] = e[i] * gh[i];
      }
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      if (valid && lane == 0 && t < p.T) {
        const long long o = ((long long)bidx * p.T + t) * p.D + d;
        p.du[o] = dtv[j] * sb;
        p.ddt[o] = fmaf(uv[j], sb, q);
      }
      const int first = reduce_scatter(v, wl);
      // Value `first` of lane parity `lane`: dB[n0 + first] for first < 8,
      // else dC[n0 + first - 8].
      const int slot = first < kPer ? n0 + first : kN + n0 + first - kPer;
      red[warp][j][slot] = v[0];
    }
    __syncthreads();  // every warp's sums are in shared memory
    {
      const int j = tid / (2 * kN), slot = tid % (2 * kN), t = t0 + j;
      if (t < p.T) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w][j][slot];
        p.part_bc[(((long long)bidx * p.T + t) * p.n_blocks + blockIdx.x) * 2 * kN + slot] = sum;
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      p.part_a[((long long)bidx * p.D + d) * kN + n0 + i] = A[i] * dA[i];
  }
}

// dB and dC (B * T * 2N sums over the blocks) and dlog_a (D * N sums over
// the batch rows), one output per thread, each in a fixed order.
__global__ void ssm_bwd_reduce_kernel(Params p) {
  const long long n_bc = (long long)p.B * p.T * 2 * kN;
  const long long n_a = (long long)p.D * kN;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n_bc + n_a;
       idx += (long long)gridDim.x * blockDim.x) {
    if (idx < n_bc) {
      const long long bt = idx / (2 * kN);
      const int slot = static_cast<int>(idx % (2 * kN));
      const float* src = p.part_bc + bt * p.n_blocks * 2 * kN + slot;
      float sum = 0.f;
      for (int blk = 0; blk < p.n_blocks; ++blk) sum += src[blk * 2 * kN];
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
  void* out[5];           // du, ddt (B, T, D); db, dc (B, T, N); dlog_a (D, N)
  void* scratch;          // float32: ckpt, then part_bc, then part_a
  long long strides[10];  // (batch, time) of u, dt, b, c, dy, in elements
  void* stream;
  int B, T, D, N, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 216, "EntryArgs must match ops.py's packing");

// Floats of scratch the entry needs (ops.py sizes the buffer with it).
long long ssm_scan_backward_scratch(int B, int T, int D) {
  const long long n_seg = (T + kSeg - 1) / kSeg;
  const long long n_blocks = (D + kChannels - 1) / kChannels;
  return (long long)B * n_seg * D * kN + (long long)B * T * n_blocks * 2 * kN +
         (long long)B * D * kN;
}

// Launches the three kernels; returns the first non-zero cudaError_t (0 on
// success), cudaErrorInvalidValue for a call outside the forward's limits.
int ssm_scan_backward(const EntryArgs* a) {
  if (a->N != kN || a->B <= 0 || a->T <= 0 || a->D <= 0 || a->chunk <= 0 ||
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
  p.n_seg = (a->T + kSeg - 1) / kSeg;
  p.n_blocks = (a->D + kChannels - 1) / kChannels;
  p.ckpt = static_cast<float*>(a->scratch);
  p.part_bc = p.ckpt + (long long)a->B * p.n_seg * a->D * kN;
  p.part_a = p.part_bc + (long long)a->B * a->T * p.n_blocks * 2 * kN;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  const dim3 grid(p.n_blocks, a->B);
  ssm_bwd_ckpt_kernel<<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_grad_kernel<<<grid, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)a->B * a->T * 2 * kN + (long long)a->D * kN;
  const unsigned blocks = static_cast<unsigned>(items / 256 < 4096 ? items / 256 + 1 : 4096);
  ssm_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
