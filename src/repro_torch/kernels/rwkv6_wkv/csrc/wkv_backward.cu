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
// cumulative form: the loss depends on lw only through the running sums
// L_t = lw_1 + ... + lw_t, every term of S_{t-1} carries one factor
// exp(L_{t-1}[i]) and every term of G_t one factor exp(-L_t[i]), so
//   dlog_w_t[i] = sum_j dS_T[i, j] S_T[i, j]
//               + sum_{t' > t} r_t'[i] (S_{t'-1} dout_t')[i]
//               - sum_{t' >= t} k_t'[i] (G_t' v_t')[i],
// zero where lw_t lies outside the clamp.  That needs no product of G and
// S at the same step, so the two recurrences run in separate sweeps.
// Inputs r/k/v/log_w/dout are float32 (B,T,H,K), read in place through
// their strides (rows of 64 floats as 16-byte vectors, the forward's
// layout rule); u (H,K) and the final state (B,H,K,K) contiguous.  K = 64
// only; the chunk limit (<= 64) is the forward's.
//
// Design: a simple serial walk over time, one thread per state row or
// column, the state in registers.
//   * wkv_bwd_state_kernel (forward in time): grid B*H, 128 threads, two
//     per row i of S (32 columns each).  Each step: the row's part of
//     S_{t-1} dout_t, one shuffle, then S <- w S + k v.  It writes the
//     state term of dr, (S_{t-1} dout_t)[i], into dr.
//   * wkv_bwd_grad_kernel (backward in time): grid B*H, 128 threads.
//     Threads 0-63 own row i of G: (G_t v_t)[i] gives dk, the running sum
//     above gives dlog_w (accumulated in float64, since its terms cancel
//     over T), dr gets its bonus term, and du its (b, h) part.  Threads
//     64-127 own column j of G: (G_t^T k_t)[j] gives dv.  Each step is
//     thread-local: the inputs of 32 steps are staged in shared memory
//     and read as broadcasts, with v . dout and sum_i r u k formed once per
//     step.
//   * wkv_bwd_du_kernel: du[h, i] = sum over b of the (b, h) parts, in
//     order.  No float atomics anywhere: two calls give the same bits.
// Bound on an H100 SXM at one node's training slice (B=40, T=512, H=64):
// the function reads r, k, v, log_w and dout and writes dr, dk, dv and
// dlog_w, 9 x 335.5 MB = 3.02 GB, 0.90 ms at 3.35 TB/s; the recurrence
// form's 12 K^2 operations per token and head (two state updates and four
// products with a K x K state) are 64.4 GFLOP, 0.96 ms at the float32
// rate off the tensor cores.  Both sweeps here do those operations on the
// CUDA cores, one state row or column per thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;            // head size: the only one taken
constexpr int kMaxChunk = 64;     // the forward's limit
constexpr int kThreads = 128;
constexpr int kTile = 32;         // steps staged in shared memory at once
constexpr int kVecs = kK / 4;     // float4s per row
constexpr int kLayoutRejected = -1;
constexpr float kLogDecayMin = -4.6f;

enum { kR = 0, kKey = 1, kV = 2, kW = 3, kDo = 4 };

struct Params {
  const float* in[5];    // r, k, v, log_w, dout
  const float* u;        // (H, K)
  const float* state;    // (B, H, K, K): the forward's final state
  const float* d_state;  // (B, H, K, K) or null
  float* dr;             // (B, T, H, K) contiguous, as are dk, dv, dlw
  float* dk;
  float* dv;
  float* dlw;
  float* du;             // (H, K)
  float* partial;        // (B, H, K): du per (b, h)
  int B, T, H;
  long long sb[5], st[5], sh[5];  // batch, time, head strides of the inputs
};

__device__ __forceinline__ float clamp_decay(float x) {
  return fminf(fmaxf(x, kLogDecayMin), 0.f);
}

__device__ __forceinline__ const float4* row4(const Params& p, int x, int b, int t, int h) {
  return reinterpret_cast<const float4*>(p.in[x] + b * p.sb[x] + (long long)t * p.st[x] +
                                         h * p.sh[x]);
}

// Offset of element (b, t, h, 0) of a contiguous (B, T, H, K) output.
__device__ __forceinline__ long long out_row(const Params& p, int b, int t, int h) {
  return (((long long)b * p.T + t) * p.H + h) * kK;
}

// Stage steps [t0, t0 + n) of input x into tile[kTile][kK] (float4 copies
// by every thread); with `decay`, store exp(clamp(lw)) instead of lw.
__device__ __forceinline__ void stage(const Params& p, int x, int b, int h, int t0, int n,
                                      float* tile, bool decay) {
  for (int idx = threadIdx.x; idx < n * kVecs; idx += kThreads) {
    const int s = idx / kVecs, c = idx % kVecs;
    float4 val = row4(p, x, b, t0 + s, h)[c];
    if (decay) {
      val.x = expf(clamp_decay(val.x));
      val.y = expf(clamp_decay(val.y));
      val.z = expf(clamp_decay(val.z));
      val.w = expf(clamp_decay(val.w));
    }
    reinterpret_cast<float4*>(tile + s * kK)[c] = val;
  }
}

// Sweep 1: the state term of dr, forward in time.
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_kernel(Params p) {
  __shared__ __align__(16) float dos[kTile * kK];
  __shared__ __align__(16) float vs[kTile * kK];
  __shared__ __align__(16) float ks[kTile * kK];
  __shared__ __align__(16) float ws[kTile * kK];
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int j0 = half * (kK / 2);
  float S[kK / 2];
#pragma unroll
  for (int j = 0; j < kK / 2; ++j) S[j] = 0.f;
  for (int t0 = 0; t0 < p.T; t0 += kTile) {
    const int n = min(kTile, p.T - t0);
    __syncthreads();  // the last tile is no longer read
    stage(p, kDo, b, h, t0, n, dos, false);
    stage(p, kV, b, h, t0, n, vs, false);
    stage(p, kKey, b, h, t0, n, ks, false);
    stage(p, kW, b, h, t0, n, ws, true);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float4* d4 = reinterpret_cast<const float4*>(dos + s * kK + j0);
      const float4* v4 = reinterpret_cast<const float4*>(vs + s * kK + j0);
      const float ki = ks[s * kK + i], wi = ws[s * kK + i];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kK / 8; ++c) {
        const float4 d = d4[c], v = v4[c];
        acc[0] = fmaf(S[4 * c], d.x, acc[0]);
        acc[1] = fmaf(S[4 * c + 1], d.y, acc[1]);
        acc[2] = fmaf(S[4 * c + 2], d.z, acc[2]);
        acc[3] = fmaf(S[4 * c + 3], d.w, acc[3]);
        S[4 * c] = fmaf(wi, S[4 * c], ki * v.x);
        S[4 * c + 1] = fmaf(wi, S[4 * c + 1], ki * v.y);
        S[4 * c + 2] = fmaf(wi, S[4 * c + 2], ki * v.z);
        S[4 * c + 3] = fmaf(wi, S[4 * c + 3], ki * v.w);
      }
      float dot = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (half == 0) p.dr[out_row(p, b, t0 + s, h) + i] = dot;
    }
  }
}

// Sweep 2: dk, dv, dlog_w, dr's bonus term and du's (b, h) part, backward
// in time.
__global__ void __launch_bounds__(kThreads) wkv_bwd_grad_kernel(Params p) {
  __shared__ __align__(16) float rs[kTile * kK];
  __shared__ __align__(16) float ks[kTile * kK];
  __shared__ __align__(16) float vs[kTile * kK];
  __shared__ __align__(16) float dos[kTile * kK];
  __shared__ __align__(16) float ws[kTile * kK];
  __shared__ float vd[kTile];   // v_t . dout_t
  __shared__ float ruk[kTile];  // sum_i r_t[i] u[i] k_t[i]
  __shared__ float us[kK];
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool row_role = tid < kK;
  const int idx = row_role ? tid : tid - kK;  // row i or column j
  if (tid < kK) us[tid] = p.u[h * kK + tid];
  const long long sbase = (long long)bh * kK * kK;

  // Row role: G[i, :]; column role: G[:, j].
  float G[kK];
  double acc = 0.0;  // the running sum of dlog_w
  float du_part = 0.f;
  if (row_role) {
    float fin = 0.f;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      G[j] = p.d_state ? p.d_state[sbase + idx * kK + j] : 0.f;
      fin = fmaf(G[j], p.state[sbase + idx * kK + j], fin);
    }
    acc = fin;
  } else {
#pragma unroll
    for (int i = 0; i < kK; ++i) G[i] = p.d_state ? p.d_state[sbase + i * kK + idx] : 0.f;
  }
  const float* lw = p.in[kW] + b * p.sb[kW] + h * p.sh[kW] + idx;
  const int n_tiles = (p.T + kTile - 1) / kTile;
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile;
    const int n = min(kTile, p.T - t0);
    __syncthreads();  // the last tile is no longer read
    stage(p, kR, b, h, t0, n, rs, false);
    stage(p, kKey, b, h, t0, n, ks, false);
    stage(p, kV, b, h, t0, n, vs, false);
    stage(p, kDo, b, h, t0, n, dos, false);
    stage(p, kW, b, h, t0, n, ws, true);
    __syncthreads();
    // v . dout and sum r u k of each step: a warp per step.
    for (int s = warp; s < n; s += kThreads / 32) {
      const int a = s * kK + lane, c = a + 32;
      float x = fmaf(vs[a], dos[a], vs[c] * dos[c]);
      float y = fmaf(rs[a] * us[lane], ks[a], rs[c] * us[lane + 32] * ks[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
        y += __shfl_xor_sync(0xffffffffu, y, off);
      }
      if (lane == 0) {
        vd[s] = x;
        ruk[s] = y;
      }
    }
    __syncthreads();
    if (row_role) {
      const int i = idx;
      const float ui = us[i];
      for (int s = n - 1; s >= 0; --s) {
        const int t = t0 + s;
        const float4* v4 = reinterpret_cast<const float4*>(vs + s * kK);
        const float4* d4 = reinterpret_cast<const float4*>(dos + s * kK);
        const float ri = rs[s * kK + i], ki = ks[s * kK + i], wi = ws[s * kK + i];
        const float vds = vd[s];
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kVecs; ++c) {
          const float4 v = v4[c], d = d4[c];
          a4[0] = fmaf(G[4 * c], v.x, a4[0]);
          a4[1] = fmaf(G[4 * c + 1], v.y, a4[1]);
          a4[2] = fmaf(G[4 * c + 2], v.z, a4[2]);
          a4[3] = fmaf(G[4 * c + 3], v.w, a4[3]);
          G[4 * c] = fmaf(wi, G[4 * c], ri * d.x);
          G[4 * c + 1] = fmaf(wi, G[4 * c + 1], ri * d.y);
          G[4 * c + 2] = fmaf(wi, G[4 * c + 2], ri * d.z);
          G[4 * c + 3] = fmaf(wi, G[4 * c + 3], ri * d.w);
        }
        const float dkh = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        const long long o = out_row(p, b, t, h) + i;
        const float drh = p.dr[o];  // sweep 1's state term
        const float lwi = lw[(long long)t * p.st[kW]];
        p.dk[o] = fmaf(ri * ui, vds, dkh);
        p.dr[o] = fmaf(ui * ki, vds, drh);
        acc -= (double)(ki * dkh);
        p.dlw[o] = (lwi >= kLogDecayMin && lwi <= 0.f) ? (float)acc : 0.f;
        acc += (double)(ri * drh);
        du_part = fmaf(ri * ki, vds, du_part);
      }
    } else {
      const int j = idx;
      for (int s = n - 1; s >= 0; --s) {
        const int t = t0 + s;
        const float4* k4 = reinterpret_cast<const float4*>(ks + s * kK);
        const float4* w4 = reinterpret_cast<const float4*>(ws + s * kK);
        const float4* r4 = reinterpret_cast<const float4*>(rs + s * kK);
        const float dj = dos[s * kK + j];
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kVecs; ++c) {
          const float4 k = k4[c], w = w4[c], r = r4[c];
          a4[0] = fmaf(G[4 * c], k.x, a4[0]);
          a4[1] = fmaf(G[4 * c + 1], k.y, a4[1]);
          a4[2] = fmaf(G[4 * c + 2], k.z, a4[2]);
          a4[3] = fmaf(G[4 * c + 3], k.w, a4[3]);
          G[4 * c] = fmaf(w.x, G[4 * c], r.x * dj);
          G[4 * c + 1] = fmaf(w.y, G[4 * c + 1], r.y * dj);
          G[4 * c + 2] = fmaf(w.z, G[4 * c + 2], r.z * dj);
          G[4 * c + 3] = fmaf(w.w, G[4 * c + 3], r.w * dj);
        }
        const float dvh = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        p.dv[out_row(p, b, t, h) + j] = fmaf(ruk[s], dj, dvh);
      }
    }
  }
  if (row_role) p.partial[(long long)bh * kK + idx] = du_part;
}

__global__ void __launch_bounds__(kK) wkv_bwd_du_kernel(Params p) {
  const int h = blockIdx.x, i = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < p.B; ++b) sum += p.partial[((long long)b * p.H + h) * kK + i];
  p.du[h * kK + i] = sum;
}

}  // namespace

extern "C" {

// The C entry's argument block, packed by ops.py (_BACKWARD_ARGS).
struct EntryArgs {
  const void* in[5];       // r, k, v, log_w, dout: (B, T, H, K)
  const void* u;           // (H, K) contiguous
  const void* state;       // (B, H, K, K) contiguous: the forward's final state
  const void* d_state;     // (B, H, K, K) contiguous, or null
  void* out[4];            // dr, dk, dv, dlog_w: (B, T, H, K) contiguous
  void* du;                // (H, K)
  void* partial;           // (B, H, K) float32 scratch
  long long strides[20];   // (batch, time, head, channel) of r, k, v, log_w, dout
  void* stream;
  int B, T, H, K, chunk, unused;
};
static_assert(sizeof(EntryArgs) == 304, "EntryArgs must match ops.py's packing");

// Returns the first non-zero cudaError_t of the three launches (0 on
// success), or kLayoutRejected (-1) when K is not 64, the chunk is over 64,
// or an input is not read as 16-byte rows (base 16-byte aligned, channel
// stride 1, every other stride of a dim longer than 1 a multiple of 4);
// nothing is launched then.
int wkv_backward(const EntryArgs* a) {
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->chunk < 1) return (int)cudaErrorInvalidValue;
  const int C = a->chunk < a->T ? a->chunk : a->T;
  if (a->K != kK || C > kMaxChunk) return kLayoutRejected;
  const int sizes[3] = {a->B, a->T, a->H};
  for (int x = 0; x < 5; ++x) {
    const long long* st = a->strides + 4 * x;
    if (reinterpret_cast<uintptr_t>(a->in[x]) % 16 || st[3] != 1) return kLayoutRejected;
    for (int dim = 0; dim < 3; ++dim) {
      if (sizes[dim] > 1 && st[dim] % 4) return kLayoutRejected;
    }
  }
  Params p;
  for (int x = 0; x < 5; ++x) {
    p.in[x] = static_cast<const float*>(a->in[x]);
    p.sb[x] = a->strides[4 * x];
    p.st[x] = a->strides[4 * x + 1];
    p.sh[x] = a->strides[4 * x + 2];
  }
  p.u = static_cast<const float*>(a->u);
  p.state = static_cast<const float*>(a->state);
  p.d_state = static_cast<const float*>(a->d_state);
  p.dr = static_cast<float*>(a->out[0]);
  p.dk = static_cast<float*>(a->out[1]);
  p.dv = static_cast<float*>(a->out[2]);
  p.dlw = static_cast<float*>(a->out[3]);
  p.du = static_cast<float*>(a->du);
  p.partial = static_cast<float*>(a->partial);
  p.B = a->B;
  p.T = a->T;
  p.H = a->H;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  const dim3 grid(a->B * a->H);
  wkv_bwd_state_kernel<<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_grad_kernel<<<grid, kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_du_kernel<<<a->H, kK, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
