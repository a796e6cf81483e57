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
//   * The ragged S and T edges are masked here instead of padded copies.
//   * The TPU grid's sequential kv axis becomes a loop inside the block,
//     which stops at the causal diagonal and starts at the window's lower
//     edge, so dead kv tiles are never visited.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at S=T=512,
// H=16, D=128 bf16 the q/k/v/o traffic is about 8.4 MB, about 2.5 us, and
// the kernel is bound by bytes; at S=2048 causal it is about 17 GFLOP,
// about 17 us, and bound by operations.  hymba-1.5b's head dim 64 (H=25,
// KV=5) halves the bytes and operations per head.
//
// What this design does about that bound: nothing yet.  One block of 256
// threads per (b, h, 64-row q tile), templated on the head dim (64 or
// 128); each 64-key K/V tile is staged in
// shared memory as float32 and both products run as scalar FMAs on the CUDA
// cores, far below the tensor-core rate.  wgmma, TMA and a pipelined tile
// ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Thread (tx, ty) of the 16 x 16 grid owns q rows ty + 16*i (i < 4) of the
// tile: scores at keys tx + 16*j (j < 4) and outputs at dims tx + 16*j
// (j < D/16).  A row's 16 owners are 16 adjacent lanes of one warp, so row
// reductions are four xor-shuffles.
template <typename T, int kHeadDim>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < kBlockM * kHeadDim; idx += kThreads) {
    const int r = idx / kHeadDim, c = idx % kHeadDim;
    const int m = m0 + r;
    qs[r * kPitch + c] = m < p.S ? to_float(q[m * p.q_ss + c]) * p.scale : 0.f;
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
      ks[r * kPitch + c] = in ? to_float(k[n * p.k_ss + c]) : 0.f;
      vs[r * kHeadDim + c] = in ? to_float(v[n * p.v_ss + c]) : 0.f;
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
    for (int j = 0; j < kOut; ++j)
      o[m * p.o_ss + tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t kSmemBytes = Tile<D>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.S + kBlockM - 1) / kBlockM, p.H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_head_dim(const Params& p, int B, int D, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(p, B, stream);
  if (D == 128) return launch<T, 128>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); D = 64 or
// 128.  Strides are in elements; the head dim is contiguous.  Returns a
// cudaError_t.
int flash_attention_forward(int dtype, const void* q, const void* k, const void* v, void* o,
                            int B, int S, int T, int H, int KV, int D,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            int causal, int window, int kv_len, float scale,
                            void* stream) {
  if ((D != 64 && D != 128) || KV <= 0 || H % KV != 0 || B <= 0 || S <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, S, T, H, KV,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           causal, window, kv_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_head_dim<float>(p, B, D, s);
  if (dtype == 1) return (int)launch_head_dim<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
