// Fused Metropolis sweep for the real LogPsiCNN, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (qmcnn_tpu/kernels/metropolis_pallas.py, launched by `_pallas_sweep_impl`
// behind `pallas_sweep`): for every walker, `n_props` sequential Metropolis
// proposals with the walker's configuration, its cached log psi and the
// network weights resident on chip for the whole sweep. Each proposal
// builds s' (flip site a; for exchange moves flip a and b only when the
// bond is anti-aligned, otherwise s' = s), runs the network forward
//   h <- lncosh(conv(h, W_l) + b_l),   log psi = sum(h)
// and accepts iff log_u < 2 (log psi' - log psi). `n_props == 0` only
// recomputes log psi(s).
//
// Design. One thread block per walker, one output site per thread (sites
// strided over the block when N exceeds it). The TPU kernel's circulant
// [N*Cin, N*Cout] weight form was an MXU choice; at 10x10 with C=16 it is a
// 10 MB matrix per layer and 11x the convolution's FLOPs. Here every layer
// stays in its Flax [taps, Cin, Cout] form (Cout zero-padded to a multiple
// of 16), staged once into shared memory with the biases and a
// [taps, N] table of source sites that encodes the circular padding
// (lo = (k-1)//2, asymmetric for even k). Activations ping-pong between two
// channel-major [C, N] shared buffers, so neighbouring threads read
// neighbouring words. A thread keeps 16 output channels in registers and
// reads their weights as four broadcast float4 loads per input value.
// log psi is a warp-shuffle plus ordered per-warp sum (deterministic); one
// thread decides accept/reject and the block swaps its s buffers.
//
// Bound. The sweep is FP32-compute bound: each forward costs
// 2 * N * taps * sum_l Cin_l * Cout_l FLOP (9.5e5 at 10x10, C=16^3, k=3),
// and the state read and written per walker is a few hundred bytes. The
// design keeps every operand on chip so that only the FMA rate and the
// shared-memory load rate limit it; tensor cores (mma / TF32) and
// incremental receptive-field updates are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kCoBlock = 16;  // output channels held in registers per pass

struct SweepDims {
  int n_layers;
  int ch[kMaxLayers + 1];   // ch[0] = input channels, ch[l+1] = Cout of l
  int chp[kMaxLayers + 1];  // Cout rounded up to kCoBlock (chp[0] unused)
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

struct SmemLayout {
  int w_off, b_off, act0_off, act1_off, s0_off, s1_off, red_off, nbr_off;
  int total_bytes;
};

__host__ __device__ inline SmemLayout smem_layout(const SweepDims& d, int n,
                                                  int taps) {
  int w_total = 0, b_total = 0, cmax = 1;
  for (int l = 0; l < d.n_layers; ++l) {
    w_total += taps * d.ch[l] * d.chp[l + 1];
    b_total += d.chp[l + 1];
    cmax = d.ch[l + 1] > cmax ? d.ch[l + 1] : cmax;
  }
  SmemLayout s;
  s.w_off = 0;
  s.b_off = s.w_off + round4(w_total);
  s.act0_off = s.b_off + round4(b_total);
  s.act1_off = s.act0_off + round4(cmax * n);
  s.s0_off = s.act1_off + round4(cmax * n);
  s.s1_off = s.s0_off + round4(n);
  s.red_off = s.s1_off + round4(n);
  s.nbr_off = s.red_off + 32;  // 4-byte ints after the floats
  s.total_bytes = 4 * (s.nbr_off + taps * n);
  return s;
}

__device__ __forceinline__ float lncosh_f(float x) {
  const float t = fabsf(x);
  return t - 0.6931471805599453f + log1pf(expf(-2.0f * t));
}

// Forward of the whole stack on x0 ([ch[0], n] in shared memory). Every
// thread must call it; the result is valid in thread 0 only.
__device__ float forward(const float* x0, float* buf0, float* buf1,
                         const float* w_s, const float* b_s,
                         const int* nbr_s, const SweepDims& d, int n,
                         int taps, float* red) {
  const float* in = x0;
  float partial = 0.0f;
  int w_off = 0, b_off = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int cin = d.ch[l], cout = d.ch[l + 1], coutp = d.chp[l + 1];
    const bool last = (l == d.n_layers - 1);
    float* out = (l & 1) ? buf1 : buf0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      for (int c0 = 0; c0 < coutp; c0 += kCoBlock) {
        float acc[kCoBlock];
#pragma unroll
        for (int j = 0; j < kCoBlock; ++j) acc[j] = 0.0f;
        for (int t = 0; t < taps; ++t) {
          const int q = nbr_s[t * n + p];
          const float* wt = w_s + w_off + t * cin * coutp + c0;
          for (int ci = 0; ci < cin; ++ci) {
            const float a = in[ci * n + q];
            const float4* w4 = reinterpret_cast<const float4*>(wt + ci * coutp);
#pragma unroll
            for (int j4 = 0; j4 < kCoBlock / 4; ++j4) {
              const float4 wv = w4[j4];
              acc[4 * j4 + 0] = fmaf(a, wv.x, acc[4 * j4 + 0]);
              acc[4 * j4 + 1] = fmaf(a, wv.y, acc[4 * j4 + 1]);
              acc[4 * j4 + 2] = fmaf(a, wv.z, acc[4 * j4 + 2]);
              acc[4 * j4 + 3] = fmaf(a, wv.w, acc[4 * j4 + 3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kCoBlock; ++j) {
          const int co = c0 + j;
          if (co < cout) {
            const float h = lncosh_f(acc[j] + b_s[b_off + co]);
            if (last) {
              partial += h;
            } else {
              out[co * n + p] = h;
            }
          }
        }
      }
    }
    __syncthreads();
    in = out;
    w_off += taps * cin * coutp;
    b_off += coutp;
  }
  // fixed-order block reduction: shuffle tree within each warp, then
  // thread 0 adds the warp sums in warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    partial += __shfl_down_sync(0xffffffffu, partial, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = partial;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    const int n_warps = blockDim.x >> 5;
    for (int i = 0; i < n_warps; ++i) total += red[i];
  }
  return total;
}

__global__ void sweep_kernel(const float* __restrict__ s_in,
                             const float* __restrict__ lp_in,
                             const int* __restrict__ site_a,
                             const int* __restrict__ site_b,
                             const float* __restrict__ log_u,
                             const float* __restrict__ weights,
                             const float* __restrict__ biases,
                             const int* __restrict__ nbr,
                             float* __restrict__ s_out,
                             float* __restrict__ lp_out,
                             int* __restrict__ n_acc_out, int m, int n,
                             int taps, int n_props, int exchange,
                             SweepDims d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int accept_flag;
  const SmemLayout lay = smem_layout(d, n, taps);
  float* w_s = smem + lay.w_off;
  float* b_s = smem + lay.b_off;
  float* act0 = smem + lay.act0_off;
  float* act1 = smem + lay.act1_off;
  float* s_cur = smem + lay.s0_off;
  float* s_prop = smem + lay.s1_off;
  float* red = smem + lay.red_off;
  int* nbr_s = reinterpret_cast<int*>(smem + lay.nbr_off);

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int w_total = lay.b_off - lay.w_off;
  const int b_total = lay.act0_off - lay.b_off;
  for (int i = tid; i < w_total; i += blockDim.x) w_s[i] = weights[i];
  for (int i = tid; i < b_total; i += blockDim.x) b_s[i] = biases[i];
  for (int i = tid; i < taps * n; i += blockDim.x) nbr_s[i] = nbr[i];
  for (int p = tid; p < n; p += blockDim.x)
    s_cur[p] = s_in[static_cast<size_t>(w) * n + p];
  __syncthreads();

  float lp = lp_in[w];  // meaningful in thread 0, which owns the decision
  int n_acc = 0;
  if (n_props == 0) {
    const float v = forward(s_cur, act0, act1, w_s, b_s, nbr_s, d, n, taps,
                            red);
    if (tid == 0) lp = v;
  }
  for (int t = 0; t < n_props; ++t) {
    const size_t k = static_cast<size_t>(t) * m + w;
    const int a = site_a[k];
    const int b = site_b[k];
    const bool anti = exchange ? (s_cur[a] * s_cur[b] < 0.0f) : true;
    for (int p = tid; p < n; p += blockDim.x) {
      const float v = s_cur[p];
      const bool f = exchange ? (anti && (p == a || p == b)) : (p == a);
      s_prop[p] = f ? -v : v;
    }
    __syncthreads();
    const float lp_prop = forward(s_prop, act0, act1, w_s, b_s, nbr_s, d, n,
                                  taps, red);
    if (tid == 0) {
      const int acc = log_u[k] < 2.0f * (lp_prop - lp);
      if (acc) {
        lp = lp_prop;
        ++n_acc;
      }
      accept_flag = acc;
    }
    __syncthreads();
    if (accept_flag) {
      float* tmp = s_cur;
      s_cur = s_prop;
      s_prop = tmp;
    }
  }
  for (int p = tid; p < n; p += blockDim.x)
    s_out[static_cast<size_t>(w) * n + p] = s_cur[p];
  if (tid == 0) {
    lp_out[w] = lp;
    n_acc_out[w] = n_acc;
  }
}

}  // namespace

// Launches one sweep on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int metropolis_sweep_launch(
    const float* s_in, const float* lp_in, const int* site_a,
    const int* site_b, const float* log_u, const float* weights,
    const float* biases, const int* nbr, float* s_out, float* lp_out,
    int* n_acc_out, int m, int n, int taps, int n_props, int exchange,
    int n_layers, const int* channels, int threads, int smem_bytes,
    void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || threads % 32 != 0 ||
      threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepDims d;
  d.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    d.ch[l] = channels[l];
    d.chp[l] = (channels[l] + kCoBlock - 1) / kCoBlock * kCoBlock;
  }
  if (smem_layout(d, n, taps).total_bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    sweep_kernel<<<m, threads, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
        s_in, lp_in, site_a, site_b, log_u, weights, biases, nbr, s_out,
        lp_out, n_acc_out, m, n, taps, n_props, exchange, d);
  }
  return static_cast<int>(cudaGetLastError());
}
