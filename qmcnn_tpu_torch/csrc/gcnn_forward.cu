// Fused evaluation-only forward of the square-lattice LogPsiGCNN, CUDA C++
// for sm_90a.
//
// Replaces the Pallas TPU kernel `kernel` built by `_make_kernel`
// (qmcnn_tpu/kernels/gcnn_pallas.py, launched by `_group_sums` behind
// `make_fused_log_psi`). For each configuration x [H*W] in {-1, +1} it runs
//   z_0 = act(lift(x) + b_0),
//   z_l = act(gconv(z_{l-1}, W_l) + b_l)   (l = 1 .. L-1),
//   z_l <- (z_l + z_{l-1}) / sqrt(2)       (residual, 0 < l < L-1),
// and writes the per-group-element readout S_g = sum_{p,c} z_{L-1}[p, g*C+c]
// (re, im) for g = 0..7. The group convolutions arrive G-expanded by the
// wrapper: a circular k x k convolution with W = 8*C channels in and out,
// tap-major weights [k*k, W, W]. Complex layers take the direct 4-product
// form (re = xr*wr - xi*wi, im = xr*wi + xi*wr); the lift layer has Cin = 1
// and a real input, so 2 products. The activation is complex lncosh (the
// formula of ops/cplx.lncosh), real lncosh, or selu on re and im.
//
// Design. One thread block per configuration; the grid covers any batch.
// The activations of one configuration, [H*W, W] complex f32, live in
// shared memory as two ping-pong buffers (channel-contiguous per site), so
// the residual reads the layer's own input buffer. Each thread owns a
// register tile of 4 sites x 4 output channels (complex) and walks the
// reduction over (tap, input channel): per 4 input channels it reads 4
// float4 activation vectors per part from shared memory, and per input
// channel one float4 of weights per part from global memory (the expanded
// weights of a 12-layer W = 80 stack are 4.1 MB and stay in L2; neighbouring
// threads read neighbouring words). Circular padding is index arithmetic:
// a [k*k, H*W] table of source sites, built per block. The layer epilogue
// (bias, activation, residual) runs on the f32 accumulators. The readout
// is one warp per group element with a fixed-order shuffle tree, so the
// result is deterministic.
//
// Bound. The work is FP32 FMA bound against 4*H*W input bytes and 64
// output bytes per configuration; nothing but the weights leaves the SM
// between layers. The least arithmetic for the function is 2*9*H*W*W*2
// FLOP for a complex lift and, per complex group layer, 3 real products
// (Karatsuba) = 6*9*H*W*W^2 FLOP plus 4*H*W*W additions; this kernel's
// direct form spends 8*9*H*W*W^2, a third more, to avoid Karatsuba's
// cancellation. Tensor cores (TF32/bf16 wgmma), several configurations per
// block and TMA-fed weight tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTS = 4;  // sites per thread tile
constexpr int kTC = 4;  // output channels per thread tile
constexpr int kGroup = 8;
constexpr float kSkipScale = 0.7071067811865476f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;

enum Activation { kLncosh = 0, kSelu = 1 };

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

struct Layout {
  int plane, parts, x_off, nbr_off, total_bytes;
};

// Shared memory of one block, in 4-byte words: buffers [2][parts][plane],
// the input spins, then the [k*k, H*W] source-site table.
__host__ __device__ inline Layout smem_layout(int hw, int width, int kk,
                                              bool cplx) {
  Layout l;
  l.plane = round4(hw * width);
  l.parts = cplx ? 2 : 1;
  l.x_off = 2 * l.parts * l.plane;
  l.nbr_off = l.x_off + round4(hw);
  l.total_bytes = 4 * (l.nbr_off + kk * hw);
  return l;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ float selu_f(float x) {
  return kSeluScale * (x > 0.0f ? x : kSeluAlpha * expm1f(x));
}

__device__ __forceinline__ float lncosh_real_f(float x) {
  const float t = fabsf(x);
  return t - kLog2 + log1pf(expf(-2.0f * t));
}

// log cosh(re + i im) = t - log 2 + log(1 + e^{-2t}), t = z sign(Re z)
__device__ __forceinline__ void lncosh_c(float& re, float& im) {
  const float s = re >= 0.0f ? 1.0f : -1.0f;
  const float tr = re * s, ti = im * s;
  const float mag = expf(-2.0f * tr);
  float sn, cs;
  sincosf(-2.0f * ti, &sn, &cs);
  const float xr = 1.0f + mag * cs, xi = mag * sn;
  re = tr - kLog2 + 0.5f * logf(xr * xr + xi * xi);
  im = ti + atan2f(xi, xr);
}

template <bool CPLX, int ACT>
__device__ __forceinline__ void activate(float& re, float& im) {
  if (CPLX) {
    if (ACT == kSelu) {
      re = selu_f(re);
      im = selu_f(im);
    } else {
      lncosh_c(re, im);
    }
  } else {
    re = (ACT == kSelu) ? selu_f(re) : lncosh_real_f(re);
  }
}

// Bias, activation and residual on one thread's tile, stored to o_* at
// sites p0.. and channels co0..co0+3; r_re == nullptr means no residual.
template <bool CPLX, int ACT>
__device__ __forceinline__ void epilogue(
    float (&acc_re)[kTS][kTC], float (&acc_im)[kTS][kTC],
    const float* __restrict__ bias_re, const float* __restrict__ bias_im,
    float* o_re, float* o_im, const float* r_re, const float* r_im, int p0,
    int co0, int hw, int width) {
  float br[kTC], bi[kTC];
#pragma unroll
  for (int c = 0; c < kTC; ++c) {
    br[c] = bias_re[co0 + c];
    bi[c] = CPLX ? bias_im[co0 + c] : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kTS; ++s) {
    const int p = p0 + s;
    if (p < hw) {
      float zr[kTC], zi[kTC];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        zr[c] = acc_re[s][c] + br[c];
        zi[c] = CPLX ? acc_im[s][c] + bi[c] : 0.0f;
        activate<CPLX, ACT>(zr[c], zi[c]);
      }
      const int off = p * width + co0;
      if (r_re != nullptr) {
        const float4 rr = *reinterpret_cast<const float4*>(r_re + off);
#pragma unroll
        for (int c = 0; c < kTC; ++c) zr[c] = (zr[c] + comp(rr, c)) * kSkipScale;
        if (CPLX) {
          const float4 ri = *reinterpret_cast<const float4*>(r_im + off);
#pragma unroll
          for (int c = 0; c < kTC; ++c)
            zi[c] = (zi[c] + comp(ri, c)) * kSkipScale;
        }
      }
      *reinterpret_cast<float4*>(o_re + off) =
          make_float4(zr[0], zr[1], zr[2], zr[3]);
      if (CPLX)
        *reinterpret_cast<float4*>(o_im + off) =
            make_float4(zi[0], zi[1], zi[2], zi[3]);
    }
  }
}

template <bool CPLX, int ACT>
__global__ void __launch_bounds__(kMaxThreads) gcnn_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ lift_re,
    const float* __restrict__ lift_im, const float* __restrict__ w_re,
    const float* __restrict__ w_im, const float* __restrict__ b_re,
    const float* __restrict__ b_im, float* __restrict__ out_re,
    float* __restrict__ out_im, int height, int width_lat, int ksize,
    int channels, int n_layers, int residual) {
  extern __shared__ __align__(16) float smem[];
  const int hw = height * width_lat;
  const int width = kGroup * channels;
  const int kk = ksize * ksize;
  const int half = (ksize - 1) / 2;
  const Layout lay = smem_layout(hw, width, kk, CPLX);
  float* buf0_re = smem;
  float* buf0_im = smem + lay.plane;  // used only when CPLX
  float* buf1_re = smem + lay.parts * lay.plane;
  float* buf1_im = buf1_re + lay.plane;
  float* x_s = smem + lay.x_off;
  int* nbr_s = reinterpret_cast<int*>(smem + lay.nbr_off);
  const size_t cfg = blockIdx.x;
  const int tid = threadIdx.x;

  for (int p = tid; p < hw; p += blockDim.x) x_s[p] = x[cfg * hw + p];
  // y[i, j] += x[(i + a - half) mod H, (j + b - half) mod W] w[a, b]
  for (int i = tid; i < kk * hw; i += blockDim.x) {
    const int t = i / hw, p = i - t * hw;
    const int a = t / ksize, b = t - a * ksize;
    const int r = p / width_lat, c = p - r * width_lat;
    nbr_s[i] = ((r + a - half + height) % height) * width_lat +
               (c + b - half + width_lat) % width_lat;
  }
  __syncthreads();

  const int n_ct = width / kTC;
  const int n_tiles = n_ct * ((hw + kTS - 1) / kTS);

  // layer 0: the lift, real input and Cin = 1
  for (int tile = tid; tile < n_tiles; tile += blockDim.x) {
    const int co0 = (tile % n_ct) * kTC, p0 = (tile / n_ct) * kTS;
    float acc_re[kTS][kTC], acc_im[kTS][kTC];
#pragma unroll
    for (int s = 0; s < kTS; ++s)
#pragma unroll
      for (int c = 0; c < kTC; ++c) acc_re[s][c] = acc_im[s][c] = 0.0f;
    for (int t = 0; t < kk; ++t) {
      const float4 wr =
          __ldg(reinterpret_cast<const float4*>(lift_re + t * width + co0));
      float4 wi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (CPLX)
        wi = __ldg(reinterpret_cast<const float4*>(lift_im + t * width + co0));
#pragma unroll
      for (int s = 0; s < kTS; ++s) {
        const int p = min(p0 + s, hw - 1);
        const float xv = x_s[nbr_s[t * hw + p]];
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          acc_re[s][c] = fmaf(xv, comp(wr, c), acc_re[s][c]);
          if (CPLX) acc_im[s][c] = fmaf(xv, comp(wi, c), acc_im[s][c]);
        }
      }
    }
    epilogue<CPLX, ACT>(acc_re, acc_im, b_re, b_im, buf0_re, buf0_im,
                        nullptr, nullptr, p0, co0, hw, width);
  }
  __syncthreads();

  // layers 1 .. L-1: G-expanded group convolutions, W -> W channels
  for (int l = 1; l < n_layers; ++l) {
    const bool odd = l & 1;
    const float* in_re = odd ? buf0_re : buf1_re;
    const float* in_im = odd ? buf0_im : buf1_im;
    float* o_re = odd ? buf1_re : buf0_re;
    float* o_im = odd ? buf1_im : buf0_im;
    const size_t layer_off = static_cast<size_t>(l - 1) * kk * width * width;
    const float* wl_re = w_re + layer_off;
    const float* wl_im = CPLX ? w_im + layer_off : nullptr;
    const bool skip = residual && l < n_layers - 1;
    for (int tile = tid; tile < n_tiles; tile += blockDim.x) {
      const int co0 = (tile % n_ct) * kTC, p0 = (tile / n_ct) * kTS;
      float acc_re[kTS][kTC], acc_im[kTS][kTC];
#pragma unroll
      for (int s = 0; s < kTS; ++s)
#pragma unroll
        for (int c = 0; c < kTC; ++c) acc_re[s][c] = acc_im[s][c] = 0.0f;
      for (int t = 0; t < kk; ++t) {
        int q[kTS];
#pragma unroll
        for (int s = 0; s < kTS; ++s)
          q[s] = nbr_s[t * hw + min(p0 + s, hw - 1)] * width;
        const float* wt_re = wl_re + static_cast<size_t>(t) * width * width + co0;
        const float* wt_im =
            CPLX ? wl_im + static_cast<size_t>(t) * width * width + co0 : nullptr;
        for (int ci = 0; ci < width; ci += 4) {
          float4 xr[kTS], xi[kTS];
#pragma unroll
          for (int s = 0; s < kTS; ++s) {
            xr[s] = *reinterpret_cast<const float4*>(in_re + q[s] + ci);
            if (CPLX) xi[s] = *reinterpret_cast<const float4*>(in_im + q[s] + ci);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wr = __ldg(
                reinterpret_cast<const float4*>(wt_re + (ci + j) * width));
            float4 wi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (CPLX)
              wi = __ldg(
                  reinterpret_cast<const float4*>(wt_im + (ci + j) * width));
#pragma unroll
            for (int s = 0; s < kTS; ++s) {
              const float ar = comp(xr[s], j);
              if (CPLX) {
                const float ai = comp(xi[s], j);
#pragma unroll
                for (int c = 0; c < kTC; ++c) {
                  acc_re[s][c] = fmaf(ar, comp(wr, c), acc_re[s][c]);
                  acc_re[s][c] = fmaf(-ai, comp(wi, c), acc_re[s][c]);
                  acc_im[s][c] = fmaf(ar, comp(wi, c), acc_im[s][c]);
                  acc_im[s][c] = fmaf(ai, comp(wr, c), acc_im[s][c]);
                }
              } else {
#pragma unroll
                for (int c = 0; c < kTC; ++c)
                  acc_re[s][c] = fmaf(ar, comp(wr, c), acc_re[s][c]);
              }
            }
          }
        }
      }
      epilogue<CPLX, ACT>(acc_re, acc_im, b_re + l * width,
                          CPLX ? b_im + l * width : nullptr, o_re, o_im,
                          skip ? in_re : nullptr, skip ? in_im : nullptr, p0,
                          co0, hw, width);
    }
    __syncthreads();
  }

  // readout: S_g = sum over sites and the C channels of element g, one
  // warp per element, lanes in a fixed order, then a shuffle tree
  const bool last_odd = (n_layers - 1) & 1;
  const float* f_re = last_odd ? buf1_re : buf0_re;
  const float* f_im = last_odd ? buf1_im : buf0_im;
  const int lane = tid & 31, n_warps = blockDim.x >> 5;
  const int per_g = hw * channels;
  for (int g = tid >> 5; g < kGroup; g += n_warps) {
    float sr = 0.0f, si = 0.0f;
    for (int i = lane; i < per_g; i += 32) {
      const int p = i / channels, c = i - p * channels;
      const int idx = p * width + g * channels + c;
      sr += f_re[idx];
      if (CPLX) si += f_im[idx];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_down_sync(0xffffffffu, sr, off);
      si += __shfl_down_sync(0xffffffffu, si, off);
    }
    if (lane == 0) {
      out_re[cfg * kGroup + g] = sr;
      out_im[cfg * kGroup + g] = CPLX ? si : 0.0f;
    }
  }
}

template <bool CPLX, int ACT>
int launch(const float* x, const float* lift_re, const float* lift_im,
           const float* w_re, const float* w_im, const float* b_re,
           const float* b_im, float* out_re, float* out_im, int batch,
           int height, int width_lat, int ksize, int channels, int n_layers,
           int residual, int threads, int smem_bytes, cudaStream_t stream) {
  const int hw = height * width_lat;
  const Layout lay = smem_layout(hw, kGroup * channels, ksize * ksize, CPLX);
  if (lay.total_bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gcnn_forward_kernel<CPLX, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch > 0) {
    gcnn_forward_kernel<CPLX, ACT><<<batch, threads, smem_bytes, stream>>>(
        x, lift_re, lift_im, w_re, w_im, b_re, b_im, out_re, out_im, height,
        width_lat, ksize, channels, n_layers, residual);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward of `batch` configurations on `stream`; returns
// cudaGetLastError() (0 = success). activation: 0 lncosh, 1 selu.
extern "C" int gcnn_forward_launch(
    const float* x, const float* lift_re, const float* lift_im,
    const float* w_re, const float* w_im, const float* b_re,
    const float* b_im, float* out_re, float* out_im, int batch, int height,
    int width_lat, int ksize, int channels, int n_layers, int complex_params,
    int activation, int residual, int threads, int smem_bytes,
    void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads ||
      channels < 1 || n_layers < 1 || ksize < 1 || ksize % 2 == 0 ||
      ksize > height || ksize > width_lat || batch < 0 ||
      (activation != kLncosh && activation != kSelu))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMCNN_GCNN_LAUNCH(CP, AC)                                            \
  return launch<CP, AC>(x, lift_re, lift_im, w_re, w_im, b_re, b_im, out_re, \
                        out_im, batch, height, width_lat, ksize, channels,   \
                        n_layers, residual, threads, smem_bytes, s)
  if (complex_params) {
    if (activation == kSelu) QMCNN_GCNN_LAUNCH(true, kSelu);
    QMCNN_GCNN_LAUNCH(true, kLncosh);
  }
  if (activation == kSelu) QMCNN_GCNN_LAUNCH(false, kSelu);
  QMCNN_GCNN_LAUNCH(false, kLncosh);
#undef QMCNN_GCNN_LAUNCH
}
