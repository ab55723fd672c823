// Fused evaluation-only forward of the square-lattice LogPsiGCNN, CUDA C++
// for sm_90a, with the group convolutions on the tensor cores: in
// error-compensated TF32 (3xTF32) on the float32 route, in bf16 on the
// bfloat16 route (the TPU kernel's dtype_name = "bfloat16"; see "The bf16
// route" below).
//
// Replaces the Pallas TPU kernel `kernel` built by `_make_kernel`
// (qmcnn_tpu/kernels/gcnn_pallas.py:259, launched by `_group_sums` behind
// `make_fused_log_psi`). For each configuration x [H*W] in {-1, +1} it runs
//   z_0 = act(lift(x) + b_0),
//   z_l = act(gconv(z_{l-1}, W_l) + b_l)   (l = 1 .. L-1),
//   z_l <- (z_l + z_{l-1}) / sqrt(2)       (residual, 0 < l < L-1),
// and writes the per-group-element readout S_g = sum_{p,c} z_{L-1}[p, g*C+c]
// (re, im) for g = 0..7. The group convolutions arrive G-expanded: a
// circular k x k convolution with W = 8*C channels in and out. Complex
// layers take the direct 4-product form (re = xr*wr - xi*wi,
// im = xr*wi + xi*wr); the lift layer has Cin = 1 and a real input. The
// activation is complex lncosh (the formula of ops/cplx.lncosh), real
// lncosh, or selu on re and im.
//
// Design. A block holds n_cfg configurations (as many as shared memory
// takes, chosen by the wrapper), their activations [n_cfg*H*W rows, W]
// per part in two ping-pong buffers; a row is padded to W + 4 words so the
// rows of an mma fragment spread over the banks. Circular padding is a
// [k*k, rows] table of source rows. The lift (Cin = 1, ~0.4% of the work)
// runs on the CUDA cores. Each group layer is one GEMM,
//   [yr | yi] = sum_taps gather_t([xr | xi]) . [[wr, wi], [-wi, wr]],
// rows = sites of the block's configurations, K = k*k*W, N = W, issued as
// mma.sync.m16n8k8 TF32 by warps that each own up to kRowTiles 16-row
// tiles x kColTiles 8-column tiles and walk the whole K; a warp splits an
// activation once for its kColTiles column tiles. A fragments come from
// the activation buffer through the source-row table (the tap shift is a
// row gather); B fragments come from global memory (L2-resident, and
// shared in L1 by the warps of the other row tiles) in a fragment-native
// layout the wrapper builds once per parameter update
// (`pack_group_weights`: per tap, k step, column tile and lane one 16-byte
// word of hi/lo pairs). Every product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// with x = hi + lo in TF32 parts: the weights split by the wrapper (both
// parts rounded to nearest), an activation on load (hi rounded to nearest
// as cvt.rna.tf32.f32 rounds, lo = x - hi exactly, of which the tensor
// cores read the top 11 bits: hi + lo within 2^-21 of x). A TF32 product is
// exact in f32. The tensor cores truncate their sums, so each k step (8
// input channels) sums into fresh registers that are added to the f32
// accumulators with round-to-nearest; summed over a whole K in one
// accumulator the truncation drifts toward zero (1e-4 relative after 12
// layers). So the sums keep the f32 contract of the TPU kernel's
// Precision.HIGHEST. The main loop has no branch (ragged tiles are
// computed on clamped rows and dropped), so the compiler schedules a k
// step as one block. The epilogue (bias, activation, residual) runs on
// the accumulator fragments; the readout is one warp per (configuration,
// group element) with a fixed-order shuffle tree, so the result is
// bitwise repeatable.
//
// Bound. Per configuration the least work is 2*9*H*W*W*parts FLOP for the
// lift and, per complex group layer, 3 real products (Karatsuba) =
// 6*9*H*W*W^2 FLOP plus 4*H*W*W additions, against 4*H*W bytes in and 64
// out: operations bound. On the tensor cores an f32-accurate product costs
// three TF32 passes, so the bound is 3 x that FLOP count at the 495 TFLOP/s
// dense TF32 peak (about 2.5x the 67 TFLOP/s of the FP32 cores). This
// kernel spends 4/3 of it (the direct form, to avoid Karatsuba's
// cancellation) through mma.sync, which reaches only part of the wgmma
// rate, and the instructions beside the mma (split, per-step sums, loads,
// activations) compete with it for issue slots.
//
// Why mma.sync and not wgmma. The A operand of a layer is the activation
// buffer gathered by tap: row p of tap t is site nbr[t][p], which is no
// strided tile a wgmma shared-memory descriptor can address, and staging
// each tap's gathered tile would need shared memory the n_cfg buffers use.
// mma.sync takes A from registers loaded by any address. Next: wgmma with
// A from registers and the weight tiles fed by TMA into a small ring (it
// runs asynchronously beside the split and the sums), Karatsuba (3 complex
// products instead of 4) on the tensor cores, and one lattice tiled across
// a cluster for configurations above one block's shared memory (16x16 at
// W = 80).
//
// The bf16 route (gcnn_forward_bf16_kernel) computes what the TPU kernel
// computes at dtype_name = "bfloat16" (gcnn_pallas.py:235-300): the
// weights rounded once to bf16 (by the wrapper, `pack_group_weights_bf16`,
// as bf16 in m16n8k16 fragment order: a single part, no hi/lo split; the
// lift's on load), activations stored as bf16 in shared memory, each
// product of bf16 values exact and summed in f32 (mma.sync.m16n8k16 bf16
// with f32 accumulation; each k step of 16 channels into fresh registers
// added in f32 round-to-nearest, as on the float32 route), the f32 bias
// added on the accumulator and the activation computed in f32, rounded once
// to bf16 (to nearest even), the residual skip as the TPU kernel's bf16
// arithmetic rounds it under XLA (z + z_in rounded to bf16, times
// bf16(1/sqrt 2) = 0.70703125, rounded again), and the readout summed in
// f32 from the bf16 activations. A row holds Kp = W rounded up to 16 bf16
// values (the padding zero) plus 8 of padding, so a block takes twice the
// configurations of the float32 route (4 at 8x8, W = 80: 190,464 bytes).
// Its bound is the least FLOP at the dense bf16 tensor-core rate (989
// TFLOP/s): one pass per product instead of three TF32 passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kRowTiles = 2;  // 16-row mma tiles per warp task, at most
constexpr int kColTiles = 4;  // 8-column mma tiles per warp task
constexpr int kGroup = 8;
constexpr float kSkipScale = 0.7071067811865476f;
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kSeluAlpha = 1.6732632423543772f;

enum Activation { kLncosh = 0, kSelu = 1 };
enum Dtype { kFloat32 = 0, kBfloat16 = 1 };
// 1/sqrt(2) rounded to bf16, as XLA multiplies a bf16 array by the Python
// float 0.7071067811865476
constexpr float kSkipScaleBf16 = 0.70703125f;

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

struct Layout {
  int rows, stride, plane, parts, x_off, src_off, total_bytes;
};

// Shared memory of one block, in 4-byte words: buffers [2][parts][plane]
// (plane = rows x (W + 4) words, rows = n_cfg*H*W), the input spins, then
// the [k*k, rows] table of source rows.
__host__ __device__ inline Layout smem_layout(int hw, int width, int kk,
                                              bool cplx, int n_cfg) {
  Layout l;
  l.rows = n_cfg * hw;
  l.stride = width + 4;
  l.plane = l.rows * l.stride;
  l.parts = cplx ? 2 : 1;
  l.x_off = 2 * l.parts * l.plane;
  l.src_off = l.x_off + round4(l.rows);
  l.total_bytes = 4 * (l.src_off + kk * l.rows);
  return l;
}

// The bf16 route's shared memory, in bytes: buffers [2][parts][plane] of
// bf16 (plane = rows x stride values, stride = Kp + 8 with Kp = W rounded up
// to 16), the input spins (f32), then the [k*k, rows] table of source rows.
struct LayoutBf16 {
  int rows, kpad, stride, plane, parts, x_off, src_off, total_bytes;
};

__host__ __device__ inline LayoutBf16 smem_layout_bf16(int hw, int width,
                                                       int kk, bool cplx,
                                                       int n_cfg) {
  LayoutBf16 l;
  l.rows = n_cfg * hw;
  l.kpad = (width + 15) / 16 * 16;
  l.stride = l.kpad + 8;
  l.plane = l.rows * l.stride;
  l.parts = cplx ? 2 : 1;
  l.x_off = 2 * 2 * l.parts * l.plane;
  l.src_off = l.x_off + 4 * round4(l.rows);
  l.total_bytes = l.src_off + 4 * kk * l.rows;
  return l;
}

// x rounded to bf16 (to nearest even), as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// x rounded to TF32 (the low 13 mantissa bits zero), to nearest with ties
// away from zero: cvt.rna.tf32.f32 for finite x, in two integer operations
// (the conversion unit runs at a quarter of their rate)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi is x rounded to TF32, lo = x - hi exactly (in f32);
// the tensor cores read lo's top 11 significant bits, so hi + lo holds x
// within 2^-21 relative, with the sign of the error at random
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on one 16x8x8 tile: a row-major 16x8, b column-major 8x8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, small terms first; b = (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint4& b) {
  mma_tf32(d, a_lo, b.x, b.y);
  mma_tf32(d, a_hi, b.z, b.w);
  mma_tf32(d, a_hi, b.x, b.y);
}

__device__ __forceinline__ uint4 negate(const uint4& b) {
  const uint32_t s = 0x80000000u;
  return make_uint4(b.x ^ s, b.y ^ s, b.z ^ s, b.w ^ s);
}

// A fragment of one 16x8 tile in TF32 hi/lo parts: rows g and g+8 at the
// word offsets o0, o1 (source row * stride + 2 tig). The k order within a
// step is permuted so that a lane's k = tig and tig + 4 are the channels
// 2 tig and 2 tig + 1, one 8-byte load (the packed weights follow it).
__device__ __forceinline__ void load_a(const float* src, int o0, int o1,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 v0 = *reinterpret_cast<const float2*>(src + o0);
  const float2 v1 = *reinterpret_cast<const float2*>(src + o1);
  tf32_split(v0.x, hi[0], lo[0]);
  tf32_split(v1.x, hi[1], lo[1]);
  tf32_split(v0.y, hi[2], lo[2]);
  tf32_split(v1.y, hi[3], lo[3]);
}

// The block's input spins, and for each tap t and row (configuration,
// site) of the block the row it reads:
// y[i, j] += x[(i + a - half) mod H, (j + b - half) mod W] w[a, b]
__device__ __forceinline__ void load_block(const float* __restrict__ x,
                                           size_t cfg0, int rows,
                                           int max_rows, int hw, int kk,
                                           int ksize, int height,
                                           int width_lat, float* x_s,
                                           int* src_s) {
  const int half = (ksize - 1) / 2;
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    x_s[i] = x[cfg0 * hw + i];
  for (int i = threadIdx.x; i < kk * rows; i += blockDim.x) {
    const int t = i / rows, row = i - t * rows;
    const int p = row % hw;
    const int a = t / ksize, b = t - a * ksize;
    const int r = p / width_lat, c = p - r * width_lat;
    src_s[t * max_rows + row] =
        row - p + ((r + a - half + height) % height) * width_lat +
        (c + b - half + width_lat) % width_lat;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// readout: S_g = sum over sites and the C channels of element g of the
// last layer's activations f (summed in f32), one warp per (configuration,
// element), lanes in a fixed order, then a shuffle tree
template <bool CPLX, typename T>
__device__ __forceinline__ void readout(const T* f, int plane, int stride,
                                        int hw, int channels, int n_here,
                                        size_t cfg0, float* out_re,
                                        float* out_im) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per_g = hw * channels;
  for (int task = warp; task < n_here * kGroup; task += n_warps) {
    const int c = task / kGroup, e = task - c * kGroup;
    float sr = 0.0f, si = 0.0f;
    for (int i = lane; i < per_g; i += 32) {
      const int p = i / channels, ch = i - p * channels;
      const int idx = (c * hw + p) * stride + e * channels + ch;
      sr += to_f32(f[idx]);
      if (CPLX) si += to_f32(f[plane + idx]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sr += __shfl_down_sync(0xffffffffu, sr, o);
      si += __shfl_down_sync(0xffffffffu, si, o);
    }
    if (lane == 0) {
      out_re[(cfg0 + c) * kGroup + e] = sr;
      out_im[(cfg0 + c) * kGroup + e] = CPLX ? si : 0.0f;
    }
  }
}

template <bool CPLX, int ACT>
__global__ void __launch_bounds__(kMaxThreads, 1) gcnn_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ lift_re,
    const float* __restrict__ lift_im, const uint4* __restrict__ wf_re,
    const uint4* __restrict__ wf_im, const float* __restrict__ b_re,
    const float* __restrict__ b_im, float* __restrict__ out_re,
    float* __restrict__ out_im, int batch, int n_cfg, int height,
    int width_lat, int ksize, int channels, int n_layers, int residual) {
  extern __shared__ __align__(16) float smem[];
  const int hw = height * width_lat;
  const int width = kGroup * channels;
  const int kk = ksize * ksize;
  const Layout lay = smem_layout(hw, width, kk, CPLX, n_cfg);
  const int stride = lay.stride, plane = lay.plane, max_rows = lay.rows;
  float* const buf0 = smem;  // re plane; the im plane follows it
  float* const buf1 = smem + lay.parts * plane;
  float* x_s = smem + lay.x_off;
  int* src_s = reinterpret_cast<int*>(smem + lay.src_off);
  const size_t cfg0 = static_cast<size_t>(blockIdx.x) * n_cfg;
  const int n_here = min(n_cfg, batch - static_cast<int>(cfg0));
  const int rows = n_here * hw;
  const int tid = threadIdx.x;

  load_block(x, cfg0, rows, max_rows, hw, kk, ksize, height, width_lat, x_s,
             src_s);
  __syncthreads();

  // layer 0: the lift on the CUDA cores, one output element per step
  for (int i = tid; i < rows * width; i += blockDim.x) {
    const int row = i / width, co = i - row * width;
    float zr = 0.0f, zi = 0.0f;
    for (int t = 0; t < kk; ++t) {
      const float xv = x_s[src_s[t * max_rows + row]];
      zr = fmaf(xv, __ldg(lift_re + t * width + co), zr);
      if (CPLX) zi = fmaf(xv, __ldg(lift_im + t * width + co), zi);
    }
    zr += __ldg(b_re + co);
    if (CPLX) zi += __ldg(b_im + co);
    activate<CPLX, ACT>(zr, zi);
    buf0[row * stride + co] = zr;
    if (CPLX) buf0[plane + row * stride + co] = zi;
  }
  __syncthreads();

  // layers 1 .. L-1 on the tensor cores. Warp tasks: a group of row tiles
  // (balanced over the block's rows) x kColTiles column tiles.
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n_row_tiles = (rows + 15) / 16;
  const int n_row_groups = (n_row_tiles + kRowTiles - 1) / kRowTiles;
  const int group_tiles = (n_row_tiles + n_row_groups - 1) / n_row_groups;
  const int n_col_tiles = width / 8;
  const int n_col_groups = (n_col_tiles + kColTiles - 1) / kColTiles;
  const int n_tasks = n_row_groups * n_col_groups;
  const int k_steps = width / 8;  // per tap
  const int n_steps = kk * k_steps;
  const size_t layer_words = static_cast<size_t>(n_steps) * n_col_tiles * 32;
  for (int l = 1; l < n_layers; ++l) {
    const float* in = (l & 1) ? buf0 : buf1;
    float* out = (l & 1) ? buf1 : buf0;
    const uint4* wl_re = wf_re + (l - 1) * layer_words;
    const uint4* wl_im = CPLX ? wf_im + (l - 1) * layer_words : nullptr;
    const float* bl_re = b_re + l * width;
    const float* bl_im = CPLX ? b_im + l * width : nullptr;
    const bool skip = residual && l < n_layers - 1;
    for (int task = warp; task < n_tasks; task += n_warps) {
      const int rg = task / n_col_groups;
      const int rt0 = rg * group_tiles;
      const int n_rt = min(group_tiles, n_row_tiles - rt0);
      const int ct0 = (task - rg * n_col_groups) * kColTiles;
      const int n_ct = min(kColTiles, n_col_tiles - ct0);
      float acc_re[kRowTiles][kColTiles][4];
      float acc_im[kRowTiles][kColTiles][4];
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
        for (int c = 0; c < kColTiles; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_re[r][c][j] = acc_im[r][c][j] = 0.0f;

      // the main loop has no branch on the tile counts, so that it stays
      // one block for the scheduler: tiles past the task's rows (clamped)
      // or columns (the last column tile again) are computed and dropped
      int col[kColTiles];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c)
        col[c] = min(ct0 + c, n_col_tiles - 1) * 32 + lane;
      for (int t = 0; t < kk; ++t) {
        // word offsets of this lane's A elements: rows g and g + 8 of
        // each tile (clamped into the block's rows), columns 2 tig, +1
        int off[kRowTiles][2];
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = min((rt0 + r) * 16 + g + 8 * h, rows - 1);
            off[r][h] = src_s[t * max_rows + row] * stride + 2 * tig;
          }
        for (int ks = 0; ks < k_steps; ++ks) {
          const size_t step =
              static_cast<size_t>(t * k_steps + ks) * n_col_tiles * 32;
          uint4 wr[kColTiles], wi[kColTiles];
#pragma unroll
          for (int c = 0; c < kColTiles; ++c) {
            wr[c] = __ldg(wl_re + step + col[c]);
            wi[c] = CPLX ? __ldg(wl_im + step + col[c]) : wr[c];
          }
          const int c0 = ks * 8;
#pragma unroll
          for (int r = 0; r < kRowTiles; ++r) {
            uint32_t ar_hi[4], ar_lo[4], ai_hi[4], ai_lo[4];
            load_a(in + c0, off[r][0], off[r][1], ar_hi, ar_lo);
            if (CPLX)
              load_a(in + plane + c0, off[r][0], off[r][1], ai_hi, ai_lo);
            // each k step sums into fresh registers, added to the
            // accumulators in f32 round-to-nearest: the tensor cores
            // truncate their sums, which over a whole K in one accumulator
            // drifts toward zero
#pragma unroll
            for (int c = 0; c < kColTiles; ++c) {
              float pr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              float pi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_3xtf32(pr, ar_hi, ar_lo, wr[c]);
              if (CPLX) {
                mma_3xtf32(pr, ai_hi, ai_lo, negate(wi[c]));
                mma_3xtf32(pi, ar_hi, ar_lo, wi[c]);
                mma_3xtf32(pi, ai_hi, ai_lo, wr[c]);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc_re[r][c][j] += pr[j];
                if (CPLX) acc_im[r][c][j] += pi[j];
              }
            }
          }
        }
      }

      // epilogue: the accumulator fragment holds rows g, g + 8 and columns
      // 2 tig, 2 tig + 1 of each tile
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
#pragma unroll
        for (int c = 0; c < kColTiles; ++c) {
          if (r < n_rt && c < n_ct) {
            const int col = (ct0 + c) * 8 + 2 * tig;
            const float br0 = __ldg(bl_re + col), br1 = __ldg(bl_re + col + 1);
            const float bi0 = CPLX ? __ldg(bl_im + col) : 0.0f;
            const float bi1 = CPLX ? __ldg(bl_im + col + 1) : 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = (rt0 + r) * 16 + g + 8 * h;
              if (row < rows) {
                float zr0 = acc_re[r][c][2 * h] + br0;
                float zr1 = acc_re[r][c][2 * h + 1] + br1;
                float zi0 = CPLX ? acc_im[r][c][2 * h] + bi0 : 0.0f;
                float zi1 = CPLX ? acc_im[r][c][2 * h + 1] + bi1 : 0.0f;
                activate<CPLX, ACT>(zr0, zi0);
                activate<CPLX, ACT>(zr1, zi1);
                const int o = row * stride + col;
                if (skip) {
                  const float2 rr = *reinterpret_cast<const float2*>(in + o);
                  zr0 = (zr0 + rr.x) * kSkipScale;
                  zr1 = (zr1 + rr.y) * kSkipScale;
                  if (CPLX) {
                    const float2 ri =
                        *reinterpret_cast<const float2*>(in + plane + o);
                    zi0 = (zi0 + ri.x) * kSkipScale;
                    zi1 = (zi1 + ri.y) * kSkipScale;
                  }
                }
                *reinterpret_cast<float2*>(out + o) = make_float2(zr0, zr1);
                if (CPLX)
                  *reinterpret_cast<float2*>(out + plane + o) =
                      make_float2(zi0, zi1);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  readout<CPLX>(((n_layers - 1) & 1) ? buf1 : buf0, plane, stride, hw,
                channels, n_here, cfg0, out_re, out_im);
}

// d += a b on one 16x8x16 tile of bf16 values: a row-major 16x16, b
// column-major 16x8, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of one 16x16 bf16 tile: rows g and g+8 at the value offsets
// o0, o1 (source row * stride + 4 tig). The k order within a step is
// permuted so that a lane's k = 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 are
// the channels 4 tig .. 4 tig + 3, one 8-byte load per row (the packed
// weights follow it).
__device__ __forceinline__ void load_a_bf16(const __nv_bfloat16* src, int o0,
                                            int o1, uint32_t (&a)[4]) {
  const uint2 v0 = *reinterpret_cast<const uint2*>(src + o0);
  const uint2 v1 = *reinterpret_cast<const uint2*>(src + o1);
  a[0] = v0.x;
  a[1] = v1.x;
  a[2] = v0.y;
  a[3] = v1.y;
}

__device__ __forceinline__ uint2 negate_bf16(const uint2& b) {
  const uint32_t s = 0x80008000u;
  return make_uint2(b.x ^ s, b.y ^ s);
}

template <bool CPLX, int ACT>
__global__ void __launch_bounds__(kMaxThreads, 1) gcnn_forward_bf16_kernel(
    const float* __restrict__ x, const float* __restrict__ lift_re,
    const float* __restrict__ lift_im, const uint2* __restrict__ wf_re,
    const uint2* __restrict__ wf_im, const float* __restrict__ b_re,
    const float* __restrict__ b_im, float* __restrict__ out_re,
    float* __restrict__ out_im, int batch, int n_cfg, int height,
    int width_lat, int ksize, int channels, int n_layers, int residual) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = height * width_lat;
  const int width = kGroup * channels;
  const int kk = ksize * ksize;
  const LayoutBf16 lay = smem_layout_bf16(hw, width, kk, CPLX, n_cfg);
  const int stride = lay.stride, plane = lay.plane, max_rows = lay.rows;
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const buf1 = buf0 + lay.parts * plane;
  float* x_s = reinterpret_cast<float*>(smem_raw + lay.x_off);
  int* src_s = reinterpret_cast<int*>(smem_raw + lay.src_off);
  const size_t cfg0 = static_cast<size_t>(blockIdx.x) * n_cfg;
  const int n_here = min(n_cfg, batch - static_cast<int>(cfg0));
  const int rows = n_here * hw;
  const int tid = threadIdx.x;

  load_block(x, cfg0, rows, max_rows, hw, kk, ksize, height, width_lat, x_s,
             src_s);
  // the padded input channels [W, Kp) of every row are read by the last k
  // step (against zero weights): keep them zero in both buffers
  const int n_pad = lay.kpad - width;
  if (n_pad > 0)
    for (int i = tid; i < 2 * lay.parts * rows * n_pad; i += blockDim.x) {
      const int plane_i = i / (rows * n_pad), rem = i - plane_i * rows * n_pad;
      const int row = rem / n_pad, c = width + rem - row * n_pad;
      buf0[plane_i * plane + row * stride + c] = __float2bfloat16_rn(0.0f);
    }
  __syncthreads();

  // layer 0: the lift on the CUDA cores (weights rounded to bf16 on load;
  // a product of +-1 and a bf16 value is exact, summed in tap order in f32
  // as the TPU kernel sums its taps), rounded once to bf16
  for (int i = tid; i < rows * width; i += blockDim.x) {
    const int row = i / width, co = i - row * width;
    float zr = 0.0f, zi = 0.0f;
    for (int t = 0; t < kk; ++t) {
      const float xv = x_s[src_s[t * max_rows + row]];
      zr = fmaf(xv, bf16_round(__ldg(lift_re + t * width + co)), zr);
      if (CPLX) zi = fmaf(xv, bf16_round(__ldg(lift_im + t * width + co)), zi);
    }
    zr += __ldg(b_re + co);
    if (CPLX) zi += __ldg(b_im + co);
    activate<CPLX, ACT>(zr, zi);
    buf0[row * stride + co] = __float2bfloat16_rn(zr);
    if (CPLX) buf0[plane + row * stride + co] = __float2bfloat16_rn(zi);
  }
  __syncthreads();

  // layers 1 .. L-1 on the tensor cores, warp tasks as on the f32 route
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n_row_tiles = (rows + 15) / 16;
  const int n_row_groups = (n_row_tiles + kRowTiles - 1) / kRowTiles;
  const int group_tiles = (n_row_tiles + n_row_groups - 1) / n_row_groups;
  const int n_col_tiles = width / 8;
  const int n_col_groups = (n_col_tiles + kColTiles - 1) / kColTiles;
  const int n_tasks = n_row_groups * n_col_groups;
  const int k_steps = lay.kpad / 16;  // per tap
  const int n_steps = kk * k_steps;
  const size_t layer_words = static_cast<size_t>(n_steps) * n_col_tiles * 32;
  for (int l = 1; l < n_layers; ++l) {
    const __nv_bfloat16* in = (l & 1) ? buf0 : buf1;
    __nv_bfloat16* out = (l & 1) ? buf1 : buf0;
    const uint2* wl_re = wf_re + (l - 1) * layer_words;
    const uint2* wl_im = CPLX ? wf_im + (l - 1) * layer_words : nullptr;
    const float* bl_re = b_re + l * width;
    const float* bl_im = CPLX ? b_im + l * width : nullptr;
    const bool skip = residual && l < n_layers - 1;
    for (int task = warp; task < n_tasks; task += n_warps) {
      const int rg = task / n_col_groups;
      const int rt0 = rg * group_tiles;
      const int n_rt = min(group_tiles, n_row_tiles - rt0);
      const int ct0 = (task - rg * n_col_groups) * kColTiles;
      const int n_ct = min(kColTiles, n_col_tiles - ct0);
      float acc_re[kRowTiles][kColTiles][4];
      float acc_im[kRowTiles][kColTiles][4];
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
        for (int c = 0; c < kColTiles; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_re[r][c][j] = acc_im[r][c][j] = 0.0f;

      int col[kColTiles];
#pragma unroll
      for (int c = 0; c < kColTiles; ++c)
        col[c] = min(ct0 + c, n_col_tiles - 1) * 32 + lane;
      for (int t = 0; t < kk; ++t) {
        int off[kRowTiles][2];
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = min((rt0 + r) * 16 + g + 8 * h, rows - 1);
            off[r][h] = src_s[t * max_rows + row] * stride + 4 * tig;
          }
        for (int ks = 0; ks < k_steps; ++ks) {
          const size_t step =
              static_cast<size_t>(t * k_steps + ks) * n_col_tiles * 32;
          uint2 wr[kColTiles], wi[kColTiles];
#pragma unroll
          for (int c = 0; c < kColTiles; ++c) {
            wr[c] = __ldg(wl_re + step + col[c]);
            wi[c] = CPLX ? __ldg(wl_im + step + col[c]) : wr[c];
          }
          const int c0 = ks * 16;
#pragma unroll
          for (int r = 0; r < kRowTiles; ++r) {
            uint32_t ar[4], ai[4];
            load_a_bf16(in + c0, off[r][0], off[r][1], ar);
            if (CPLX) load_a_bf16(in + plane + c0, off[r][0], off[r][1], ai);
            // each k step sums into fresh registers, added to the
            // accumulators in f32 round-to-nearest
#pragma unroll
            for (int c = 0; c < kColTiles; ++c) {
              float pr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              float pi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(pr, ar, wr[c].x, wr[c].y);
              if (CPLX) {
                const uint2 wn = negate_bf16(wi[c]);
                mma_bf16(pr, ai, wn.x, wn.y);
                mma_bf16(pi, ar, wi[c].x, wi[c].y);
                mma_bf16(pi, ai, wr[c].x, wr[c].y);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc_re[r][c][j] += pr[j];
                if (CPLX) acc_im[r][c][j] += pi[j];
              }
            }
          }
        }
      }

      // epilogue: f32 bias and activation on the accumulator fragment
      // (rows g, g + 8; columns 2 tig, 2 tig + 1 of each tile), one
      // rounding to bf16, then the bf16 residual skip
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r) {
#pragma unroll
        for (int c = 0; c < kColTiles; ++c) {
          if (r < n_rt && c < n_ct) {
            const int col = (ct0 + c) * 8 + 2 * tig;
            const float br0 = __ldg(bl_re + col), br1 = __ldg(bl_re + col + 1);
            const float bi0 = CPLX ? __ldg(bl_im + col) : 0.0f;
            const float bi1 = CPLX ? __ldg(bl_im + col + 1) : 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = (rt0 + r) * 16 + g + 8 * h;
              if (row < rows) {
                float zr0 = acc_re[r][c][2 * h] + br0;
                float zr1 = acc_re[r][c][2 * h + 1] + br1;
                float zi0 = CPLX ? acc_im[r][c][2 * h] + bi0 : 0.0f;
                float zi1 = CPLX ? acc_im[r][c][2 * h + 1] + bi1 : 0.0f;
                activate<CPLX, ACT>(zr0, zi0);
                activate<CPLX, ACT>(zr1, zi1);
                zr0 = bf16_round(zr0);
                zr1 = bf16_round(zr1);
                zi0 = bf16_round(zi0);
                zi1 = bf16_round(zi1);
                const int o = row * stride + col;
                if (skip) {
                  const float2 rr = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(in + o));
                  zr0 = bf16_round(bf16_round(zr0 + rr.x) * kSkipScaleBf16);
                  zr1 = bf16_round(bf16_round(zr1 + rr.y) * kSkipScaleBf16);
                  if (CPLX) {
                    const float2 ri = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(in + plane +
                                                                 o));
                    zi0 = bf16_round(bf16_round(zi0 + ri.x) * kSkipScaleBf16);
                    zi1 = bf16_round(bf16_round(zi1 + ri.y) * kSkipScaleBf16);
                  }
                }
                *reinterpret_cast<__nv_bfloat162*>(out + o) =
                    __floats2bfloat162_rn(zr0, zr1);
                if (CPLX)
                  *reinterpret_cast<__nv_bfloat162*>(out + plane + o) =
                      __floats2bfloat162_rn(zi0, zi1);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  readout<CPLX>(((n_layers - 1) & 1) ? buf1 : buf0, plane, stride, hw,
                channels, n_here, cfg0, out_re, out_im);
}

template <bool CPLX, int ACT, int DT>
int launch(const float* x, const float* lift_re, const float* lift_im,
           const void* wf_re, const void* wf_im, const float* b_re,
           const float* b_im, float* out_re, float* out_im, int batch,
           int n_cfg, int height, int width_lat, int ksize, int channels,
           int n_layers, int residual, int threads, int smem_bytes,
           cudaStream_t stream) {
  const int hw = height * width_lat, width = kGroup * channels;
  const int kk = ksize * ksize;
  const int bytes =
      DT == kBfloat16
          ? smem_layout_bf16(hw, width, kk, CPLX, n_cfg).total_bytes
          : smem_layout(hw, width, kk, CPLX, n_cfg).total_bytes;
  if (bytes != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + n_cfg - 1) / n_cfg;
  cudaError_t err;
  if constexpr (DT == kBfloat16) {
    err = cudaFuncSetAttribute(gcnn_forward_bf16_kernel<CPLX, ACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err == cudaSuccess && batch > 0)
      gcnn_forward_bf16_kernel<CPLX, ACT>
          <<<blocks, threads, smem_bytes, stream>>>(
              x, lift_re, lift_im, static_cast<const uint2*>(wf_re),
              static_cast<const uint2*>(wf_im), b_re, b_im, out_re, out_im,
              batch, n_cfg, height, width_lat, ksize, channels, n_layers,
              residual);
  } else {
    err = cudaFuncSetAttribute(gcnn_forward_kernel<CPLX, ACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err == cudaSuccess && batch > 0)
      gcnn_forward_kernel<CPLX, ACT><<<blocks, threads, smem_bytes, stream>>>(
          x, lift_re, lift_im, static_cast<const uint4*>(wf_re),
          static_cast<const uint4*>(wf_im), b_re, b_im, out_re, out_im,
          batch, n_cfg, height, width_lat, ksize, channels, n_layers,
          residual);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward of `batch` configurations, n_cfg per block, on
// `stream`; returns cudaGetLastError() (0 = success). activation:
// 0 lncosh, 1 selu; dtype: 0 float32, 1 bfloat16. wf_* are the packed
// group-layer weights: float32 [L-1, k*k, W/8, W/8, 32 lanes] of 16-byte
// (hi b0, hi b1, lo b0, lo b1); bfloat16 [L-1, k*k, Kp/16, W/8, 32 lanes]
// of 8-byte (four bf16 values of the lane's input channels).
extern "C" int gcnn_forward_launch(
    const float* x, const float* lift_re, const float* lift_im,
    const void* wf_re, const void* wf_im, const float* b_re,
    const float* b_im, float* out_re, float* out_im, int batch, int n_cfg,
    int height, int width_lat, int ksize, int channels, int n_layers,
    int complex_params, int activation, int residual, int dtype, int threads,
    int smem_bytes, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads ||
      channels < 1 || n_layers < 1 || ksize < 1 || ksize % 2 == 0 ||
      ksize > height || ksize > width_lat || batch < 0 || n_cfg < 1 ||
      n_cfg * height * width_lat > (1 << 20) ||
      (activation != kLncosh && activation != kSelu) ||
      (dtype != kFloat32 && dtype != kBfloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMCNN_GCNN_LAUNCH(CP, AC)                                            \
  return dtype == kBfloat16                                                  \
             ? launch<CP, AC, kBfloat16>(                                    \
                   x, lift_re, lift_im, wf_re, wf_im, b_re, b_im, out_re,    \
                   out_im, batch, n_cfg, height, width_lat, ksize, channels, \
                   n_layers, residual, threads, smem_bytes, s)               \
             : launch<CP, AC, kFloat32>(                                     \
                   x, lift_re, lift_im, wf_re, wf_im, b_re, b_im, out_re,    \
                   out_im, batch, n_cfg, height, width_lat, ksize, channels, \
                   n_layers, residual, threads, smem_bytes, s)
  if (complex_params) {
    if (activation == kSelu) QMCNN_GCNN_LAUNCH(true, kSelu);
    QMCNN_GCNN_LAUNCH(true, kLncosh);
  }
  if (activation == kSelu) QMCNN_GCNN_LAUNCH(false, kSelu);
  QMCNN_GCNN_LAUNCH(false, kLncosh);
#undef QMCNN_GCNN_LAUNCH
}
