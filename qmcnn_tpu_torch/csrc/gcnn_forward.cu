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
// A from registers and the weight tiles fed by TMA into a ring, as the bf16
// route below does (it runs asynchronously beside the split), Karatsuba (3 complex
// products instead of 4) on the tensor cores, and one lattice tiled across
// a cluster for configurations above one block's shared memory (16x16 at
// W = 80).
//
// The bf16 route (gcnn_forward_bf16_kernel) computes what the TPU kernel
// computes at dtype_name = "bfloat16" (gcnn_pallas.py:259-320): the
// weights rounded once to bf16 (by the wrapper), bf16 activations in shared
// memory, each product of bf16 values exact and summed in f32, the f32 bias
// added on the sums and the activation computed in f32, rounded once to
// bf16 (to nearest even), the residual skip as the TPU kernel's bf16
// arithmetic rounds it under XLA (z + z_in rounded to bf16, times
// bf16(1/sqrt 2) = 0.70703125, rounded again), and the readout summed in f32
// from the bf16 activations. It replaces an mma.sync.m16n8k16 kernel whose
// time (182 ms at the j1j2_8x8_gcnn_r2 E_loc chunk on an H100) went, by
// ablation, to mma.sync issue and its 4 products per complex tile with a
// sign flip (an issue-only variant alone took 84 ms), per-k-step f32 sums
// (48 ms), B fragments loaded from L1/L2 every k step (28 ms), the epilogue
// (30 ms), a wasted fourth column tile (12 computed for 10 kept) and the
// lift and readout (12 ms, beside no tensor work); the block barriers cost
// under 2 ms. The design answers each:
//   * each complex layer is one real GEMM on wgmma (m64nNk16 bf16, f32
//     accumulators; `Wgmma`): [yr | yi] = sum_taps gather_t([xr | xi]) .
//     [[wr, wi], [-wi, wr]], K = 2 Kp per tap, N = 2W with the re and im
//     columns of 8 channels side by side (real parameters: K = Kp, N = W),
//     in one column block of exactly 8 NTB columns (NTB 20 at W = 80: no
//     wasted tile). No sign flip, no separate products; the direct form,
//     not Karatsuba, whose rounding the TPU kernel does not have;
//   * A (the gathered activation rows; the tap shift is a row gather no
//     shared-memory descriptor can address) comes from registers, loaded
//     through the source-row table as m16n8k16 A fragments with the k order
//     permuted so that a lane's A of a row is one 8-byte load; B comes from
//     shared memory, packed once per parameter update by the wrapper
//     (`pack_group_weights_bf16`) in the K-major core-matrix layout the
//     descriptor reads (`b_desc`);
//   * the sums run over the whole K (k*k*K/16 steps) in the wgmma
//     accumulators: no per-step adds (bf16 rounding hides the truncation of
//     the tensor cores' sums, as the depth-12 check in chip_smoke shows);
//   * a producer warpgroup streams the weight stages by TMA bulk copies
//     (cp.async.bulk, no tensor map) into a ring of up to 16 stages under
//     full/empty mbarriers, ahead of the consumers, across layers and
//     groups: the ring never drains between them;
//   * each consumer warpgroup owns whole configurations (one per 64-row M
//     tile at 8x8) and goes from layer to layer with its own barrier, so
//     one warpgroup's lift, epilogue and readout overlap the other's
//     wgmma; a persistent grid of one block per SM walks over groups of
//     configurations and builds the source-row table once; setmaxnreg
//     gives the consumers 232 registers (the accumulators take 4 NTB);
//   * the lift (Cin = 1) runs on the CUDA cores, a thread per row and 8
//     channels (the weights rounded by the wrapper, broadcast in a warp).
// Other site counts clamp the ragged rows of their M tiles and drop them;
// a configuration of more than 64 rows takes several passes per layer
// between two buffers. Its bound is the least FLOP at the dense bf16
// tensor-core rate (989 TFLOP/s): Karatsuba's 3 products; the direct form
// spends 4/3 of it.
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

// The bf16 route's tiling (mirrored by `bf16_plan` in
// kernels/gcnn_forward.py; the launch checks the byte count). The GEMM of a
// layer has N = nt 8-column tiles (2W/8 complex, W/8 real), cut into
// col_blocks blocks of NTB tiles, NTB the first of 8, 16, 20, 32 that holds
// nt (else 32). A consumer warpgroup owns c_wg whole configurations
// (rows_wg = c_wg*H*W rows, one 64-row M tile of accumulators at a time);
// it takes row_passes x col_blocks passes per layer, in place when that is
// one pass (n_buf = 1), else between two buffers. A layer's K is `steps`
// k16 steps (k*k taps x parts x Kp/16, Kp = W rounded up to 16), padded to
// whole ring stages of kStageSteps steps.
constexpr int kStageSteps = 2;
// wgmma k steps a consumer keeps in flight beside the one it issues (each
// holds its A registers until it retires; at most kStageSteps - 1)
constexpr int kInFlight = 1;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
// Consumer warpgroups of a block, at most. With the producer warpgroup that
// is 3 warps per SM sub-partition, whose 512 registers a thread setmaxnreg
// splits as 40 for the producer and 232 for each consumer (ptxas allocates
// the consumers' code within 232, the launch bound's 168 elsewhere).
constexpr int kMaxConsumerGroups = 2;
constexpr int kMaxThreadsBf16 = 128 * (kMaxConsumerGroups + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmemBytes = 232448;

// Shared memory of a block, in bytes: the ring [stages][stage_bytes] of
// weight stages, then per consumer warpgroup its activation buffers
// [n_buf][parts][rows_wg][stride] of bf16 (stride = Kp + 8), the spins of
// all warpgroups (f32), the [k*k, rows_wg] table of source rows, and the
// full and empty mbarriers of the ring stages.
struct PlanBf16 {
  int nt, ntb, col_blocks, kpad, stride, parts, c_wg, rows_wg, row_passes,
      n_buf, n_wg, steps, steps_pad, stage_bytes, stages, act_bytes, act_off,
      x_off, src_off, bar_off, total_bytes;
};

__host__ __device__ inline PlanBf16 plan_bf16(int hw, int width, int kk,
                                              bool cplx, int n_cfg) {
  PlanBf16 p;
  p.parts = cplx ? 2 : 1;
  p.nt = p.parts * width / 8;
  p.ntb = p.nt <= 8 ? 8 : p.nt <= 16 ? 16 : p.nt <= 20 ? 20 : 32;
  p.col_blocks = (p.nt + p.ntb - 1) / p.ntb;
  p.kpad = (width + 15) / 16 * 16;
  p.stride = p.kpad + 8;
  p.c_wg = hw < 64 ? 64 / hw : 1;
  p.rows_wg = p.c_wg * hw;
  p.row_passes = (p.rows_wg + 63) / 64;
  p.n_buf = p.row_passes * p.col_blocks == 1 ? 1 : 2;
  p.n_wg = n_cfg / p.c_wg;
  p.steps = kk * p.parts * p.kpad / 16;
  p.steps_pad = (p.steps + kStageSteps - 1) / kStageSteps * kStageSteps;
  p.stage_bytes = kStageSteps * p.ntb * 256;
  p.act_bytes = 2 * p.n_buf * p.parts * p.rows_wg * p.stride;
  const int fixed = (p.n_wg * (p.act_bytes + 4 * round4(p.rows_wg)) +
                     4 * kk * p.rows_wg + 7) / 8 * 8;
  p.stages = (kMaxSmemBytes - fixed) / (p.stage_bytes + 16);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.act_off = p.stages * p.stage_bytes;
  p.x_off = p.act_off + p.n_wg * p.act_bytes;
  p.src_off = p.x_off + p.n_wg * 4 * round4(p.rows_wg);
  p.bar_off = p.act_off + fixed;
  p.total_bytes = p.bar_off + 16 * p.stages;
  return p;
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
// element) of the n_warps warps from `warp` on, lanes in a fixed order,
// then a shuffle tree
template <bool CPLX, typename T>
__device__ __forceinline__ void readout(const T* f, int plane, int stride,
                                        int hw, int channels, int n_here,
                                        size_t cfg0, float* out_re,
                                        float* out_im, int warp,
                                        int n_warps) {
  const int lane = threadIdx.x & 31;
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
                channels, n_here, cfg0, out_re, out_im, threadIdx.x >> 5,
                blockDim.x >> 5);
}

// ---------------------------------------------------------------------------
// The bf16 route: wgmma fed by a TMA ring of weight stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// one TMA bulk copy (global -> shared, `bytes` a multiple of 16), which
// arrives on `bar` and completes its transaction count when the bytes land
__device__ __forceinline__ void tma_load_stage(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the accumulators are written by the asynchronous wgmma: tie each to this
// point, after wgmma_wait<0>, so that no read of them moves above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the barrier of consumer warpgroup wg (its 128 threads; 0 is the block's)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// Shared-memory descriptor of one k16 step of B (K-major, no swizzle): core
// matrices of 8 columns x 8 k (16 bytes a column, 128 contiguous bytes),
// the two k halves 128 bytes apart (leading byte offset), 8-column groups
// 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d[64 x 8 NTB] (+)= a[64 x 16] b[16 x 8 NTB], bf16 operands, f32
// accumulators: A from registers (per warp the m16n8k16 A fragment of its
// 16 rows), B by descriptor from shared memory. The accumulator fragment:
// d[4 i + 2 h + j] is row 16 warp + g + 8 h, column 8 i + 2 t + j.
#define QMCNN_F8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
template <int NTB>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : QMCNN_F8(0),
        QMCNN_F8(8),
        QMCNN_F8(16),
        QMCNN_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : QMCNN_F8(0),
        QMCNN_F8(8),
        QMCNN_F8(16),
        QMCNN_F8(24),
        QMCNN_F8(32),
        QMCNN_F8(40),
        QMCNN_F8(48),
        QMCNN_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<20> {
  __device__ static __forceinline__ void mma(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : QMCNN_F8(0),
        QMCNN_F8(8),
        QMCNN_F8(16),
        QMCNN_F8(24),
        QMCNN_F8(32),
        QMCNN_F8(40),
        QMCNN_F8(48),
        QMCNN_F8(56),
        QMCNN_F8(64),
        QMCNN_F8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : QMCNN_F8(0),
        QMCNN_F8(8),
        QMCNN_F8(16),
        QMCNN_F8(24),
        QMCNN_F8(32),
        QMCNN_F8(40),
        QMCNN_F8(48),
        QMCNN_F8(56),
        QMCNN_F8(64),
        QMCNN_F8(72),
        QMCNN_F8(80),
        QMCNN_F8(88),
        QMCNN_F8(96),
        QMCNN_F8(104),
        QMCNN_F8(112),
        QMCNN_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
  }
};
#undef QMCNN_F8

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

// One bf16 epilogue value pair (columns co, co + 1 of one row): the f32
// bias, the activation in f32, one rounding to bf16, then the residual
// skip as the TPU kernel's bf16 arithmetic rounds it under XLA.
template <bool CPLX, int ACT>
__device__ __forceinline__ void epilogue_bf16(float zr0, float zr1, float zi0,
                                              float zi1, float2 br, float2 bi,
                                              bool skip,
                                              const __nv_bfloat16* in,
                                              __nv_bfloat16* out, int o,
                                              int plane) {
  zr0 += br.x;
  zr1 += br.y;
  if (CPLX) {
    zi0 += bi.x;
    zi1 += bi.y;
  }
  activate<CPLX, ACT>(zr0, zi0);
  activate<CPLX, ACT>(zr1, zi1);
  zr0 = bf16_round(zr0);
  zr1 = bf16_round(zr1);
  zi0 = bf16_round(zi0);
  zi1 = bf16_round(zi1);
  if (skip) {
    const float2 rr = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(in + o));
    zr0 = bf16_round(bf16_round(zr0 + rr.x) * kSkipScaleBf16);
    zr1 = bf16_round(bf16_round(zr1 + rr.y) * kSkipScaleBf16);
    if (CPLX) {
      const float2 ri = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(in + plane + o));
      zi0 = bf16_round(bf16_round(zi0 + ri.x) * kSkipScaleBf16);
      zi1 = bf16_round(bf16_round(zi1 + ri.y) * kSkipScaleBf16);
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(zr0,
                                                                      zr1);
  if (CPLX)
    *reinterpret_cast<__nv_bfloat162*>(out + plane + o) =
        __floats2bfloat162_rn(zi0, zi1);
}

// The bf16 route. A persistent grid (at most one block per SM) walks over
// groups of n_wg x c_wg configurations; consumer warpgroup wg computes its
// c_wg configurations end to end (the lift, L-1 group layers as real GEMMs
// on wgmma, the readout) with only its own barrier between layers, taking
// the weights from a ring of stages in shared memory. One thread of the
// producer warpgroup (the last) streams every (group, layer, column block,
// pass, stage) of the packed weights through the ring in the order the
// consumers take them, each stage one bulk copy; a stage is released when
// every consumer warp has retired the wgmma group that read it.
template <bool CPLX, int ACT, int NTB>
__global__ void __launch_bounds__(kMaxThreadsBf16, 1) gcnn_forward_bf16_kernel(
    const float* __restrict__ x, const float* __restrict__ lift_re,
    const float* __restrict__ lift_im,
    const unsigned char* __restrict__ wstages,
    const float* __restrict__ b_re, const float* __restrict__ b_im,
    float* __restrict__ out_re, float* __restrict__ out_im, int batch,
    int n_cfg, int height, int width_lat, int ksize, int channels,
    int n_layers, int residual) {
  constexpr int ND = 4 * NTB;  // accumulators per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int hw = height * width_lat;
  const int width = kGroup * channels;
  const int kk = ksize * ksize;
  const PlanBf16 P = plan_bf16(hw, width, kk, CPLX, n_cfg);
  const int rows_wg = P.rows_wg, stride = P.stride;
  const int plane = rows_wg * stride;
  int* const src_s = reinterpret_cast<int*>(smem_raw + P.src_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_groups = (batch + n_cfg - 1) / n_cfg;

  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_raw + P.bar_off);
  uint64_t* const empty = full + P.stages;
  const int n_stages = P.steps_pad / kStageSteps;  // per pass
  // bytes of the packed weights per (layer, column block)
  const size_t block_bytes = static_cast<size_t>(P.steps_pad) * NTB * 256;

  if (tid == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * P.n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // for each tap t and row (configuration, site) of a warpgroup the row it
  // reads: y[i, j] += x[(i + a - half) mod H, (j + b - half) mod W] w[a, b]
  const int half = (ksize - 1) / 2;
  for (int i = tid; i < kk * rows_wg; i += blockDim.x) {
    const int t = i / rows_wg, row = i - t * rows_wg;
    const int p = row % hw;
    const int a = t / ksize, b = t - a * ksize;
    const int r = p / width_lat, c = p - r * width_lat;
    src_s[i] = row - p + ((r + a - half + height) % height) * width_lat +
               (c + b - half + width_lat) % width_lat;
  }
  // the padded input channels [W, Kp) of every row are read by a tap's last
  // k step (against zero weights): zero in every buffer, never written
  const int n_pad = P.kpad - width;
  if (n_pad > 0) {
    __nv_bfloat16* act =
        reinterpret_cast<__nv_bfloat16*>(smem_raw + P.act_off);
    const int n_rows = P.n_wg * P.n_buf * P.parts * rows_wg;
    for (int i = tid; i < n_rows * n_pad; i += blockDim.x) {
      const int row = i / n_pad;
      act[row * stride + width + i - row * n_pad] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  if (warp >= 4 * P.n_wg) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * P.n_wg && lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x)
        for (int l = 1; l < n_layers; ++l)
          for (int cb = 0; cb < P.col_blocks; ++cb) {
            const unsigned char* src =
                wstages + static_cast<size_t>((l - 1) * P.col_blocks + cb) *
                              block_bytes;
            for (int rp = 0; rp < P.row_passes; ++rp)
              for (int st = 0; st < n_stages; ++st) {
                mbar_wait(empty + slot, phase ^ 1);
                tma_load_stage(smem_raw + slot * P.stage_bytes,
                               src + static_cast<size_t>(st) * P.stage_bytes,
                               P.stage_bytes, full + slot);
                if (++slot == P.stages) {
                  slot = 0;
                  phase ^= 1;
                }
              }
          }
    }
    return;
  }

  // a consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + P.act_off + wg * P.act_bytes);
  __nv_bfloat16* const buf1 = P.n_buf == 2 ? buf0 + P.parts * plane : buf0;
  float* const x_s =
      reinterpret_cast<float*>(smem_raw + P.x_off) + wg * round4(rows_wg);
  const int wtid = tid & 127;
  const int kch = P.kpad / 16;    // k16 steps per part of a tap
  const int kpt = P.parts * kch;  // k16 steps per tap
  const uint32_t ring_addr = smem_u32(smem_raw);
  int slot = 0;
  uint32_t phase = 0;

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const long cfg0 = static_cast<long>(grp) * n_cfg + wg * P.c_wg;
    const long left = batch - cfg0;
    const int n_here = left <= 0 ? 0 : left < P.c_wg ? static_cast<int>(left)
                                                      : P.c_wg;
    // the spins (configurations past the batch repeat the last one; their
    // results are dropped)
    for (int i = wtid; i < rows_wg; i += 128) {
      const long c = cfg0 + i / hw < batch ? cfg0 + i / hw : batch - 1;
      x_s[i] = x[c * hw + i % hw];
    }
    wg_sync(wg);

    // layer 0: the lift on the CUDA cores, a thread per row and 8 output
    // channels (the lanes of a warp on neighbouring rows read the same
    // weights). The wrapper passes the weights rounded to bf16; a product
    // of +-1 and a bf16 value is exact, summed in tap order in f32 as the
    // TPU kernel sums its taps, then rounded once to bf16.
    for (int i = wtid; i < rows_wg * channels; i += 128) {
      const int row = i % rows_wg, c8 = 8 * (i / rows_wg);
      float zr[8], zi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) zr[j] = zi[j] = 0.0f;
      for (int t = 0; t < kk; ++t) {
        const float xv = x_s[src_s[t * rows_wg + row]];
        const float4* wr =
            reinterpret_cast<const float4*>(lift_re + t * width + c8);
        const float4* wi =
            reinterpret_cast<const float4*>(lift_im + t * width + c8);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 r = __ldg(wr + q);
          zr[4 * q] = fmaf(xv, r.x, zr[4 * q]);
          zr[4 * q + 1] = fmaf(xv, r.y, zr[4 * q + 1]);
          zr[4 * q + 2] = fmaf(xv, r.z, zr[4 * q + 2]);
          zr[4 * q + 3] = fmaf(xv, r.w, zr[4 * q + 3]);
          if (CPLX) {
            const float4 m = __ldg(wi + q);
            zi[4 * q] = fmaf(xv, m.x, zi[4 * q]);
            zi[4 * q + 1] = fmaf(xv, m.y, zi[4 * q + 1]);
            zi[4 * q + 2] = fmaf(xv, m.z, zi[4 * q + 2]);
            zi[4 * q + 3] = fmaf(xv, m.w, zi[4 * q + 3]);
          }
        }
      }
      __nv_bfloat162 hr[4], hi[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float r0 = zr[j] + __ldg(b_re + c8 + j);
        float r1 = zr[j + 1] + __ldg(b_re + c8 + j + 1);
        float i0 = CPLX ? zi[j] + __ldg(b_im + c8 + j) : 0.0f;
        float i1 = CPLX ? zi[j + 1] + __ldg(b_im + c8 + j + 1) : 0.0f;
        activate<CPLX, ACT>(r0, i0);
        activate<CPLX, ACT>(r1, i1);
        hr[j / 2] = __floats2bfloat162_rn(r0, r1);
        hi[j / 2] = __floats2bfloat162_rn(i0, i1);
      }
      *reinterpret_cast<uint4*>(buf0 + row * stride + c8) =
          *reinterpret_cast<const uint4*>(hr);
      if (CPLX)
        *reinterpret_cast<uint4*>(buf0 + plane + row * stride + c8) =
            *reinterpret_cast<const uint4*>(hi);
    }
    wg_sync(wg);

    // layers 1 .. L-1: per pass one GEMM of a 64-row M tile x NTB column
    // tiles, [yr | yi] = sum_taps gather_t([xr | xi]) . [[wr, wi], [-wi, wr]]
    // over the whole K in the wgmma accumulators
    for (int l = 1; l < n_layers; ++l) {
      const __nv_bfloat16* in = ((l - 1) & 1) ? buf1 : buf0;
      __nv_bfloat16* out = (l & 1) ? buf1 : buf0;
      const float* bl_re = b_re + l * width;
      const float* bl_im = CPLX ? b_im + l * width : nullptr;
      const bool skip = residual && l < n_layers - 1;
      for (int cb = 0; cb < P.col_blocks; ++cb)
        for (int rp = 0; rp < P.row_passes; ++rp) {
          // this lane's A rows (clamped into the warpgroup's rows; the
          // clamped rows are computed and dropped)
          const int row0 = rp * 64 + wq * 16 + g;
          const int ra0 = min(row0, rows_wg - 1);
          const int ra1 = min(row0 + 8, rows_wg - 1);
          float acc[ND];
          // A of the stage's k steps: step j's registers are loaded again a
          // stage later, after the step has retired
          uint32_t a[kStageSteps][4];
          int tap = 0, kc = 0, prev = -1, o0 = 0, o1 = 0;
          for (int st = 0; st < n_stages; ++st) {
            mbar_wait(full + slot, phase);
            const uint32_t stage = ring_addr + slot * P.stage_bytes;
#pragma unroll
            for (int j = 0; j < kStageSteps; ++j) {
              // A of this k step: tap `tap` (its source rows looked up once
              // per tap; padded steps past the last tap read the last tap
              // against zero weights), channels 16 kc' + 4 tig of the re
              // (kc < kch) or im plane
              if (kc == 0) {
                const int t = min(tap, kk - 1);
                o0 = src_s[t * rows_wg + ra0] * stride + 4 * tig;
                o1 = src_s[t * rows_wg + ra1] * stride + 4 * tig;
              }
              load_a_bf16(in + (kc < kch ? 16 * kc : plane + 16 * (kc - kch)),
                          o0, o1, a[j]);
              wgmma_fence();
              Wgmma<NTB>::mma(acc, a[j], b_desc(stage + j * NTB * 256),
                              st > 0 || j > 0);
              wgmma_commit();
              // the k step kInFlight back has retired: at step kInFlight - 1
              // that is the previous stage's last read
              wgmma_wait<kInFlight>();
              if (j == kInFlight - 1 && prev >= 0 && lane == 0)
                mbar_arrive(empty + prev);
              if (++kc == kpt) {
                kc = 0;
                ++tap;
              }
            }
            prev = slot;
            if (++slot == P.stages) {
              slot = 0;
              phase ^= 1;
            }
          }
          wgmma_wait<0>();
          fence_regs(acc);
          if (lane == 0) mbar_arrive(empty + prev);
          // every warp has read its last A rows of `in` (written in place
          // when this is the layer's only pass)
          wg_sync(wg);

          // epilogue on the accumulator fragment: rows g, g + 8; columns
          // 2 tig, 2 tig + 1 of each 8-column tile. Complex: tile 2 p holds
          // the re and tile 2 p + 1 the im parts of 8 output channels.
          constexpr int kPairs = CPLX ? NTB / 2 : NTB;
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const int co = (cb * kPairs + p) * 8 + 2 * tig;
            if (co >= width) continue;
            const float2 br = __ldg(reinterpret_cast<const float2*>(bl_re + co));
            const float2 bi =
                CPLX ? __ldg(reinterpret_cast<const float2*>(bl_im + co))
                     : make_float2(0.0f, 0.0f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 8 * h;
              if (row >= rows_wg) continue;
              // complex: the re part in tile 2 p, the im part in 2 p + 1
              const int d = (CPLX ? 8 : 4) * p + 2 * h;
              epilogue_bf16<CPLX, ACT>(acc[d], acc[d + 1],
                                       acc[CPLX ? d + 4 : d],
                                       acc[CPLX ? d + 5 : d + 1], br, bi,
                                       skip, in, out, row * stride + co,
                                       plane);
            }
          }
        }
      wg_sync(wg);
    }

    readout<CPLX>(((n_layers - 1) & 1) ? buf1 : buf0, plane, stride, hw,
                  channels, n_here, static_cast<size_t>(cfg0), out_re, out_im,
                  wq, 4);
    wg_sync(wg);
  }
}

template <bool CPLX, int ACT, int NTB>
cudaError_t launch_bf16(const float* x, const float* lift_re,
                        const float* lift_im, const void* wstages,
                        const float* b_re, const float* b_im, float* out_re,
                        float* out_im, int batch, int n_cfg, int height,
                        int width_lat, int ksize, int channels, int n_layers,
                        int residual, int threads, int smem_bytes,
                        cudaStream_t stream) {
  const PlanBf16 p = plan_bf16(height * width_lat, kGroup * channels,
                               ksize * ksize, CPLX, n_cfg);
  if (p.ntb != NTB || n_cfg % p.c_wg != 0 || p.n_wg < 1 ||
      p.n_wg > kMaxConsumerGroups || p.stages < kMinStages ||
      p.total_bytes != smem_bytes || threads != 128 * (p.n_wg + 1))
    return cudaErrorInvalidValue;
  int device, n_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gcnn_forward_bf16_kernel<CPLX, ACT, NTB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  if (err != cudaSuccess || batch == 0) return err;
  // a persistent grid: at most one block per SM, each walking over groups
  const int groups = (batch + n_cfg - 1) / n_cfg;
  gcnn_forward_bf16_kernel<CPLX, ACT, NTB>
      <<<groups < n_sm ? groups : n_sm, threads, smem_bytes, stream>>>(
          x, lift_re, lift_im, static_cast<const unsigned char*>(wstages),
          b_re, b_im, out_re, out_im, batch, n_cfg, height, width_lat, ksize,
          channels, n_layers, residual);
  return cudaSuccess;
}

template <bool CPLX, int ACT, int DT>
int launch(const float* x, const float* lift_re, const float* lift_im,
           const void* wf_re, const void* wf_im, const float* b_re,
           const float* b_im, float* out_re, float* out_im, int batch,
           int n_cfg, int height, int width_lat, int ksize, int channels,
           int n_layers, int residual, int threads, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err;
  if constexpr (DT == kBfloat16) {
    const int ntb = plan_bf16(height * width_lat, kGroup * channels,
                              ksize * ksize, CPLX, n_cfg).ntb;
#define QMCNN_BF16_LAUNCH(N)                                                 \
  launch_bf16<CPLX, ACT, N>(x, lift_re, lift_im, wf_re, b_re, b_im, out_re,  \
                            out_im, batch, n_cfg, height, width_lat, ksize,  \
                            channels, n_layers, residual, threads,           \
                            smem_bytes, stream)
    err = ntb == 8    ? QMCNN_BF16_LAUNCH(8)
          : ntb == 16 ? QMCNN_BF16_LAUNCH(16)
          : ntb == 20 ? QMCNN_BF16_LAUNCH(20)
                      : QMCNN_BF16_LAUNCH(32);
#undef QMCNN_BF16_LAUNCH
  } else {
    const int hw = height * width_lat, width = kGroup * channels;
    if (smem_layout(hw, width, ksize * ksize, CPLX, n_cfg).total_bytes !=
        smem_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (batch + n_cfg - 1) / n_cfg;
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

// Launches the forward of `batch` configurations, n_cfg per block (per
// group of the bf16 route's persistent blocks), on `stream`; returns
// cudaGetLastError() (0 = success). activation: 0 lncosh, 1 selu; dtype:
// 0 float32, 1 bfloat16. wf_* are the packed group-layer weights: float32
// [L-1, k*k, W/8, W/8, 32 lanes] of 16-byte (hi b0, hi b1, lo b0, lo b1);
// bfloat16 wf_re only (wf_im unused), the ring stages [L-1, col_blocks,
// steps_pad, NTB, 2, 8, 8] of bf16 (`pack_group_weights_bf16`).
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
