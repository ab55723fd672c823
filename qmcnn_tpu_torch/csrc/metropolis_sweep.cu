// Fused Metropolis sweep for the real LogPsiCNN, CUDA C++ for sm_90a, with
// the convolution layers of Cin >= 2 on the tensor cores in
// error-compensated TF32 (3xTF32).
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
// recomputes log psi(s): the CNN's evaluation forward (sampler refresh,
// local energies), one configuration per walker slot.
//
// Design. A block holds `walkers` walker slots (as many as shared memory
// takes, up to a cap the wrapper chooses) and runs their proposals in
// lock step: every proposal is one batched forward of walkers * N rows.
// Activations are row-major [rows, C + 4 words] ping-pong buffers in shared
// memory (the 4-word pad puts the 8 rows of an ldmatrix phase on distinct
// banks); circular padding is a [taps, N] table of source sites, shared by
// the slots (row = slot * N + site). The first layer (Cin = 1, ~3% of the
// work; spins are exact) runs on the FP32 cores, one thread per row and 8
// output channels per pass, and reads s' from the walker's s with the
// proposal's one or two sites negated, so s' is never stored. Every later
// layer is one GEMM [rows, taps * Cin] x [taps * Cin, Cout] with the tap
// shift as a row gather, issued as mma.sync.m16n8k8 TF32 by warps that each
// own kRowTiles 16-row tiles x CT 8-column tiles (CT from col_tiles: all of
// Cout = 16 or 24 in one task). A fragments come from the activation
// buffer by ldmatrix.x4 (each lane gives one gathered row address); B
// fragments come from shared memory, where the wrapper's
// packed weights are staged once per launch in fragment order (hi and lo
// TF32 parts, split on the host once per parameter state). Every product
// is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with x = hi + lo: a weight split by
// the wrapper (both parts rounded to nearest), an activation on load (hi
// rounded to nearest in two integer operations, lo = x - hi exactly, of
// which the tensor cores read the top 11 bits). The tensor cores truncate
// their sums, so each k step sums into fresh registers that are added to
// the f32 accumulators with round-to-nearest. The main loop has no branch
// (ragged row tiles are computed on clamped rows and dropped).
//
// The last layer's lncosh values are summed per row (each lane's columns
// in a fixed order, then a fixed shuffle tree over the row's four lanes)
// into a [rows, parts] array; one warp per walker slot then adds its N rows
// in a fixed order and decides, updates s and counts the accept for its
// slot. Its noise (log u, and the sites of the proposal after it) is
// copied into shared memory by cp.async while the forward runs. A row's
// value depends only on its own configuration, not on its slot, its tile
// or the batch size, so log psi is bitwise the same wherever a
// configuration runs (an identity exchange proposal then recomputes the
// cached log psi exactly and is accepted, as log u < 0). The block barriers
// are the ones between layers and one after the decisions.
//
// Bound. Each forward costs 2 * N * taps * sum_l Cin_l * Cout_l FLOP
// (9.5e5 at 10x10, C=16^3, k=3) against a few hundred bytes of state per
// walker: operations bound, at 3 TF32 passes per f32-accurate product on
// the tensor cores. Beside the mma, the split of the activations, the
// per-step sums and the lncosh of every output (N * Cout per layer, with
// only 2 * taps * Cin FLOP each) take issue slots, and mma.sync reaches
// only part of the wgmma rate the bound counts. Later: wgmma, and
// incremental receptive-field updates (a flip changes only the sites
// within the stack's receptive field).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxThreads = 800;
constexpr int kRowTiles = 2;     // 16-row mma tiles per warp task
constexpr int kMaxColTiles = 3;  // 8-column mma tiles per warp task, at most
constexpr int kFirstBlock = 8;   // layer-0 output channels per pass
constexpr int kSlotWords = 7;    // per-slot state words (see smem_layout)
constexpr float kLog2 = 0.6931471805599453f;

struct SweepDims {
  int n_layers;
  int ch[kMaxLayers + 1];  // ch[0] = 1 input channel, ch[l+1] = Cout of l
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }

// 8-column tiles per warp task for a layer of n_ct column tiles: as few
// column groups as kMaxColTiles allows, spread evenly (4 tiles: 2 x 2)
__host__ __device__ inline int col_tiles(int n_ct) {
  const int groups = (n_ct + kMaxColTiles - 1) / kMaxColTiles;
  return (n_ct + groups - 1) / groups;
}

// Shared memory of one block, in 4-byte words: the weight blob as the
// wrapper packs it (first-layer weights [taps, pad8(C1)], the biases of
// every layer padded to 8, then per later layer the B fragments
// [taps, Cin/8, Cout/8, 32 lanes] x (hi b0, hi b1, lo b0, lo b1)), up to
// two activation buffers [rows, stride], the spins [rows], the last
// layer's per-row partial sums [rows, parts] (one part per column group),
// the slot state [kSlotWords, walkers] (log psi, accepts, the two sites to
// negate, and the next decision's noise: log u and the two sites of the
// proposal after it) and the [taps, N] table.
struct Layout {
  int stride, n_parts, bias_off, frag_off, blob_words;
  int buf0_off, buf1_off, s_off, part_off, slot_off, nbr_off, total_bytes;
};

__host__ __device__ inline Layout smem_layout(const SweepDims& d, int n,
                                              int taps, int walkers) {
  Layout l;
  const int L = d.n_layers;
  const int rows = walkers * n;
  int cmax = 8, bias_total = 0, frag = 0;
  for (int i = 0; i < L; ++i) {
    bias_total += pad8(d.ch[i + 1]);
    if (i > 0) {
      cmax = pad8(d.ch[i]) > cmax ? pad8(d.ch[i]) : cmax;
      frag += 2 * taps * pad8(d.ch[i]) * pad8(d.ch[i + 1]);
    }
  }
  const int c_last = pad8(d.ch[L]);
  l.stride = cmax + 4;
  l.n_parts = (L == 1) ? 1 : (c_last / 8 + col_tiles(c_last / 8) - 1) /
                                 col_tiles(c_last / 8);
  l.bias_off = round4(taps * pad8(d.ch[1]));
  l.frag_off = l.bias_off + round4(bias_total);
  l.blob_words = l.frag_off + frag;
  const int n_bufs = L - 1 < 2 ? L - 1 : 2;
  l.buf0_off = l.blob_words;
  l.buf1_off = l.buf0_off + rows * l.stride;
  l.s_off = l.buf0_off + n_bufs * rows * l.stride;
  l.part_off = l.s_off + round4(rows);
  l.slot_off = l.part_off + round4(rows * l.n_parts);
  l.nbr_off = l.slot_off + kSlotWords * round4(walkers);
  l.total_bytes = 4 * (l.nbr_off + taps * n);
  return l;
}

__device__ __forceinline__ float lncosh_f(float x) {
  const float t = fabsf(x);
  return t - kLog2 + log1pf(expf(-2.0f * t));
}

// x rounded to TF32 (low 13 mantissa bits zero), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds finite x, in two integer
// operations; the same helpers as csrc/gcnn_forward.cu
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// d += a b on one 16x8x8 tile: a row-major 16x8, b column-major 8x8
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x4-word matrices from shared memory, one 16-byte row address per
// lane (lanes 8i .. 8i+7 give matrix i's rows); lane l receives word
// (l / 4, l % 4) of each: the m16n8k8 TF32 A fragment when lanes 0-7 give
// tile rows 0-7 at k 0-3, lanes 8-15 rows 8-15 at k 0-3, lanes 16-23 rows
// 0-7 at k 4-7 and lanes 24-31 rows 8-15 at k 4-7
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Layer 0 (Cin = 1) on the FP32 cores: one thread per row, kFirstBlock
// output channels per pass in registers (the lanes of a warp read the same
// weights). The input is the slot's s with sites fa, fb negated. As the
// last layer it writes the row's lncosh sum, in channel order, to part.
__device__ void first_layer(const float* s_cur, const int* fa, const int* fb,
                            const float* w0, const float* b0, float* out,
                            float* part, const int* nbr_s, int rows, int n,
                            int taps, int c0, int stride, bool last) {
  const int c0p = pad8(c0);
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int slot = row / n, p = row - slot * n;
    const float* s_slot = s_cur + slot * n;
    const int a = fa[slot], b = fb[slot];
    float sum = 0.0f;
    for (int cb = 0; cb < c0p; cb += kFirstBlock) {
      float acc[kFirstBlock];
#pragma unroll
      for (int j = 0; j < kFirstBlock; ++j) acc[j] = b0[cb + j];
      for (int t = 0; t < taps; ++t) {
        const int q = nbr_s[t * n + p];
        const float x = (q == a || q == b) ? -s_slot[q] : s_slot[q];
        const float4* w = reinterpret_cast<const float4*>(w0 + t * c0p + cb);
#pragma unroll
        for (int j4 = 0; j4 < kFirstBlock / 4; ++j4) {
          const float4 wv = w[j4];
          acc[4 * j4 + 0] = fmaf(x, wv.x, acc[4 * j4 + 0]);
          acc[4 * j4 + 1] = fmaf(x, wv.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(x, wv.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(x, wv.w, acc[4 * j4 + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kFirstBlock; ++j) acc[j] = lncosh_f(acc[j]);
      if (last) {
#pragma unroll
        for (int j = 0; j < kFirstBlock; ++j)
          if (cb + j < c0) sum += acc[j];
      } else {
        float4* o = reinterpret_cast<float4*>(out + row * stride + cb);
#pragma unroll
        for (int j4 = 0; j4 < kFirstBlock / 4; ++j4)
          o[j4] = make_float4(acc[4 * j4], acc[4 * j4 + 1], acc[4 * j4 + 2],
                              acc[4 * j4 + 3]);
      }
    }
    if (last) part[row] = sum;
  }
}

// One layer of Cin >= 2 on the tensor cores (see the header note). Warp
// tasks: kRowTiles row tiles x CT column tiles.
template <int CT>
__device__ void gemm_layer(const float* in, float* out, const uint4* wf,
                           const float* bias, float* part, const int* nbr_s,
                           int rows, int n, int taps, int cin_p, int cout,
                           int stride, int n_parts, bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n_row_tiles = (rows + 15) / 16;
  const int n_row_groups = (n_row_tiles + kRowTiles - 1) / kRowTiles;
  const int n_ct = pad8(cout) / 8;
  const int n_cg = (n_ct + CT - 1) / CT;
  const int k_steps = cin_p / 8;
  const int n_tasks = n_row_groups * n_cg;
  const uint32_t in_s = static_cast<uint32_t>(__cvta_generic_to_shared(in));
  // the tile row and the first k word of this lane's ldmatrix address
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 4;
  for (int task = warp; task < n_tasks; task += n_warps) {
    const int rg = task / n_cg, cg = task - rg * n_cg;
    const int rt0 = rg * kRowTiles, ct0 = cg * CT;
    int base[kRowTiles], site[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      const int row = min((rt0 + r) * 16 + lrow, rows - 1);
      base[r] = row / n * n;
      site[r] = row - base[r];
    }
    int col[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) col[c] = min(ct0 + c, n_ct - 1) * 32 + lane;
    float acc[kRowTiles][CT][4];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][c][j] = 0.0f;

    for (int t = 0; t < taps; ++t) {
      uint32_t addr[kRowTiles];
#pragma unroll
      for (int r = 0; r < kRowTiles; ++r)
        addr[r] = in_s + 4u * static_cast<uint32_t>(
                                  (base[r] + nbr_s[t * n + site[r]]) * stride +
                                  lcol);
      const uint4* wt = wf + static_cast<size_t>(t) * k_steps * n_ct * 32;
      for (int ks = 0; ks < k_steps; ++ks) {
        uint4 b[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) b[c] = wt[ks * n_ct * 32 + col[c]];
#pragma unroll
        for (int r = 0; r < kRowTiles; ++r) {
          uint32_t a[4], hi[4], lo[4];
          ldmatrix_x4(addr[r] + 32u * ks, a);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hi[j] = tf32_rna(a[j]);
            lo[j] = __float_as_uint(__uint_as_float(a[j]) -
                                    __uint_as_float(hi[j]));
          }
          // each k step sums into fresh registers, added to the
          // accumulators in f32 round-to-nearest (the tensor cores
          // truncate their sums)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(p, lo, b[c].x, b[c].y);
            mma_tf32(p, hi, b[c].z, b[c].w);
            mma_tf32(p, hi, b[c].x, b[c].y);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][c][j] += p[j];
          }
        }
      }
    }

    // epilogue: the accumulator fragment holds rows g, g + 8 and columns
    // 2 tig, 2 tig + 1 of each tile
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (rt0 + r) * 16 + g + 8 * h;
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const bool tile_ok = ct0 + c < n_ct;
          const int co = min(ct0 + c, n_ct - 1) * 8 + 2 * tig;
          if (last) {
            const float z0 = lncosh_f(acc[r][c][2 * h] + bias[co]);
            const float z1 = lncosh_f(acc[r][c][2 * h + 1] + bias[co + 1]);
            if (tile_ok && co < cout) sum += z0;
            if (tile_ok && co + 1 < cout) sum += z1;
          } else if (tile_ok && row < rows) {
            *reinterpret_cast<float2*>(out + row * stride + co) =
                make_float2(lncosh_f(acc[r][c][2 * h] + bias[co]),
                            lncosh_f(acc[r][c][2 * h + 1] + bias[co + 1]));
          }
        }
        if (last) {
          // the row's four lanes: a fixed tree (partners add the same two
          // values, so every lane holds the same bits)
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (tig == 0 && row < rows) part[row * n_parts + cg] = sum;
        }
      }
    }
  }
}

// the sites a slot's proposal (a, b) negates (-1: none): flip negates a;
// exchange negates a and b when the bond is anti-aligned (else s' = s)
__device__ __forceinline__ void propose(const float* s_slot, int a, int b,
                                        int exchange, int& fa, int& fb) {
  const bool anti = !exchange || s_slot[a] * s_slot[b] < 0.0f;
  fa = anti ? a : -1;
  fb = (exchange && anti) ? b : -1;
}

// one 4-byte global -> shared copy in flight (cp.async); it lands by the
// issuing thread's next cp_async_wait
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    sweep_kernel(const float* __restrict__ s_in,
                 const float* __restrict__ lp_in,
                 const int* __restrict__ site_a,
                 const int* __restrict__ site_b,
                 const float* __restrict__ log_u,
                 const float* __restrict__ blob, const int* __restrict__ nbr,
                 float* __restrict__ s_out, float* __restrict__ lp_out,
                 int* __restrict__ n_acc_out, int m, int n, int taps,
                 int n_props, int exchange, int walkers, SweepDims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = smem_layout(d, n, taps, walkers);
  const int L = d.n_layers;
  const float* w0 = smem;
  const float* bias_s = smem + lay.bias_off;
  float* buf0 = smem + lay.buf0_off;
  float* buf1 = smem + lay.buf1_off;
  float* s_cur = smem + lay.s_off;
  float* part = smem + lay.part_off;
  float* lp_s = smem + lay.slot_off;
  int* acc_s = reinterpret_cast<int*>(lp_s + round4(walkers));
  int* fa_s = acc_s + round4(walkers);
  int* fb_s = fa_s + round4(walkers);
  float* lu_s = reinterpret_cast<float*>(fb_s + round4(walkers));
  int* na_s = reinterpret_cast<int*>(lu_s + round4(walkers));
  int* nb_s = na_s + round4(walkers);
  int* nbr_s = reinterpret_cast<int*>(smem + lay.nbr_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int w0_glob = blockIdx.x * walkers;
  const int n_here = min(walkers, m - w0_glob);
  const int rows = n_here * n;
  const size_t s_base = static_cast<size_t>(w0_glob) * n;

  for (int i = tid; i < lay.blob_words / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] =
        reinterpret_cast<const uint4*>(blob)[i];
  for (int i = tid; i < taps * n; i += blockDim.x) nbr_s[i] = nbr[i];
  for (int i = tid; i < rows; i += blockDim.x) s_cur[i] = s_in[s_base + i];
  __syncthreads();
  for (int w = tid; w < n_here; w += blockDim.x) {
    lp_s[w] = lp_in[w0_glob + w];
    acc_s[w] = 0;
    fa_s[w] = fb_s[w] = -1;
    if (n_props > 0)
      propose(s_cur + w * n, site_a[w0_glob + w], site_b[w0_glob + w],
              exchange, fa_s[w], fb_s[w]);
  }
  __syncthreads();

  const int n_rounds = n_props > 0 ? n_props : 1;
  for (int t = 0; t < n_rounds; ++t) {
    // this round's log u and the next proposal's sites, copied in while the
    // forward runs; they land before the barrier ahead of the decisions
    if (n_props > 0 && tid < n_here) {
      const size_t k = static_cast<size_t>(t) * m + w0_glob + tid;
      cp_async4(lu_s + tid, log_u + k);
      if (t + 1 < n_props) {
        cp_async4(na_s + tid, site_a + k + m);
        cp_async4(nb_s + tid, site_b + k + m);
      }
    }
    first_layer(s_cur, fa_s, fb_s, w0, bias_s, buf0, part, nbr_s, rows, n,
                taps, d.ch[1], lay.stride, L == 1);
    if (L == 1) cp_async_wait();
    __syncthreads();
    int frag_off = lay.frag_off, bias_off = pad8(d.ch[1]);
    for (int l = 1; l < L; ++l) {
      const float* in = (l & 1) ? buf0 : buf1;
      float* out = (l & 1) ? buf1 : buf0;
      const uint4* wf = reinterpret_cast<const uint4*>(smem + frag_off);
      const int cin_p = pad8(d.ch[l]), cout = d.ch[l + 1];
      const bool last = l == L - 1;
      const float* bl = bias_s + bias_off;
      switch (col_tiles(pad8(cout) / 8)) {
        case 1:
          gemm_layer<1>(in, out, wf, bl, part, nbr_s, rows, n, taps, cin_p,
                        cout, lay.stride, lay.n_parts, last);
          break;
        case 2:
          gemm_layer<2>(in, out, wf, bl, part, nbr_s, rows, n, taps, cin_p,
                        cout, lay.stride, lay.n_parts, last);
          break;
        default:
          gemm_layer<3>(in, out, wf, bl, part, nbr_s, rows, n, taps, cin_p,
                        cout, lay.stride, lay.n_parts, last);
      }
      if (last) cp_async_wait();
      __syncthreads();
      frag_off += 2 * taps * cin_p * pad8(cout);
      bias_off += pad8(cout);
    }

    // one warp per slot: its rows' partial sums in a fixed order, then the
    // decision, the spin update and the next proposal's sites
    for (int w = warp; w < n_here; w += n_warps) {
      const float* ps = part + w * n * lay.n_parts;
      float v = 0.0f;
      for (int p = lane; p < n; p += 32)
        for (int j = 0; j < lay.n_parts; ++j) v += ps[p * lay.n_parts + j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) {
        if (n_props == 0) {
          lp_s[w] = v;
        } else {
          float* s_slot = s_cur + w * n;
          if (lu_s[w] < 2.0f * (v - lp_s[w])) {
            lp_s[w] = v;
            ++acc_s[w];
            if (fa_s[w] >= 0) s_slot[fa_s[w]] = -s_slot[fa_s[w]];
            if (fb_s[w] >= 0) s_slot[fb_s[w]] = -s_slot[fb_s[w]];
          }
          if (t + 1 < n_props)
            propose(s_slot, na_s[w], nb_s[w], exchange, fa_s[w], fb_s[w]);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < rows; i += blockDim.x) s_out[s_base + i] = s_cur[i];
  for (int w = tid; w < n_here; w += blockDim.x) {
    lp_out[w0_glob + w] = lp_s[w];
    n_acc_out[w0_glob + w] = acc_s[w];
  }
}

}  // namespace

// Launches one sweep of m walkers, `walkers` per block, on `stream`;
// returns cudaGetLastError() (0 = success). `blob` is the wrapper's packed
// weights (kernels/metropolis_sweep.py: pack_sweep_weights), `nbr` the
// [taps, n] source-site table.
extern "C" int metropolis_sweep_launch(
    const float* s_in, const float* lp_in, const int* site_a,
    const int* site_b, const float* log_u, const float* blob, const int* nbr,
    float* s_out, float* lp_out, int* n_acc_out, int m, int n, int taps,
    int n_props, int exchange, int n_layers, const int* channels,
    int walkers, int threads, int smem_bytes, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || threads % 32 != 0 ||
      threads < 32 || threads > kMaxThreads || walkers < 1 || n < 1 ||
      taps < 1 || m < 0 || n_props < 0 || channels[0] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepDims d;
  d.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (channels[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    d.ch[l] = channels[l];
  }
  if (smem_layout(d, n, taps, walkers).total_bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    const int blocks = (m + walkers - 1) / walkers;
    sweep_kernel<<<blocks, threads, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
        s_in, lp_in, site_a, site_b, log_u, blob, nbr, s_out, lp_out,
        n_acc_out, m, n, taps, n_props, exchange, walkers, d);
  }
  return static_cast<int>(cudaGetLastError());
}
