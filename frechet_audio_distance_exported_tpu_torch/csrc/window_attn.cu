// CLAP's Swin window kernels, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the two TPU kernels of frechet_audio_distance_exported_tpu/ops/pallas_window_attn.py:
// - window_attention_fused (L217, pallas_call L243; body _kernel L86 + _attention_half L35):
//     out = x + proj(attn(LN1(x)))
// - swin_block_fused (L152, pallas_call L187; body _block_kernel L114 + _attention_half):
//     x2 = x + proj(attn(LN1(x))),  out = x2 + fc2(GELU(fc1(LN2(x2))))
// over partitioned 8x8 windows: x [BW, 64, C] float32, weights [in, out], bias [H, 64, 64],
// mask [mask_count, 64, 64] with window w using mask[w % mask_count] (mask_count is nW for a
// shifted layer, 1 for an unshifted one, whose mask is zeros). attn is, per head h,
//     softmax(q_h k_h^T * hd^-1/2 + bias[h] + mask) v_h,  q_h = columns h*24 .. h*24+23 of q
// with head_dim 24 (every HTSAT-tiny stage; heads 4, 8, 16, 32 for C = 96, 192, 384, 768).
// LayerNorm is two-pass with eps 1e-5, GELU the erf form with the Pallas kernel's erf
// (Abramowitz-Stegun 7.1.26, within 1.5e-7 of erf), softmax subtracts the row max.
//
// Arithmetic: every matrix product runs on the tensor cores as 3xTF32. Each float32 operand a
// is split into hi = tf32(a) and lo = tf32(a - hi) (wgmma_tf32.cuh, split_tf32: two integer
// operations each), and a b is formed as a_lo b_hi + a_hi b_lo + a_hi b_hi: about 2^-21 relative
// per product against float32's 2^-24, so the port's exact-float32 rule holds; plain 1xTF32
// (2^-11) would not. The tensor core truncates as it accumulates (PERF.md: one chained
// accumulator a tile cost 1.16e-4), so the products of each 32-deep slab go into a fresh
// accumulator that a float32 add folds into the total. Softmax, LayerNorm, GELU and the
// epilogues stay float32 SIMT.
//
// What bounds it on the H100: for M = BW * 64 tokens the block does 24*M*C^2 + 4*M*64*C flops
// (qkv 6, proj 2, fc1 8, fc2 8 times M*C^2; q k^T and p v 4*M*64*C), the attention half
// 8*M*C^2 + 4*M*64*C. Float32-accurate products run at most at 495 / 3 = 165 TFLOP/s (dense TF32
// over the three products of the split): 49 flops a byte at 3.35 TB/s, against some 200 for the
// block at C = 96 counting only x, out and the weights. So both are bound by operations, and
// the products' rate is what a design has to reach: wgmma, weights that feed many rows, and no
// SIMT work on the weights in the loop.
//
// How it is laid out. A window's float32 intermediates do not fit on chip beside a weight ring
// and two windows: at C = 384 LN1(x) alone is 96 KB a window, and fc2's [64, C] total with the
// fresh slab accumulator of the fold is C registers a thread of a warpgroup (384 at C = 384; a
// thread has at most 255). So both kernels are token-tile GEMMs over all M rows, with the
// attention itself per (window, 4 heads) between them:
// - split_weights_kernel (launched by the wrapper, once per weight a call: the weights are
//   constants of the forward pass): W [in, out] -> [2, out, in], hi then lo of W^T, K-major as
//   TF32 wgmma needs its B, each half TF32-exact, so the GEMMs do no arithmetic on weights.
// - row_stats_kernel: the LayerNorm statistics (mean, 1 / sqrt(var + eps)) of each token, once.
// - gemm_tf32_kernel<BN, EPI, AOP>: out[M, N] = op(A) @ W + bias (+ the residual), op applied as
//   A is read: LN1 on x for qkv, LN2 on x2 for fc1, GELU on fc1's output for fc2, or none.
//   Persistent, warp-specialised blocks of three warpgroups, one per SM: a producer warpgroup
//   (40 registers, setmaxnreg) of which one thread has TMA stage each 32-deep slab (A's [128,
//   32] rows, W^T's hi and lo [BN, 32], all in TMA's 128-byte swizzle) into a ring of 4 or 5
//   slots tracked by mbarriers, and two consumer warpgroups (232 registers) of 64 rows each, one
//   window, so each weight slab staged once feeds two windows. A consumer reads its A fragments
//   from the slot (conflict-free under the swizzle), applies the LayerNorm and splits them in
//   registers, and issues 12 m64nBNk8 wgmmas a slab (4 k-steps, 3 products) with A from
//   registers into a fresh accumulator, then folds it into the [64, BN] total; the next slab's
//   fragments, and the previous tile's epilogue (the bias, and the residual; stores from
//   registers), are done while the products run. What bounds the GEMMs is L2's bandwidth: a
//   slab is 48 KB (BN = 128) for 3.1 MFLOP of tensor-core work, and the GEMMs stream some
//   5 TB/s from L2 at about 60 % of the TF32 rate (PERF.md); the split weights are two thirds of
//   those bytes. Clusters of two blocks sharing each weight slab by TMA multicast were measured
//   at half the speed (PERF.md), and are not used.
// - attention_from_qkv_kernel: per (window, 4 heads), k and v staged from qkv (q read from it as
//   used, each value by one thread), S = q k^T (3 k-steps of 8) in a fresh accumulator, bias +
//   mask, softmax from the row max in registers, P v (8 k-steps of 8 keys, folded each 32 keys)
//   on 3xTF32 mma.sync.m16n8k8, one warp per (head, 32 query rows), into attn [M, C]. These
//   products stay on mma.sync: head_dim 24 is three k8 steps, they are 4*M*64*C of the flops
//   (10 % at C = 96, 1.3 % at C = 768), and P goes from the S accumulator to the A operand with
//   no exchange (the p v k-step takes keys 2t, 2t+1 of the S fragment). They split their
//   operands with split_tf32's integer operations, as the GEMMs do.
// window_attention_fused is stats, qkv GEMM (LN1 on load, + b_qkv), attention, proj GEMM
// (+ b_proj + x): four launches. swin_block_fused adds stats of x2, the fc1 GEMM (LN2 on load,
// + b_fc1) and the fc2 GEMM (GELU on load, + b_fc2 + x2): seven. The intermediates qkv, attn, x2
// and the hidden layer pass through device memory: at C = 96 about 2.4 GB a launch at B = 64
// (0.7 ms at 3.35 TB/s, partly from L2), at C = 384 0.6 GB.
//
// The token-tile GEMM is also a general product (gemm_tf32_launch): out [m, n] = op(a) @ w + bias
// (+ residual) over any m rows, in the three forms a pre-LN transformer layer needs, LN on load
// with the bias (k <= MAX_LN_WIDTH), none with the residual, GELU on load with the residual;
// WavLM's encoder (models/wavlm.py) runs its products on it.
//
// The wrapper (ops/window_attn.py) checks shapes, types, devices, contiguity and 16-byte
// alignment, splits the weights (tf32_split) and allocates the output and the scratch; a CUDA
// tensor reaches these kernels or the wrapper raises, and there is no fallback to the plain
// version.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

using hopper::tf32::split_tf32;

constexpr int THREADS = 256;          // the stats, split and attention kernels
constexpr int ROWS = 64;              // tokens of an 8x8 window
constexpr int HD = 24;                // head_dim
constexpr int GROUP = 96;             // columns of 4 heads: the attention's tile width
constexpr int HEADS_PER_BLOCK = GROUP / HD;
constexpr int QKV_LD = GROUP + 4;     // padded row stride of the staged q, k, v
constexpr float LN_EPS = 1e-5f;

// The warp-specialised GEMM: CONSUMERS warpgroups of 64 rows each, then a producer warpgroup
// (one of its threads issues the TMA copies; setmaxnreg takes whole warpgroups).
constexpr int CONSUMERS = 2;
constexpr int WS_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;    // 2 * 128 * 232 + 128 * 40 = 384 * 168: the launch's
constexpr int BM = 64 * CONSUMERS;    // rows of a tile: two windows
constexpr int KS = 32;                // depth of a slab: one 128-byte swizzled row a value row
constexpr int SMEM_LIMIT = 232448;    // bytes of shared memory a block may take
constexpr int BARRIER_BYTES = 1024;   // the ring's mbarriers, ahead of the buffers
constexpr int MAX_LN_WIDTH = 1024;    // LayerNorm gamma and beta staged in shared memory
constexpr int MAX_SWIN_WIDTH = 768;   // the widest Swin stage the two launches take

enum Epilogue { EPI_BIAS = 0, EPI_RESIDUAL = 1 };
enum OnLoad { A_PLAIN = 0, A_LN = 1, A_GELU = 2 };  // what a GEMM applies to A as it reads it

template <int BN>
struct GemmCfg {
  static constexpr int A_BYTES = BM * KS * 4;                   // [128, 32] of A
  static constexpr int B_BYTES = BN * KS * 4;                   // [BN, 32] of W^T hi (and lo)
  static constexpr int SLOT_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int PARAM_BYTES = 2 * MAX_LN_WIDTH * 4;
  // the barriers, the ring from a 1024-byte boundary (the swizzle's atom), gamma and beta
  static constexpr int FIXED = 2 * BARRIER_BYTES + PARAM_BYTES;
  static constexpr int STAGES = (SMEM_LIMIT - FIXED) / SLOT_BYTES;
  static constexpr int SMEM = FIXED + STAGES * SLOT_BYTES;
  static_assert(STAGES >= 3 && SLOT_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "the ring");
};

// GELU with the Pallas kernel's erf (_erf_f32, pallas_window_attn.py:98: Abramowitz-Stegun
// 7.1.26, within 1.5e-7 of erf), a third of erff's instructions.
__device__ __forceinline__ float gelu(float v) {
  const float z = fabsf(v * 0.70710678118654752f);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, z, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf_z = 1.0f - poly * __expf(-z * z);
  return 0.5f * v * (1.0f + copysignf(erf_z, v));
}

// d += a @ b for one m16n8k8 TF32 tile (a row-major 16 x 8, b column-major 8 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the weights: W [k, n] -> [2, n, k], hi then lo of W^T ----

// Block (blockIdx.x, blockIdx.y) transposes the 32 x 32 tile at rows 32 blockIdx.y, columns
// 32 blockIdx.x of w through shared memory (coalesced both ways). k % 32 == 0, n % 32 == 0.
__global__ void __launch_bounds__(THREADS)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ out, int k, int n) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
#pragma unroll
  for (int r = ty; r < 32; r += THREADS / 32) tile[r][tx] = w[(long long)(i0 + r) * n + j0 + tx];
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += THREADS / 32) {
    uint32_t hi, lo;
    split_tf32(tile[tx][r], hi, lo);
    const long long o = (long long)(j0 + r) * k + i0 + tx;
    out[o] = __uint_as_float(hi);
    out[(long long)n * k + o] = __uint_as_float(lo);
  }
}

// ---- LayerNorm statistics ----

// stats[row] = (mean, 1 / sqrt(var + eps)) of each row of x [m, c], two-pass: eight lanes a row
// (four rows a warp), each reading 16-byte pieces l, l + 8, ... of it, the second pass from L1.
// c % 32 == 0.
constexpr int STATS_LANES = 8;

__global__ void __launch_bounds__(THREADS)
row_stats_kernel(const float* __restrict__ x, float2* __restrict__ stats, int m, int c) {
  const int lane = threadIdx.x % STATS_LANES;
  const int row = (blockIdx.x * THREADS + threadIdx.x) / STATS_LANES;
  const float4* p = reinterpret_cast<const float4*>(x + (long long)(row < m ? row : 0) * c);
  float s = 0.0f;
  for (int i = lane; i < c / 4; i += STATS_LANES) {
    const float4 v = p[i];
    s += (v.x + v.y) + (v.z + v.w);
  }
#pragma unroll
  for (int o = 1; o < STATS_LANES; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / c;
  float var = 0.0f;
  for (int i = lane; i < c / 4; i += STATS_LANES) {
    const float4 v = p[i];
    var = fmaf(v.x - mean, v.x - mean, var);
    var = fmaf(v.y - mean, v.y - mean, var);
    var = fmaf(v.z - mean, v.z - mean, var);
    var = fmaf(v.w - mean, v.w - mean, var);
  }
#pragma unroll
  for (int o = 1; o < STATS_LANES; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
  if (lane == 0 && row < m) stats[row] = make_float2(mean, 1.0f / sqrtf(var / c + LN_EPS));
}

// ---- the GEMM ----
//
// The ring: STAGES slots, a "full" and an "empty" mbarrier each, ahead of the buffers. Slab t of
// a block's life goes to slot t % STAGES, its u = t / STAGES-th use of the slot: the producer
// waits for the slot's empty barrier to complete phase u - 1 (the first use passes at once),
// and has TMA fill it, the full barrier counting the bytes; the consumers wait for the full
// barrier's phase u, and each consumer warp arrives on the empty barrier once its warpgroup's
// products on the slab are done.

struct RingPos {
  int slot = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
};

// out[r, j] for r < m, j < n of
//   EPI_BIAS:     op(a) @ w + bias
//   EPI_RESIDUAL: residual + (op(a) @ w + bias)
// with op(a)[r, i] = (a[r, i] - mean_r) * rstd_r * ln_g[i] + ln_b[i] (stats[r] = (mean_r,
// rstd_r)) for A_LN, GELU(a[r, i]) for A_GELU, a for A_PLAIN. Applied as A is read, GELU runs
// while the products run (fc2 reads fc1's pre-activation); as an epilogue it would not, and it
// doubled fc1's time at C = 96 (PERF.md). a [m, k] row-major (tensor map ta: boxes of 32 values
// by 128 rows), w given as its split transpose [2, n, k] (tb: boxes of 32 values by BN rows),
// both in TMA's 128-byte swizzle. Block b takes tiles b, b + gridDim.x, ... of [128, BN], column
// tiles fastest; consumer warpgroup i the tile's rows 64 i .. 64 i + 63. Rows past m read as
// zero and are not stored. k % 32 == 0, n % BN == 0, k <= MAX_LN_WIDTH for A_LN.
template <int BN, int EPI, int AOP>
__global__ void __launch_bounds__(WS_THREADS, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const float2* __restrict__ stats, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, const float* __restrict__ bias,
                 const float* __restrict__ residual, float* __restrict__ out, int m, int n,
                 int k) {
  using G = GemmCfg<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + G::STAGES;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((raw + 2 * BARRIER_BYTES - 1) / 1024 * 1024 - raw);
  float* params = reinterpret_cast<float*>(ring + G::STAGES * G::SLOT_BYTES);  // gamma, beta
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n_tiles = n / BN, tiles = (m + BM - 1) / BM * n_tiles, slabs = k / KS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * CONSUMERS);  // a consumer warp's lane 0 each
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    hopper::regs_dec<PRODUCER_REGS>();
    if (t == 0) {
      RingPos pos;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int s = 0; s < slabs; ++s) {
          hopper::mbar_wait(empty + pos.slot, pos.parity ^ 1);
          unsigned char* dst = ring + pos.slot * G::SLOT_BYTES;
          uint64_t* bar = full + pos.slot;
          hopper::mbar_arrive_expect_tx(bar, G::SLOT_BYTES);
          hopper::tma_load_2d(dst, &ta, s * KS, m0, bar);
          hopper::tma_load_2d(dst + G::A_BYTES, &tb, s * KS, n0, bar);                // hi
          hopper::tma_load_2d(dst + G::A_BYTES + G::B_BYTES, &tb, s * KS, n + n0, bar);  // lo
          pos.next(G::STAGES);
        }
      }
    }
  } else {
    hopper::regs_inc<CONSUMER_REGS>();
    const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    if (AOP == A_LN) {
      for (int i = threadIdx.x; i < k; i += 128 * CONSUMERS) {
        params[i] = ln_g[i];
        params[MAX_LN_WIDTH + i] = ln_b[i];
      }
      hopper::named_barrier(1, 128 * CONSUMERS);
    }
    // This thread's A rows within the warpgroup's 64 (fragment rows g and g + 8 of its warp's
    // 16), and their byte offsets in a slot: row r at 128 r, its 16-byte chunk c at chunk
    // c ^ (r % 8) (the swizzle; both rows have r % 8 == g).
    const int lrow = 16 * warp + g;
    const int a_off0 = (64 * wg + lrow) * 128 + 4 * q, a_off1 = a_off0 + 8 * 128;
    auto first_row = [&](int tile) { return tile / n_tiles * BM + 64 * wg + lrow; };

    // The slabs this warpgroup takes, tile by tile, are one sequence: (tile, s) and its slot.
    // Each step issues the products of the current slab, and while they run loads and splits
    // the next slab's A fragments (into the other of two fragment sets) and, at a tile's first
    // slab, stores the previous tile; then it waits, frees the slot and folds.
    RingPos pos;
    int tile = blockIdx.x, s = 0, slot = 0, done = -1;  // done: a tile whose total awaits its store
    float mean[2] = {0.0f, 0.0f}, rstd[2] = {1.0f, 1.0f};  // LN of the rows being loaded
    float total[BN / 2], part[BN / 2] = {};
    uint32_t hi0[KS / 8][4], lo0[KS / 8][4], hi1[KS / 8][4], lo1[KS / 8][4];

    // Waits for slab s of `tile` and loads its A fragments: k-step kk takes columns 8 kk + q
    // (a[0], a[1]) and 8 kk + q + 4 (a[2], a[3]), chunks 2 kk and 2 kk + 1 before the swizzle.
    auto load = [&](int tile_, int s_, uint32_t (&hi)[KS / 8][4], uint32_t (&lo)[KS / 8][4]) {
      if (AOP == A_LN && s_ == 0) {
        const int row0 = first_row(tile_);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 st = row0 + 8 * h < m ? stats[row0 + 8 * h] : make_float2(0.0f, 1.0f);
          mean[h] = st.x;
          rstd[h] = st.y;
        }
      }
      const int slot_ = pos.slot;
      hopper::mbar_wait(full + slot_, pos.parity);
      pos.next(G::STAGES);
      const unsigned char* base = ring + slot_ * G::SLOT_BYTES;
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e & 1, chunk = 2 * kk + (e >> 1);
          float v = *reinterpret_cast<const float*>(base + (half ? a_off1 : a_off0) +
                                                    ((chunk ^ g) << 4));
          if (AOP == A_LN) {
            const int col = s_ * KS + 4 * chunk + q;
            v = (v - mean[half]) * rstd[half] * params[col] + params[MAX_LN_WIDTH + col];
          } else if (AOP == A_GELU) {
            v = gelu(v);
          }
          split_tf32(v, hi[kk][e], lo[kk][e]);
        }
      }
      return slot_;
    };

    // Stores tile_'s total: + bias (and the residual).
    auto store = [&](int tile_) {
      const int row0 = first_row(tile_), n0 = tile_ % n_tiles * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = n0 + 8 * j + 2 * q;
          if (row < m) {
            const long long o = (long long)row * n + col;
            const float2 bb = *reinterpret_cast<const float2*>(bias + col);
            float v0 = total[4 * j + 2 * h] + bb.x, v1 = total[4 * j + 2 * h + 1] + bb.y;
            if (EPI == EPI_RESIDUAL) {
              const float2 r = *reinterpret_cast<const float2*>(residual + o);
              v0 = r.x + v0;
              v1 = r.y + v1;
            }
            *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
          }
        }
      }
    };

    // One slab: the products of cur, the next slab into nxt meanwhile; false past the last.
    auto step = [&](uint32_t (&cur_hi)[KS / 8][4], uint32_t (&cur_lo)[KS / 8][4],
                    uint32_t (&nxt_hi)[KS / 8][4], uint32_t (&nxt_lo)[KS / 8][4]) {
      const unsigned char* b_hi = ring + slot * G::SLOT_BYTES + G::A_BYTES;
      const unsigned char* b_lo = b_hi + G::B_BYTES;
      hopper::fence_regs(part);
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {  // the first product of the slab starts it afresh
        hopper::tf32::mma_rs<BN>(part, cur_lo[kk], hopper::desc_a_sw128(b_hi, kk), kk > 0);
        hopper::tf32::mma_rs<BN>(part, cur_hi[kk], hopper::desc_a_sw128(b_lo, kk), 1);
        hopper::tf32::mma_rs<BN>(part, cur_hi[kk], hopper::desc_a_sw128(b_hi, kk), 1);
      }
      hopper::commit();
      int next_tile = tile, next_s = s + 1;
      if (next_s == slabs) {
        next_s = 0;
        next_tile += gridDim.x;
      }
      const bool more = next_tile < tiles;
      const int next_slot = more ? load(next_tile, next_s, nxt_hi, nxt_lo) : 0;
      if (s == 0 && done >= 0) store(done);  // total is free until this slab's fold
      hopper::wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {
        hopper::tf32::fence_frag(cur_hi[kk]);
        hopper::tf32::fence_frag(cur_lo[kk]);
      }
      if (lane == 0) hopper::mbar_arrive(empty + slot);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) total[i] = s == 0 ? part[i] : total[i] + part[i];
      if (s == slabs - 1) done = tile;
      tile = next_tile;
      s = next_s;
      slot = next_slot;
      return more;
    };

    if (tile < tiles) {
      slot = load(tile, 0, hi0, lo0);
      while (step(hi0, lo0, hi1, lo1) && step(hi1, lo1, hi0, lo0)) {
      }
      store(done);
    }
  }
}

// ---- the attention ----

// Attention of one group of HEADS_PER_BLOCK heads over one window: q of the group's GROUP
// columns read from device memory (q, rows q_ld apart: each value is read by one thread, once),
// k and v staged in shared memory ([ROWS][QKV_LD] each), head hh at columns hh*24 .. +23; the
// window's mask rows mask_w [64, 64]. Warp w takes head w/2 of the group and query rows
// 32*(w%2) .. +31, one m16 tile at a time; fragment rows are g and g + 8 of the tile, S columns
// (keys) 8j + 2t and 8j + 2t + 1. store(row, col, v0, v1) takes the outputs of the neighbouring
// group columns col, col + 1 of a row. Reads shared memory only after the caller's
// __syncthreads.
template <class Store>
__device__ __forceinline__ void attend_group(const float* __restrict__ q, int q_ld,
                                             const float* k_s, const float* v_s,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ mask_w, int group,
                                             float scale, Store&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = warp / 2;
  const int h = group * HEADS_PER_BLOCK + hh;
  q += hh * HD;
  k_s += hh * HD;
  v_s += hh * HD;
  const float* bias_h = bias + (long long)h * ROWS * ROWS;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * (warp % 2) + 16 * mt;
    // S[r0 .. r0+15, keys 8j .. 8j+7], all 24 deep in a fresh accumulator: the small cross
    // terms of each k-step first, then hi*hi.
    float s[ROWS / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      uint32_t ahi[4], alo[4];
      const float* p = q + (long long)(r0 + g) * q_ld + 8 * ks + t;
      split_tf32(p[0], ahi[0], alo[0]);
      split_tf32(p[8LL * q_ld], ahi[1], alo[1]);
      split_tf32(p[4], ahi[2], alo[2]);
      split_tf32(p[8LL * q_ld + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        const float* pk = k_s + (8 * j + g) * QKV_LD + 8 * ks + t;  // B[d][key] = k[key][d]
        uint32_t bhi[2], blo[2];
        split_tf32(pk[0], bhi[0], blo[0]);
        split_tf32(pk[4], bhi[1], blo[1]);
        mma_tf32(s[j], alo, bhi);
        mma_tf32(s[j], ahi, blo);
        mma_tf32(s[j], ahi, bhi);
      }
    }
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (r0 + g + 8 * half) * ROWS + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias_h + off);
        const float2 mm = *reinterpret_cast<const float2*>(mask_w + off);
        s[j][2 * half] = s[j][2 * half] * scale + bb.x + mm.x;
        s[j][2 * half + 1] = s[j][2 * half + 1] * scale + bb.y + mm.y;
        row_max[half] = fmaxf(row_max[half], fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      }
    }
    float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      row_max[half] = fmaxf(row_max[half], __shfl_xor_sync(0xffffffffu, row_max[half], 1));
      row_max[half] = fmaxf(row_max[half], __shfl_xor_sync(0xffffffffu, row_max[half], 2));
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][2 * half + e] = expf(s[j][2 * half + e] - row_max[half]);
          row_sum[half] += s[j][2 * half + e];
        }
      }
      row_sum[half] += __shfl_xor_sync(0xffffffffu, row_sum[half], 1);
      row_sum[half] += __shfl_xor_sync(0xffffffffu, row_sum[half], 2);
      // A product by the reciprocal (within an ulp of the quotient): an IEEE division takes
      // its slow path on the masked keys' denormal exponentials.
      const float inv = 1.0f / row_sum[half];
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        s[j][2 * half] *= inv;
        s[j][2 * half + 1] *= inv;
      }
    }
    // O = P v. The k-step j takes keys 8j + 2t (k index t) and 8j + 2t + 1 (k index t + 4),
    // so the A fragment is the S fragment itself and B reads v rows in that order. Each 32 keys
    // (4 k-steps) go into a fresh accumulator that a float32 add folds into o.
    float o[HD / 8][4] = {};
#pragma unroll
    for (int j0 = 0; j0 < ROWS / 8; j0 += 4) {
      float part[HD / 8][4] = {};
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
        uint32_t ahi[4], alo[4];
        split_tf32(s[j][0], ahi[0], alo[0]);  // (g, key 8j + 2t)
        split_tf32(s[j][2], ahi[1], alo[1]);  // (g + 8, key 8j + 2t)
        split_tf32(s[j][1], ahi[2], alo[2]);  // (g, key 8j + 2t + 1)
        split_tf32(s[j][3], ahi[3], alo[3]);  // (g + 8, key 8j + 2t + 1)
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float* pv = v_s + (8 * j + 2 * t) * QKV_LD + 8 * n + g;
          uint32_t bhi[2], blo[2];
          split_tf32(pv[0], bhi[0], blo[0]);
          split_tf32(pv[QKV_LD], bhi[1], blo[1]);
          mma_tf32(part[n], alo, bhi);
          mma_tf32(part[n], ahi, blo);
          mma_tf32(part[n], ahi, bhi);
        }
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += part[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store(r0 + g + 8 * half, hh * HD + 8 * n + 2 * t, o[n][2 * half], o[n][2 * half + 1]);
      }
    }
  }
}

// k and v of a block's heads, 51 KB.
constexpr int ATTN_SMEM_FLOATS = 2 * ROWS * QKV_LD;

// The attention of window blockIdx.x, heads 4*blockIdx.y .. +3, from qkv [bw*64, 3c] (q | k |
// v, b_qkv added), into attn [bw*64, c].
__global__ void __launch_bounds__(THREADS)
attention_from_qkv_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, int mask_count,
                          float* __restrict__ attn, int c, float scale) {
  extern __shared__ __align__(16) float smem[];  // k, v of this block's heads: [2][ROWS][QKV_LD]
  const long long win = blockIdx.x;
  const int group = blockIdx.y;
  const float* src = qkv + win * ROWS * 3 * c + group * GROUP;
  for (int i = threadIdx.x; i < 2 * ROWS * (GROUP / 4); i += THREADS) {
    const int part = i / (ROWS * (GROUP / 4)), r = (i / (GROUP / 4)) % ROWS;
    const int col = 4 * (i % (GROUP / 4));
    hopper::cp_async16(smem + (part * ROWS + r) * QKV_LD + col,
                       src + (long long)r * 3 * c + (part + 1) * c + col);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* dst = attn + win * ROWS * c + group * GROUP;
  attend_group(src, 3 * c, smem, smem + ROWS * QKV_LD, bias,
               mask + (win % mask_count) * ROWS * ROWS, group, scale,
               [=](int r, int col, float v0, float v1) {
                 *reinterpret_cast<float2*>(dst + r * c + col) = make_float2(v0, v1);
               });
}

// ---- host side ----

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int check_args(int bw, int c, int heads, int mask_count) {
  if (bw <= 0 || heads <= 0 || heads % HEADS_PER_BLOCK || c != heads * HD || mask_count <= 0 ||
      c > MAX_SWIN_WIDTH) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int sm_count(int* count) {
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err) return err;
  return (int)cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
}

// cuTensorMapEncodeTiled, reached through the runtime: the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map over the row-major float32 matrix p [rows, cols]: boxes of 32 values (128 bytes,
// 128-byte swizzle) by box_rows rows; rows past the end read as zero.
int tensor_map(CUtensorMap* map, const float* p, long long rows, int cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const int err = (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                                 &found);
    if (err || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return err ? err : (int)cudaErrorSymbolNotFound;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)KS, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int EPI, int AOP>
int launch_gemm_bn(const float* a, const float* w_split, const float2* stats, const float* ln_g,
                   const float* ln_b, const float* bias, const float* residual, float* out, int m,
                   int n, int k, int sms, cudaStream_t stream) {
  using G = GemmCfg<BN>;
  CUtensorMap ta, tb;
  int err = tensor_map(&ta, a, m, k, BM);
  if (!err) err = tensor_map(&tb, w_split, 2LL * n, k, BN);
  if (!err) err = set_smem(gemm_tf32_kernel<BN, EPI, AOP>, G::SMEM);
  if (err) return err;
  const int tiles = (m + BM - 1) / BM * (n / BN);  // persistent: at most a block an SM
  gemm_tf32_kernel<BN, EPI, AOP><<<tiles < sms ? tiles : sms, WS_THREADS, G::SMEM, stream>>>(
      ta, tb, stats, ln_g, ln_b, bias, residual, out, m, n, k);
  return (int)cudaGetLastError();
}

// The GEMM with [128, 128] or [128, 96] tiles, whichever divides n and leaves the least work on
// the busiest SM (rounds of tiles times their width; a tie goes to 128): at B = 64, 96 for
// stage 4's qkv (768 tiles, 6 rounds of 132 SMs, against 576 in 5 rounds of 128) and proj (256
// against 192 tiles: 2 rounds either way), and for n = 288, 576, 96 and 192.
template <int EPI, int AOP>
int launch_gemm(const float* a, const float* w_split, const float2* stats, const float* ln_g,
                const float* ln_b, const float* bias, const float* residual, float* out, int m,
                int n, int k, cudaStream_t stream) {
  if (k % KS || (AOP == A_LN && k > MAX_LN_WIDTH)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const long long m_tiles = (m + BM - 1) / BM;
  auto work = [&](int bn) { return (m_tiles * (n / bn) + sms - 1) / sms * bn; };
  if (n % 128 == 0 && (n % 96 || work(128) <= work(96))) {
    return launch_gemm_bn<128, EPI, AOP>(a, w_split, stats, ln_g, ln_b, bias, residual, out, m, n,
                                        k, sms, stream);
  }
  if (n % 96 == 0) {
    return launch_gemm_bn<96, EPI, AOP>(a, w_split, stats, ln_g, ln_b, bias, residual, out, m, n,
                                       k, sms, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_stats(const float* x, float2* stats, int m, int c, cudaStream_t stream) {
  constexpr int rows = THREADS / STATS_LANES;
  row_stats_kernel<<<(m + rows - 1) / rows, THREADS, 0, stream>>>(x, stats, m, c);
  return (int)cudaGetLastError();
}

// LN1 statistics, qkv = LN1(x) @ w_qkv + b_qkv, the attention into attn, and
// x + attn @ w_proj + b_proj into out.
int attention_half(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                   const float* bproj, const float* bias, const float* mask, int mask_count,
                   const float* g1, const float* b1, float2* stats, float* qkv, float* attn,
                   float* out, int bw, int c, int heads, cudaStream_t s) {
  const int m = bw * ROWS;
  int err = launch_stats(x, stats, m, c, s);
  if (!err) {
    err = launch_gemm<EPI_BIAS, A_LN>(x, wqkv, stats, g1, b1, bqkv, nullptr, qkv, m, 3 * c, c, s);
  }
  if (!err) err = set_smem(attention_from_qkv_kernel, ATTN_SMEM_FLOATS * (int)sizeof(float));
  if (err) return err;
  attention_from_qkv_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS,
                              ATTN_SMEM_FLOATS * sizeof(float), s>>>(
      qkv, bias, mask, mask_count, attn, c, 1.0f / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_gemm<EPI_RESIDUAL, A_PLAIN>(attn, wproj, nullptr, nullptr, nullptr, bproj, x, out,
                                            m, c, c, s);
}

}  // namespace

extern "C" {

// out [2, n, k] = hi and lo of the transpose of w [k, n] (float32, row-major): the layout the
// GEMMs take their weights in. k % 32 == 0, n % 32 == 0. Launches on `stream` and returns the
// cudaError_t (0 = ok). Does not synchronise and allocates nothing.
int tf32_split_launch(const float* w, int k, int n, float* out, void* stream) {
  if (k <= 0 || n <= 0 || k % 32 || n % 32) return (int)cudaErrorInvalidValue;
  split_weights_kernel<<<dim3(n / 32, k / 32), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, out, k, n);
  return (int)cudaGetLastError();
}

// out [m, n] = op(a) @ w + bias (+ residual): with on_load 1 (A_LN) the LayerNorm statistics of
// a's rows into stats [m] (mean, rstd) and the GEMM with LN on load (ln_g, ln_b [k], k <=
// MAX_LN_WIDTH) and the bias; with on_load 0 (A_PLAIN) or 2 (A_GELU) the GEMM with the bias and
// the residual [m, n]. No other form is taken. a [m, k] and residual row-major float32, w_split
// the weight's tf32_split form [2, n, k]; k % 32 == 0, n % 96 == 0 or n % 128 == 0. Same
// conventions as window_attention_launch.
int gemm_tf32_launch(const float* a, const float* w_split, const float* bias,
                     const float* residual, const float* ln_g, const float* ln_b, float* stats,
                     float* out, int m, int n, int k, int on_load, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on_load == A_LN && residual == nullptr) {
    float2* st = reinterpret_cast<float2*>(stats);
    const int err = launch_stats(a, st, m, k, s);
    if (err) return err;
    return launch_gemm<EPI_BIAS, A_LN>(a, w_split, st, ln_g, ln_b, bias, nullptr, out, m, n, k, s);
  }
  if (on_load == A_PLAIN && residual != nullptr) {
    return launch_gemm<EPI_RESIDUAL, A_PLAIN>(a, w_split, nullptr, nullptr, nullptr, bias,
                                              residual, out, m, n, k, s);
  }
  if (on_load == A_GELU && residual != nullptr) {
    return launch_gemm<EPI_RESIDUAL, A_GELU>(a, w_split, nullptr, nullptr, nullptr, bias,
                                             residual, out, m, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x + proj(attn(LN1(x))) into out [bw, 64, c], in four launches: the LN1 statistics, the qkv
// GEMM with LN1 on load and b_qkv, the attention, the proj GEMM with b_proj and the residual.
// wqkv and wproj are the weights' tf32_split forms ([2, 3c, c] and [2, c, c]). Scratch: stats
// [bw*64] (mean, rstd), qkv [bw*64, 3c], a [bw*64, c] (attn). Launches on `stream` and returns
// the first cudaError_t (0 = ok; cudaErrorInvalidValue for shapes the kernels do not take).
// Does not synchronise and allocates nothing.
int window_attention_launch(const float* x, const float* wqkv, const float* bqkv,
                            const float* wproj, const float* bproj, const float* bias,
                            const float* mask, int mask_count, const float* g1, const float* b1,
                            float* stats, float* a, float* qkv, float* out, int bw, int c,
                            int heads, void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  if (bw > 65535) return (int)cudaErrorInvalidValue;  // the wrapper's KERNEL_MAX_WINDOWS
  return attention_half(x, wqkv, bqkv, wproj, bproj, bias, mask, mask_count, g1, b1,
                        reinterpret_cast<float2*>(stats), qkv, a, out, bw, c, heads,
                        static_cast<cudaStream_t>(stream));
}

// The whole block into out [bw, 64, c], c = 96, 192 or 384, in seven launches: the attention
// half into x2 (as window_attention_launch), the LN2 statistics, the fc1 GEMM with LN2 on load
// and b_fc1 into the hidden layer (before GELU), the fc2 GEMM with GELU on load, b_fc2 and the
// residual x2. Weights in
// their tf32_split forms. Scratch: stats [bw*64] (mean, rstd), work [bw*64, 4c] (qkv and attn,
// then the hidden layer), x2 [bw*64, c]. Same conventions as window_attention_launch.
int swin_block_launch(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                      const float* bproj, const float* bias, const float* mask, int mask_count,
                      const float* g1, const float* b1, const float* g2, const float* b2,
                      const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                      float* stats, float* work, float* x2, float* out, int bw, int c, int heads,
                      void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  if (c != 96 && c != 192 && c != 384) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = bw * ROWS;
  float2* st = reinterpret_cast<float2*>(stats);
  err = attention_half(x, wqkv, bqkv, wproj, bproj, bias, mask, mask_count, g1, b1, st, work,
                       work + (long long)m * 3 * c, x2, bw, c, heads, s);
  if (!err) err = launch_stats(x2, st, m, c, s);
  if (!err) {
    err = launch_gemm<EPI_BIAS, A_LN>(x2, wfc1, st, g2, b2, bfc1, nullptr, work, m, 4 * c, c, s);
  }
  if (err) return err;
  return launch_gemm<EPI_RESIDUAL, A_GELU>(work, wfc2, nullptr, nullptr, nullptr, bfc2, x2, out, m,
                                           c, 4 * c, s);
}

}  // extern "C"
