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
// LayerNorm is two-pass with eps 1e-5, GELU the exact erf form (erff), softmax subtracts the
// row max.
//
// Arithmetic: every matrix product (q, k, v, q k^T, p v, proj, fc1, fc2) runs on the tensor
// cores as 3xTF32: each float32 operand is split into hi = tf32(a) (cvt.rna) and lo =
// tf32(a - hi), and a*b is formed as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
// mma.sync.m16n8k8 TF32. Each k-step's three products go into a zeroed fragment that a
// float32 add folds into the accumulator (mma_3xtf32 says why; window_attention_fused's GEMMs
// fold once a 32-deep slab). That keeps float32 accuracy
// (about 2^-21 relative per product against 2^-24), so the port's exact-float32 rule holds;
// plain 1xTF32 (2^-11) would not. Softmax, LayerNorm, GELU and the epilogues stay float32
// SIMT.
//
// What bounds it on the H100: for M = BW * 64 tokens the block does 24*M*C^2 + 4*M*64*C
// flops (qkv 6, proj 2, fc1 8, fc2 8 times M*C^2; q k^T and p v 4*M*64*C), the attention
// half 8*M*C^2 + 4*M*64*C, and must move only x, out and the weights. Float32-accurate
// products run at most at 495 / 3 = 165 TFLOP/s (dense TF32 over the three products of the
// split): about 49 flops per byte at 3.35 TB/s, against some 200 for the block at C = 96. So
// both kernels are bound by operations.
//
// How it is laid out. A window's qkv [64, 3C] and hidden layer [64, 4C] are 288 KB and
// 384 KB at C = 384, beyond a block's 227 KB of shared memory, so the block is two launches:
// 1. window_attention_core_kernel, one block per (window, group of 4 heads): the LayerNorm
//    statistics of the window's 64 rows; q, k and v of its 4 heads ([64, 96] each, LN1
//    applied to each staged slab of x) kept in shared memory (77 KB); then one warp per
//    (head, 32 query rows): S = q k^T (3 k-steps of 8), bias + mask, softmax from the row max
//    in registers, P v (8 k-steps of 8 keys). The p v k-step takes keys in the order 2t, 2t+1
//    of the S fragment, so P goes from the accumulator to the A operand with no exchange.
//    Writes its heads' columns of attn [M, C], the only intermediate in device memory.
//    Splitting heads over blocks gives stage 4 (64 windows at a batch of 64) 512 blocks.
// 2. swin_mlp_kernel<C>, one block per window (C = 96, 192, 384, with 4, 8 and 12 warps: as
//    few as hold the [64, C] accumulator in registers): proj + b_proj + x -> x2 in
//    registers; LN2(x2) staged in shared memory ([64, C], 97 KB at C = 384); the accumulator
//    starts as x2 + b_fc2, and for each 96-column chunk of the hidden layer
//    h = GELU(LN2(x2) @ W1[:, chunk] + b1) is kept in shared memory and acc += h @ W2[chunk, :].
//    Only out is written: x2 and the hidden layer never reach device memory.
// The block's products go through one building block, block_mma: a [64, NT] tile of op(A) @
// W, its warps in 2 rows of 32 by WARPS / 2 columns; W (and A, where it comes from device
// memory) streamed from L2 in [KT, NT] slabs through a two-stage cp.async ring, so a slab's
// load overlaps the previous slab's products. Row strides are padded (A: 4 mod 32 floats, W: 8
// mod 32) so that the fragment loads are free of bank conflicts.
//
// window_attention_fused (CLAP stage 4: C = 768, one window an image, 64 windows at B = 64)
// has kernels of its own, since 96 % of its work is two products whose weights are the same
// for every window: qkv [M, C] @ [C, 3C] and proj [M, C] @ [C, C] over all M = BW * 64
// tokens (20.1 GFLOP at B = 64, 0.122 ms at 165 TFLOP/s). Run per (window, 4 heads) as the
// block's core does, each of 512 blocks would stream the window's x three times, normalise it
// each time, and split both operands in every k-step of 32 x 24 warp tiles. Instead, in four
// launches:
// 1. ln_rows_kernel: LN1(x), the row statistics taken once per token, to device memory;
// 2. gemm_3xtf32_kernel<128, 128>: qkv = LN1(x) @ w_qkv + b_qkv over [128, 128] token x
//    column tiles (576 blocks at stage 4), to device memory;
// 3. attention_from_qkv_kernel: per (window, 4 heads), q, k, v staged from qkv, then the core's
//    attention (attend_group), attn to device memory;
// 4. gemm_3xtf32_kernel<64, 128>: out = x + attn @ w_proj + b_proj (384 blocks: 2.9 waves of
//    132 SMs where [128, 128] tiles would give 1.5).
// The GEMM streams float32 A and W slabs (32 deep) through a four-stage cp.async ring and
// gives each warp a [64, 32] or [32, 32] tile: a fragment is split into TF32 hi and lo in
// registers once and feeds 4 (A) or 2-4 (B) m16n8 tiles, and a slab's products are folded
// once. Operands split once ahead of the GEMM (hi and lo in device memory) were measured
// slower: they double the bytes each block streams, which bound the GEMM (PERF.md).
// The intermediates (LN1(x), qkv, attn) add about 0.13 GB of traffic at B = 64, 0.04 ms at
// 3.35 TB/s, under the products' bound.
//
// The wrapper (ops/window_attn.py) checks shapes, types, devices, contiguity and 16-byte
// alignment, and allocates the output and the scratch; a CUDA tensor reaches these
// kernels or the wrapper raises, and there is no fallback to the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // eight warps: every kernel but swin_mlp_kernel<C>
// Warps of swin_mlp_kernel<C>: as few as keep its [64, C] fc2 accumulator and fc1 chunk in
// registers without spilling (fewer warps, larger warp tiles, more reuse of each fragment):
// at C = 384, 12 warps hold 64 accumulator floats a thread.
template <int C>
constexpr int mlp_warps() {
  return C == 96 ? 4 : C == 192 ? 8 : 12;
}
constexpr int ROWS = 64;              // tokens of an 8x8 window: the rows of every block tile
constexpr int HD = 24;                // head_dim
constexpr int GROUP = 96;             // columns of 4 heads: the attention core's tile width
constexpr int HEADS_PER_BLOCK = GROUP / HD;
constexpr int QKV_LD = GROUP + 4;     // padded row stride of the staged q, k, v
constexpr int HIDDEN_CHUNK = 96;      // hidden columns kept on chip at a time
constexpr int H_LD = HIDDEN_CHUNK + 4;
constexpr int CORE_KT = 16;           // slab depths of the products: q, k and v
constexpr int WIDE_KT = 16;           // proj and fc2 in the MLP kernel ([KT, C] weight slabs)
constexpr int FC1_KT = 32;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), both rounded to nearest with ties away
// from zero. hi is formed with two integer operations (add half a TF32 ulp to the magnitude
// bits, clear the 13 low bits), which gives the bits of cvt.rna.tf32.f32 for every finite a and
// is cheaper than the conversion; lo takes cvt.rna itself.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float rest = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a @ b for one m16n8k8 TF32 tile (a row-major 16 x 8, b column-major 8 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b for one k-step in 3xTF32: the small cross terms first, then hi*hi, into a
// zeroed fragment that a float32 add folds into d. The tensor core aligns its addends to the
// largest and drops the bits below, so a long chain into a large accumulator (the MLP's
// starts at x2) loses up to an ulp of it per product; a fresh fragment a k-step keeps that
// loss relative to the k-step's own partial sum, and d rounds to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, alo, bhi);
  mma_tf32(p, ahi, blo);
  mma_tf32(p, ahi, bhi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Two-pass LayerNorm statistics of the 64 rows of a [64, k] matrix with row stride lda (device
// or shared memory): the mean and 1 / sqrt(var + eps) of each row, one warp per row.
template <int WARPS>
__device__ __forceinline__ void row_stats(const float* a, int lda, int k, float* mean_s,
                                          float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < ROWS; r += WARPS) {
    const float* p = a + (long long)r * lda;
    float s = 0.0f;
    for (int c = lane; c < k; c += 32) s += p[c];
    const float mean = warp_sum(s) / k;
    float v = 0.0f;
    for (int c = lane; c < k; c += 32) {
      const float d = p[c] - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / k + LN_EPS);
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Floats of block_mma's two-stage ring: per stage a [64, KT] slab of A (when streamed) and a
// [KT, NT] slab of W, with padded rows.
template <int NT, int KT, bool A_STREAM>
constexpr int ring_floats() {
  return 2 * ((A_STREAM ? ROWS * (KT + 4) : 0) + KT * (NT + 8));
}

// block_mma's warp tiling of a [64, NT] tile over WARPS warps: 2 warp rows of 32 (two m16
// tiles) by WARPS / 2 warp columns of NT / (WARPS / 2) (N_TILES n8 tiles).
template <int NT, int WARPS>
struct Tiling {
  static constexpr int COLS = WARPS / 2;
  static constexpr int WN = NT / COLS;
  static constexpr int N_TILES = WN / 8;
  static_assert(WARPS % 2 == 0 && NT % (8 * COLS) == 0, "whole n8 tiles per warp");
};

// Calls f(row, col, acc[..][0 or 2], acc[..][1 or 3]) for the two neighbouring columns (col,
// col + 1) of each row that this thread holds of a [64, NT] block_mma accumulator.
template <int NT, int WARPS, class F>
__device__ __forceinline__ void for_each_pair(
    float (&acc)[2][Tiling<NT, WARPS>::N_TILES][4], F&& f) {
  using T = Tiling<NT, WARPS>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 32 * (warp / T::COLS) + lane / 4;
  const int col0 = (warp % T::COLS) * T::WN + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::N_TILES; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f(row0 + 16 * mt + 8 * h, col0 + 8 * nt, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// The one GEMM building block: acc += op(A)[0:64, 0:k] @ W[0:k, col0:col0+NT] in 3xTF32 on
// the tensor cores. W is row-major with ldw floats a row, in device memory. A is either
// resident in shared memory (A_STREAM false: a, lda) or in device memory (A_STREAM true: 64
// rows of lda floats from a), streamed beside W; with LN the LayerNorm
// (v - mean_s[r]) * rstd_s[r] * ln_g[k] + ln_b[k] is applied to each streamed slab in place.
// WARPS warps tile the output as Tiling says. k % KT == 0; col0, ldw and lda are multiples of 4
// and the pointers 16-byte
// aligned (cp.async moves 16 bytes). Starts and ends with the ring free: the caller
// synchronises before it when it has just written a resident A.
template <int NT, int KT, int WARPS, bool A_STREAM, bool LN>
__device__ __forceinline__ void block_mma(const float* a, int lda, int k,
                                          const float* __restrict__ w, int ldw, int col0,
                                          float* ring, const float* mean_s, const float* rstd_s,
                                          const float* __restrict__ ln_g,
                                          const float* __restrict__ ln_b,
                                          float (&acc)[2][Tiling<NT, WARPS>::N_TILES][4]) {
  using T = Tiling<NT, WARPS>;
  constexpr int NTHREADS = 32 * WARPS;
  static_assert(KT % 8 == 0, "whole k-steps per slab");
  static_assert(A_STREAM || !LN, "the LayerNorm is applied to streamed slabs");
  constexpr int A_LD = KT + 4;  // 20 or 36 floats: conflict-free A fragments
  constexpr int W_LD = NT + 8;  // 8 mod 32 floats: conflict-free B fragments
  constexpr int A_FLOATS = A_STREAM ? ROWS * A_LD : 0;
  constexpr int STAGE = A_FLOATS + KT * W_LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int arow = 32 * (warp / T::COLS) + g;
  const int bcol = (warp % T::COLS) * T::WN + g;
  const int slabs = k / KT;

  auto load = [&](int s) {
    float* st = ring + (s & 1) * STAGE;
    const int k0 = s * KT;
    if (A_STREAM) {
      for (int i = threadIdx.x; i < ROWS * KT / 4; i += NTHREADS) {
        const int r = i / (KT / 4), c = 4 * (i % (KT / 4));
        cp_async16(st + r * A_LD + c, a + (long long)r * lda + k0 + c);
      }
    }
    float* ws = st + A_FLOATS;
    for (int i = threadIdx.x; i < KT * NT / 4; i += NTHREADS) {
      const int r = i / (NT / 4), c = 4 * (i % (NT / 4));
      cp_async16(ws + r * W_LD + c, w + (long long)(k0 + r) * ldw + col0 + c);
    }
    cp_async_commit();
  };

  load(0);
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* st = ring + (s & 1) * STAGE;
    if (LN) {
      for (int i = threadIdx.x; i < ROWS * KT; i += NTHREADS) {
        const int r = i / KT, c = i % KT;
        float* v = st + r * A_LD + c;
        *v = (*v - mean_s[r]) * rstd_s[r] * ln_g[s * KT + c] + ln_b[s * KT + c];
      }
      __syncthreads();
    }
    const float* as = A_STREAM ? st : a + s * KT;
    const int a_ld = A_STREAM ? A_LD : lda;
    const float* ws = st + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = as + (arow + 16 * mt) * a_ld + kk + t;
        split_tf32(p[0], ahi[mt][0], alo[mt][0]);               // (g, t)
        split_tf32(p[8 * a_ld], ahi[mt][1], alo[mt][1]);        // (g + 8, t)
        split_tf32(p[4], ahi[mt][2], alo[mt][2]);               // (g, t + 4)
        split_tf32(p[8 * a_ld + 4], ahi[mt][3], alo[mt][3]);    // (g + 8, t + 4)
      }
#pragma unroll
      for (int nt = 0; nt < T::N_TILES; ++nt) {
        const float* p = ws + (kk + t) * W_LD + bcol + 8 * nt;
        uint32_t bhi[2], blo[2];
        split_tf32(p[0], bhi[0], blo[0]);           // (k = t, n = g)
        split_tf32(p[4 * W_LD], bhi[1], blo[1]);    // (k = t + 4, n = g)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], ahi[mt], alo[mt], bhi, blo);
      }
    }
    __syncthreads();
  }
}

// Attention of one group of HEADS_PER_BLOCK heads over one window: q, k and v of the group's
// GROUP columns staged in shared memory ([ROWS][QKV_LD] each, head hh at columns hh*24 ..
// +23), the window's mask rows mask_w [64, 64]. Warp w takes head w/2 of the group and query
// rows 32*(w%2) .. +31, one m16 tile at a time; fragment rows are g and g + 8 of the tile, S
// columns (keys) 8j + 2t and 8j + 2t + 1. store(row, col, v0, v1) takes the outputs of the
// neighbouring group columns col, col + 1 of a row. Reads shared memory only after the
// caller's __syncthreads.
template <class Store>
__device__ __forceinline__ void attend_group(const float* q_s, const float* k_s, const float* v_s,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ mask_w, int group,
                                             float scale, Store&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = warp / 2;
  const int h = group * HEADS_PER_BLOCK + hh;
  q_s += hh * HD;
  k_s += hh * HD;
  v_s += hh * HD;
  const float* bias_h = bias + (long long)h * ROWS * ROWS;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * (warp % 2) + 16 * mt;
    float s[ROWS / 8][4] = {};  // S[r0 .. r0+15, keys 8j .. 8j+7]
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      uint32_t ahi[4], alo[4];
      const float* p = q_s + (r0 + g) * QKV_LD + 8 * ks + t;
      split_tf32(p[0], ahi[0], alo[0]);
      split_tf32(p[8 * QKV_LD], ahi[1], alo[1]);
      split_tf32(p[4], ahi[2], alo[2]);
      split_tf32(p[8 * QKV_LD + 4], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        const float* pk = k_s + (8 * j + g) * QKV_LD + 8 * ks + t;  // B[d][key] = k[key][d]
        uint32_t bhi[2], blo[2];
        split_tf32(pk[0], bhi[0], blo[0]);
        split_tf32(pk[4], bhi[1], blo[1]);
        mma_3xtf32(s[j], ahi, alo, bhi, blo);
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
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        s[j][2 * half] /= row_sum[half];
        s[j][2 * half + 1] /= row_sum[half];
      }
    }
    // O = P v. The k-step j takes keys 8j + 2t (k index t) and 8j + 2t + 1 (k index t + 4),
    // so the A fragment is the S fragment itself and B reads v rows in that order.
    float o[HD / 8][4] = {};
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
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
        mma_3xtf32(o[n], ahi, alo, bhi, blo);
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

constexpr int CORE_RING = ring_floats<GROUP, CORE_KT, true>();
constexpr int CORE_SMEM_FLOATS = 2 * ROWS + 3 * ROWS * QKV_LD + CORE_RING;

// attn[w*64 + r, h*24 + d] for the window w = blockIdx.x and heads 4*blockIdx.y .. +3.
// x [bw*64, c]; wqkv [c, 3c]; bqkv [3c]; bias [heads, 64, 64]; mask [mask_count, 64, 64].
__global__ void __launch_bounds__(THREADS)
window_attention_core_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                             const float* __restrict__ bqkv, const float* __restrict__ bias,
                             const float* __restrict__ mask, int mask_count,
                             const float* __restrict__ g1, const float* __restrict__ b1,
                             float* __restrict__ attn, int c, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* mean_s = smem;
  float* rstd_s = mean_s + ROWS;
  float* qkv_s = rstd_s + ROWS;  // q, k, v of this block's heads: [3][ROWS][QKV_LD]
  float* ring = qkv_s + 3 * ROWS * QKV_LD;

  const long long win = blockIdx.x;
  const float* xw = x + win * ROWS * c;
  const int group = blockIdx.y;
  row_stats<THREADS / 32>(xw, c, c, mean_s, rstd_s);
  __syncthreads();

  for (int part = 0; part < 3; ++part) {  // q, k, v
    const int col0 = part * c + group * GROUP;
    float acc[2][Tiling<GROUP, THREADS / 32>::N_TILES][4] = {};
    block_mma<GROUP, CORE_KT, THREADS / 32, true, true>(xw, c, c, wqkv, 3 * c, col0, ring, mean_s,
                                                        rstd_s, g1, b1, acc);
    float* dst = qkv_s + part * ROWS * QKV_LD;
    for_each_pair<GROUP, THREADS / 32>(acc, [&](int r, int col, float v0, float v1) {
      dst[r * QKV_LD + col] = v0 + bqkv[col0 + col];
      dst[r * QKV_LD + col + 1] = v1 + bqkv[col0 + col + 1];
    });
  }
  __syncthreads();

  attend_group(qkv_s, qkv_s + ROWS * QKV_LD, qkv_s + 2 * ROWS * QKV_LD, bias,
               mask + (win % mask_count) * ROWS * ROWS, group, scale,
               [&](int r, int col, float v0, float v1) {
                 *reinterpret_cast<float2*>(attn + (win * ROWS + r) * c + group * GROUP + col) =
                     make_float2(v0, v1);
               });
}

template <int C>
constexpr int mlp_smem_floats() {
  return 2 * ROWS + ROWS * (C + 4) + ROWS * H_LD +
         cmax(ring_floats<C, WIDE_KT, true>(),
              cmax(ring_floats<HIDDEN_CHUNK, FC1_KT, false>(), ring_floats<C, WIDE_KT, false>()));
}

// The rest of the block for the window blockIdx.x: out = x2 + fc2(GELU(fc1(LN2(x2)))) with
// x2 = x + attn @ wproj + bproj. attn, x, out [bw*64, C]; wfc1 [C, 4C]; wfc2 [4C, C].
template <int C, int MLP_WARPS = mlp_warps<C>()>
__global__ void __launch_bounds__(32 * MLP_WARPS, 1)
swin_mlp_kernel(const float* __restrict__ attn, const float* __restrict__ x,
                const float* __restrict__ wproj, const float* __restrict__ bproj,
                const float* __restrict__ g2, const float* __restrict__ b2,
                const float* __restrict__ wfc1, const float* __restrict__ bfc1,
                const float* __restrict__ wfc2, const float* __restrict__ bfc2,
                float* __restrict__ out) {
  constexpr int XN_LD = C + 4;
  extern __shared__ __align__(16) float smem[];
  float* mean_s = smem;
  float* rstd_s = mean_s + ROWS;
  float* xn_s = rstd_s + ROWS;          // [ROWS][XN_LD]: x2, then LN2(x2)
  float* h_s = xn_s + ROWS * XN_LD;     // [ROWS][H_LD]: one hidden chunk after GELU
  float* ring = h_s + ROWS * H_LD;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const float* xw = x + row0 * C;

  constexpr int NTHREADS = 32 * MLP_WARPS;
  // x2 = x + (attn @ wproj + bproj), held in acc (and copied to xn_s for LN2).
  float acc[2][Tiling<C, MLP_WARPS>::N_TILES][4] = {};
  block_mma<C, WIDE_KT, MLP_WARPS, true, false>(attn + row0 * C, C, C, wproj, C, 0, ring, nullptr,
                                                nullptr, nullptr, nullptr, acc);
  for_each_pair<C, MLP_WARPS>(acc, [&](int r, int col, float& v0, float& v1) {
    const float2 xr = *reinterpret_cast<const float2*>(xw + r * C + col);
    v0 = xr.x + (v0 + bproj[col]);
    v1 = xr.y + (v1 + bproj[col + 1]);
    xn_s[r * XN_LD + col] = v0;
    xn_s[r * XN_LD + col + 1] = v1;
  });
  __syncthreads();
  row_stats<MLP_WARPS>(xn_s, XN_LD, C, mean_s, rstd_s);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * C; i += NTHREADS) {
    const int r = i / C, col = i % C;
    float* v = xn_s + r * XN_LD + col;
    *v = (*v - mean_s[r]) * rstd_s[r] * g2[col] + b2[col];
  }
  // The fc2 accumulator starts as x2 + b_fc2: the residual needs no second copy of x2.
  for_each_pair<C, MLP_WARPS>(acc, [&](int, int col, float& v0, float& v1) {
    v0 += bfc2[col];
    v1 += bfc2[col + 1];
  });
  __syncthreads();

  for (int j0 = 0; j0 < 4 * C; j0 += HIDDEN_CHUNK) {
    float hacc[2][Tiling<HIDDEN_CHUNK, MLP_WARPS>::N_TILES][4] = {};
    block_mma<HIDDEN_CHUNK, FC1_KT, MLP_WARPS, false, false>(xn_s, XN_LD, C, wfc1, 4 * C, j0, ring,
                                                             nullptr, nullptr, nullptr, nullptr,
                                                             hacc);
    for_each_pair<HIDDEN_CHUNK, MLP_WARPS>(hacc, [&](int r, int col, float v0, float v1) {
      h_s[r * H_LD + col] = gelu(v0 + bfc1[j0 + col]);
      h_s[r * H_LD + col + 1] = gelu(v1 + bfc1[j0 + col + 1]);
    });
    __syncthreads();
    block_mma<C, WIDE_KT, MLP_WARPS, false, false>(h_s, H_LD, HIDDEN_CHUNK,
                                                   wfc2 + (long long)j0 * C, C, 0, ring, nullptr,
                                                   nullptr, nullptr, nullptr, acc);
  }
  for_each_pair<C, MLP_WARPS>(acc, [&](int r, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(out + (row0 + r) * C + col) = make_float2(v0, v1);
  });
}

// ---- window_attention_fused: the attention half as token-tile GEMMs over all windows ----
//
// The products of the attention half, qkv [M, C] @ [C, 3C] and proj [M, C] @ [C, C] over all
// M = BW * 64 tokens, take 96 % of its work at stage 4, and their weights are the same for
// every window. So they run as two GEMMs over token tiles, and only the attention itself runs
// per (window, 4 heads).

// LN1 of each row of x [m, c] into a [m, c], one warp per row (the LayerNorm of row_stats and
// block_mma, in the same order): the statistics are taken once per token.
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ g1,
               const float* __restrict__ b1, float* __restrict__ a, int m, int c) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const float* p = x + (long long)row * c;
  float s = 0.0f;
  for (int i = lane; i < c; i += 32) s += p[i];
  const float mean = warp_sum(s) / c;
  float v = 0.0f;
  for (int i = lane; i < c; i += 32) {
    const float d = p[i] - mean;
    v = fmaf(d, d, v);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / c + LN_EPS);
  for (int i = lane; i < c; i += 32) {
    a[(long long)row * c + i] = (p[i] - mean) * rstd * g1[i] + b1[i];
  }
}

// split_tf32 with lo rounded by the same two integer operations as hi (the bits of cvt.rna for
// every finite value): the GEMM splits every fragment it loads, and the conversion instruction
// issues at a quarter of the integer rate.
__device__ __forceinline__ void split_tf32_int(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// cp.async of 16 bytes that writes zeros where !valid (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// Four 8 x 4 tiles of 32-bit values from shared memory: lane l gives the address of row l % 8
// of tile l / 8, and gets element (l / 4, l % 4) of each tile (ldmatrix on b16 pairs).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

constexpr int GEMM_KT = 32;              // depth of a staged slab
constexpr int GEMM_A_LD = GEMM_KT + 4;   // padded A rows: conflict-free ldmatrix
constexpr int GEMM_STAGES = 4;           // cp.async ring

// A [BM, BN] output tile over 8 warps in 2 rows by 4 columns, each warp MT m16 by NT n8 tiles.
template <int BM, int BN>
struct GemmTile {
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "whole m16 and n8 tiles");
  static constexpr int B_LD = BN + 8;  // 8 mod 32 floats: conflict-free B fragments
  static constexpr int STAGE_FLOATS = BM * GEMM_A_LD + GEMM_KT * B_LD;
  static constexpr int SMEM_BYTES = GEMM_STAGES * STAGE_FLOATS * (int)sizeof(float);
};

// out[r, j] = (a @ w)[r, j] + bias[j] (+ residual[r, j]) for r < m, j < n, in 3xTF32: a [m, k]
// and w [k, n] row-major float32, as the caller has them. Block (blockIdx.x, blockIdx.y) takes
// output columns BN * blockIdx.x and rows BM * blockIdx.y; slabs of KT = 32 stream through a
// four-stage cp.async ring (rows past m and columns past n read as zero and are not written).
// Each warp loads an A fragment with one ldmatrix, B fragments with 32-bit loads, and splits
// them in registers (split_tf32_int); each split A fragment feeds NT and each B fragment MT
// m16n8k8 tiles, three products each. The products of a slab (4 k-steps, 12 mma.sync a tile)
// go into a fresh fragment that a float32 add folds into the accumulator once a slab: the
// tensor core's truncating accumulation then stays relative to a 32-deep partial sum, and
// the fold and its registers cost a quarter of a fold per k-step (mma_3xtf32 says why).
// k % 32 == 0, n % 8 == 0, pointers 16-byte aligned.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_3xtf32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ residual,
                   float* __restrict__ out, int m, int n, int k) {
  using T = GemmTile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;

  auto load = [&](int slab, int stage) {
    float* as = smem + stage * T::STAGE_FLOATS;
    float* bs = as + BM * GEMM_A_LD;
    const int k0 = slab * GEMM_KT;
    for (int i = threadIdx.x; i < BM * (GEMM_KT / 4); i += THREADS) {
      const int r = i / (GEMM_KT / 4), c = 4 * (i % (GEMM_KT / 4));
      const bool valid = m0 + r < m;
      cp_async16_zfill(as + r * GEMM_A_LD + c, a + (long long)(valid ? m0 + r : 0) * k + k0 + c,
                       valid);
    }
    for (int i = threadIdx.x; i < GEMM_KT * (BN / 4); i += THREADS) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const bool valid = n0 + c < n;
      cp_async16_zfill(bs + r * T::B_LD + c, w + (long long)(k0 + r) * n + (valid ? n0 + c : 0),
                       valid);
    }
  };

  float acc[T::MT][T::NT][4] = {};
  // ldmatrix rows of an m16 tile's A: tiles (rows 0-7 | 8-15) x (k 0-3 | 4-7) give a0..a3.
  const int a_row = wm * T::WM + lane % 8 + 8 * ((lane / 8) % 2), a_col = 4 * (lane / 16);
  const int b_col = wn * T::WN + g;
  const int slabs = k / GEMM_KT;
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < slabs) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // slab s is in; every warp is done with the stage the next load takes
    if (s + GEMM_STAGES - 1 < slabs) load(s + GEMM_STAGES - 1, (s + GEMM_STAGES - 1) % GEMM_STAGES);
    cp_async_commit();
    const float* as = smem + (s % GEMM_STAGES) * T::STAGE_FLOATS;
    const float* bs = as + BM * GEMM_A_LD;
    float part[T::MT][T::NT][4] = {};  // this slab's products
#pragma unroll
    for (int kk = 0; kk < GEMM_KT; kk += 8) {
      uint32_t bh[T::NT][2], bl[T::NT][2];
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const float* p = bs + (kk + t) * T::B_LD + b_col + 8 * nt;
        split_tf32_int(p[0], bh[nt][0], bl[nt][0]);               // (k = t, n = g)
        split_tf32_int(p[4 * T::B_LD], bh[nt][1], bl[nt][1]);     // (k = t + 4, n = g)
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        uint32_t f[4], ah[4], al[4];
        ldsm_x4(f, as + (a_row + 16 * mt) * GEMM_A_LD + kk + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_int(__uint_as_float(f[e]), ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * T::WM + 16 * mt + g + 8 * h;
        const int col = n0 + wn * T::WN + 8 * nt + 2 * t;
        if (row < m && col < n) {
          const long long o = (long long)row * n + col;
          float v0 = acc[mt][nt][2 * h] + bias[col], v1 = acc[mt][nt][2 * h + 1] + bias[col + 1];
          if (residual != nullptr) {
            const float2 r = *reinterpret_cast<const float2*>(residual + o);
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

constexpr int ATTN_SMEM_FLOATS = 3 * ROWS * QKV_LD;

// The attention of window blockIdx.x, heads 4*blockIdx.y .. +3, from qkv [bw*64, 3c] (q | k |
// v, b_qkv added), into attn [bw*64, c].
__global__ void __launch_bounds__(THREADS)
attention_from_qkv_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                          const float* __restrict__ mask, int mask_count,
                          float* __restrict__ attn, int c, float scale) {
  extern __shared__ __align__(16) float smem[];  // q, k, v of this block's heads: [3][ROWS][QKV_LD]
  const long long win = blockIdx.x;
  const int group = blockIdx.y;
  const float* src = qkv + win * ROWS * 3 * c + group * GROUP;
  for (int i = threadIdx.x; i < 3 * ROWS * (GROUP / 4); i += THREADS) {
    const int part = i / (ROWS * (GROUP / 4)), r = (i / (GROUP / 4)) % ROWS;
    const int col = 4 * (i % (GROUP / 4));
    cp_async16(smem + (part * ROWS + r) * QKV_LD + col,
               src + (long long)r * 3 * c + part * c + col);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* dst = attn + win * ROWS * c + group * GROUP;
  attend_group(smem, smem + ROWS * QKV_LD, smem + 2 * ROWS * QKV_LD, bias,
               mask + (win % mask_count) * ROWS * ROWS, group, scale,
               [=](int r, int col, float v0, float v1) {
                 *reinterpret_cast<float2*>(dst + r * c + col) = make_float2(v0, v1);
               });
}

template <class Kernel>
int set_smem(Kernel kernel, int floats) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   floats * (int)sizeof(float));
}

int check_args(int bw, int c, int heads, int mask_count) {
  if (bw <= 0 || heads <= 0 || heads % HEADS_PER_BLOCK || c != heads * HD || mask_count <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch_core(const float* x, const float* wqkv, const float* bqkv, const float* bias,
                const float* mask, int mask_count, const float* g1, const float* b1, float* attn,
                int bw, int c, int heads, cudaStream_t stream) {
  int err = set_smem(window_attention_core_kernel, CORE_SMEM_FLOATS);
  if (err) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  window_attention_core_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS,
                                 CORE_SMEM_FLOATS * sizeof(float), stream>>>(
      x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, c, scale);
  return (int)cudaGetLastError();
}

template <int C>
int launch_mlp(const float* attn, const float* x, const float* wproj, const float* bproj,
               const float* g2, const float* b2, const float* wfc1, const float* bfc1,
               const float* wfc2, const float* bfc2, float* out, int bw, cudaStream_t stream) {
  constexpr int floats = mlp_smem_floats<C>();
  int err = set_smem(swin_mlp_kernel<C>, floats);
  if (err) return err;
  swin_mlp_kernel<C><<<bw, 32 * mlp_warps<C>(), floats * sizeof(float), stream>>>(
      attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x + proj(attn(LN1(x))) into out [bw, 64, c], in four launches: LN1, the qkv GEMM with
// b_qkv, the attention, the proj GEMM with b_proj and the residual. Scratch: a [bw*64, c]
// (LN1(x), then attn) and qkv [bw*64, 3c]. Launches on `stream` and returns the first
// cudaError_t (0 = ok; cudaErrorInvalidValue for shapes the kernels do not take). Does not
// synchronise and allocates nothing.
int window_attention_launch(const float* x, const float* wqkv, const float* bqkv,
                            const float* wproj, const float* bproj, const float* bias,
                            const float* mask, int mask_count, const float* g1, const float* b1,
                            float* a, float* qkv, float* out, int bw, int c, int heads,
                            void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  if (bw > 65535) return (int)cudaErrorInvalidValue;  // the proj GEMM's row tiles on gridDim.y
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = bw * ROWS;

  ln_rows_kernel<<<(m + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(x, g1, b1, a, m, c);
  err = (int)cudaGetLastError();
  if (err) return err;

  using QkvTile = GemmTile<128, 128>;  // 576 blocks at stage 4, B = 64
  err = set_smem(gemm_3xtf32_kernel<128, 128>, QkvTile::SMEM_BYTES / (int)sizeof(float));
  if (err) return err;
  gemm_3xtf32_kernel<128, 128><<<dim3((3 * c + 127) / 128, (m + 127) / 128), THREADS,
                                 QkvTile::SMEM_BYTES, s>>>(a, wqkv, bqkv, nullptr, qkv, m, 3 * c,
                                                           c);
  err = (int)cudaGetLastError();
  if (err) return err;

  err = set_smem(attention_from_qkv_kernel, ATTN_SMEM_FLOATS);
  if (err) return err;
  attention_from_qkv_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS,
                              ATTN_SMEM_FLOATS * sizeof(float), s>>>(
      qkv, bias, mask, mask_count, a, c, 1.0f / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err) return err;

  using ProjTile = GemmTile<64, 128>;  // 384 blocks at stage 4: 2.9 waves of 132
  err = set_smem(gemm_3xtf32_kernel<64, 128>, ProjTile::SMEM_BYTES / (int)sizeof(float));
  if (err) return err;
  gemm_3xtf32_kernel<64, 128><<<dim3((c + 127) / 128, (m + 63) / 64), THREADS,
                                ProjTile::SMEM_BYTES, s>>>(a, wproj, bproj, x, out, m, c, c);
  return (int)cudaGetLastError();
}

// The whole block into out [bw, 64, c], c = 96, 192 or 384, in two launches; attn [bw*64, c]
// is scratch. Same conventions as window_attention_launch.
int swin_block_launch(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                      const float* bproj, const float* bias, const float* mask, int mask_count,
                      const float* g1, const float* b1, const float* g2, const float* b2,
                      const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                      float* attn, float* out, int bw, int c, int heads, void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  if (c != 96 && c != 192 && c != 384) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_core(x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, bw, c, heads, s);
  if (err) return err;
  switch (c) {
    case 96:
      return launch_mlp<96>(attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out, bw, s);
    case 192:
      return launch_mlp<192>(attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out, bw, s);
    default:
      return launch_mlp<384>(attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out, bw, s);
  }
}

}  // extern "C"
