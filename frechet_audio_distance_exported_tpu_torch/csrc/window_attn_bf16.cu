// CLAP's Swin window kernels for a bfloat16 model, hand-written CUDA C++ for Hopper (sm_90a).
//
// The bf16 instances of the two TPU kernels of frechet_audio_distance_exported_tpu/ops/
// pallas_window_attn.py, which compute in x.dtype:
// - window_attention_fused (L217; body _kernel L86 + _attention_half L35):
//     out = x + proj(attn(LN1(x)))
// - swin_block_fused (L152; body _block_kernel L114 + _attention_half):
//     x2 = x + proj(attn(LN1(x))),  out = x2 + fc2(GELU(fc1(LN2(x2))))
// over partitioned 8x8 windows, with the layout of csrc/window_attn.cu (the float32 instances):
// x [BW, 64, C], weights [in, out], the gathered bias [H, 64, 64], all bf16; the mask
// [mask_count, 64, 64] float32, window w using mask[w % mask_count]; head_dim 24.
//
// Arithmetic, as the Pallas kernels do it for a bf16 x: every product takes bf16 operands on
// the tensor cores with float32 sums; a bf16 operand is exact, so there is no hi/lo split.
// LayerNorm (two-pass), the softmax (from the row max) and GELU run in float32 SIMT; GELU's erf
// is the Pallas kernel's own (_erf_f32, Abramowitz-Stegun 7.1.26, within 1.5e-7 of erf).
// Values are rounded to bf16 (round to nearest even) exactly where _attention_half and
// _block_kernel round: LN1's output h; qkv after b_qkv; the probabilities p; each head's p v; the
// attention residual x2 = x + (attn @ w_proj + b_proj), whose rounded value LN2's moments are
// taken over; LN2's output; GELU's output; and the output x2 + (m @ w_fc2 + b_fc2). The
// accumulators start at zero and the biases and residuals are added after the products, in the
// Pallas kernels' order.
//
// What bounds it on the H100: the float32 instances' flops (24*M*C^2 + 4*M*64*C for the block,
// 8*M*C^2 + 4*M*64*C for the attention half, M = BW * 64 tokens) at the dense bf16 rate of
// 989 TFLOP/s, against x, out and the weights in bf16 at 3.35 TB/s: some 640 flops a byte at
// C = 96, beyond the 295 at which the rate binds, so both are bound by operations. Reaching that
// rate takes wgmma (warpgroup MMA) and weights that feed many rows: a weight value staged for one
// window's 64 rows gives 64 flops a byte of L2 traffic, which would need some 15 TB/s of L2.
// Beside the products, the block's SIMT work is large: 4C GELUs a token (two MUFU operations
// each), two LayerNorms and a softmax of 64 keys per head.
//
// How it is laid out (wgmma_bf16.cuh has the shared-memory layouts and the PTX):
// - Warp-specialised blocks of three warpgroups: a producer (40 registers a thread, setmaxnreg)
//   stages weight slabs by TMA into a ring of shared-memory slots tracked by mbarriers (full: the
//   slab has landed; empty: every consumer warp is done with it), and two consumer warpgroups (232
//   registers) each own 64 rows and run wgmma on every slab: each weight byte feeds 128 rows.
//   Products are m64nNk16 with A (the rows' activations) from shared memory or registers and B
//   (the weights, [in, out] as they lie: wgmma's transposed B) from the ring, float32
//   accumulators in registers, each zeroed just before its first product.
// - swin_block_fused, two launches of persistent blocks (one per SM at most), each walking
//   window pairs, one window a consumer. One producer thread has TMA stage the weight slabs in
//   swizzled boxes: [rows, 32] (64-byte rows) for w_qkv's 96-column head groups and at C = 96,
//   [rows, 64] (128-byte rows) where widths are multiples of 64; a block whose slabs fit the
//   ring at once (C = 96) loads them once. The threads write the A operands (LN1(x), attn,
//   LN2(x2)) in the no-swizzle core-matrix layout.
//   swin_attn_bf16_kernel<C>: x of the window (prefetched during the previous window's
//   attention) normalised in place by LN1, once, as wgmma's A operand; then per group of 4
//   heads (96 columns) q, k and v by m64n96 products over [48, 96] slabs of w_qkv, rounded with
//   b_qkv into shared memory (q and k row-major, v transposed); then the attention, a warp per
//   16 query rows and head, the window's mask rows held in registers for every head, to attn
//   [M, C] bf16 in device memory (2*M*C*2 bytes round trip: about 0.03 ms at stage 1).
//   swin_mlp_bf16_kernel<C>: attn (and below C = 384 x) in; x2 = round(x + attn @ w_proj +
//   b_proj), its LN2 into shared memory as fc1's A; then per hidden chunk of NC columns (96 at
//   C = 96, else 64) m = round(GELU(LN2(x2) @ W1[:, chunk] + b1)) in registers, packed to bf16
//   pairs as the A operand of acc += m @ W2[chunk, :] (the hidden layer never touches shared
//   memory), fc2 of one chunk and fc1 of the next back to back on the tensor cores; out =
//   round(x2 + acc + b_fc2). The [64, C] fc2 accumulator is C/2 registers a thread: at C = 384
//   that leaves too few beside it, so the output columns go in two passes of 192 (96 registers),
//   fc1 and GELU once a pass.
// - The attention stays on mma.sync (m16n8k16, and one m16n8k8 for the last 8 of head_dim 24 in
//   q k^T): 24 is not a multiple of wgmma's k16, it is 4*M*64*C of the flops (10 % at C = 96,
//   2.7 % at C = 384), and its fragments stay simple: q and k row-major and v transposed so
//   that every fragment is one 32-bit shared load, P taken from the S accumulator.
// - window_attention_fused (CLAP stage 4, C = 768), four launches: LN1(x) to device memory; the
//   qkv and proj GEMMs as gemm_bf16_kernel, [128, 192] output tiles over a four-slot ring that
//   TMA fills (one producer thread; 128-byte swizzled slabs of A's rows and w's columns, 64
//   deep), with b_qkv, or b_proj and the residual (staged by TMA too), in the epilogue and the
//   tile stored by TMA; the attention per (window, 4 heads) from qkv between them. The tensor
//   maps are encoded per launch by cuTensorMapEncodeTiled, reached from the CUDA runtime: the
//   library links no libcuda.
//
// The wrapper (ops/window_attn.py) checks shapes, types (bf16 operands with a float32 mask),
// devices, contiguity and 16-byte alignment, and allocates the output and the scratch; a bf16
// CUDA tensor reaches these kernels or the wrapper raises, and there is no fallback to the
// plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using hopper::core_index;

constexpr int THREADS = 256;          // ln_rows_bf16_kernel and the stage-4 attention
constexpr int ROWS = 64;              // tokens of an 8x8 window: one wgmma M tile
constexpr int HD = 24;                // head_dim
constexpr int GROUP = 96;             // columns of 4 heads: the attention's tile width
constexpr int HEADS_PER_BLOCK = GROUP / HD;
constexpr int PAD = 8;                // values of row padding: 16 bytes
constexpr int QK_LD = GROUP + PAD;    // q and k of a group's heads, [64][104]
constexpr int VT_LD = ROWS + PAD;     // v transposed, [96][72]
constexpr float LN_EPS = 1e-5f;

// The warp-specialised kernels: CONSUMERS warpgroups of 64 rows each, then a producer warpgroup
// (one of its threads issues the TMA copies; setmaxnreg takes whole warpgroups).
constexpr int CONSUMERS = 2;
constexpr int WS_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 2 * 128 * 232 + 128 * 40 = 384 * 168, the launch's
constexpr int SMEM_LIMIT = 232448;    // bytes of shared memory a block may take
constexpr int BARRIER_BYTES = 1024;   // the ring's mbarriers, ahead of the buffers

constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half: one mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a @ b for one m16n8k16 bf16 tile (a row-major 16 x 16, b column-major 16 x 8), float32 sums.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a @ b for one m16n8k8 bf16 tile: the last 8 of head_dim 24 in q k^T.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// GELU with the Pallas kernel's erf (_erf_f32: Abramowitz-Stegun 7.1.26, within 1.5e-7 of
// erf), a third of erff's instructions: the MLP's SIMT work is 4C GELUs a token.
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

// Two-pass LayerNorm of row r of a [*, c] bf16 matrix (stride ld) by one warp, into dst (bf16,
// rounded once): float32 moments and normalisation, (v - mean) * rstd * g + b.
__device__ __forceinline__ void ln_row(const bf16* p, int c, const bf16* __restrict__ g,
                                       const bf16* __restrict__ b, bf16* dst) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = to_f2(p + i);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / c;
  float var = 0.0f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = to_f2(p + i);
    const float d0 = v.x - mean, d1 = v.y - mean;
    var = fmaf(d0, d0, var);
    var = fmaf(d1, d1, var);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(var) / c + LN_EPS);
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = to_f2(p + i);
    const float2 gg = to_f2(g + i), bb = to_f2(b + i);
    *reinterpret_cast<uint32_t*>(dst + i) =
        pack_bf16((v.x - mean) * rstd * gg.x + bb.x, (v.y - mean) * rstd * gg.y + bb.y);
  }
}

// LayerNorm of a window's 64 rows: src holds them [64, C] in the core-matrix layout, dst (src
// itself, or another tile) gets LN(rows), rounded once: wgmma's A operand. Warp `warp` of the
// warpgroup takes rows 16 warp .. +15, 8 at a time: lane l holds row l % 8's 16-byte chunks
// l / 8, l / 8 + 4, ..., so a row's sums take two shuffles, and each load and store covers
// whole core rows: a warp's 512 contiguous bytes. A thread writes only where it read.
template <int C>
__device__ __forceinline__ void ln_window(const bf16* src, bf16* dst, const bf16* __restrict__ g,
                                          const bf16* __restrict__ b, int warp, int lane) {
  constexpr int CHUNKS = C / 32;  // 16-byte chunks of a row per lane
#pragma unroll(C == 96 ? 2 : 1)
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * warp + 8 * half + lane % 8;
    uint4 v[CHUNKS];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      v[i] = *reinterpret_cast<const uint4*>(src + core_index<C>(r, 8 * (lane / 8 + 4 * i)));
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = to_f2(w[e]);
        s += f.x + f.y;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    const float mean = s * (1.0f / C);
    float var = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = to_f2(w[e]);
        var = fmaf(f.x - mean, f.x - mean, var);
        var = fmaf(f.y - mean, f.y - mean, var);
      }
    }
    var += __shfl_xor_sync(0xffffffffu, var, 8);
    var += __shfl_xor_sync(0xffffffffu, var, 16);
    const float rstd = 1.0f / sqrtf(var * (1.0f / C) + LN_EPS);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int col = 8 * (lane / 8 + 4 * i);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + col);
      const uint4 bv = *reinterpret_cast<const uint4*>(b + col);
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = to_f2(w[e]), gg = to_f2(gw[e]), bb = to_f2(bw[e]);
        o[e] = pack_bf16((f.x - mean) * rstd * gg.x + bb.x, (f.y - mean) * rstd * gg.y + bb.y);
      }
      *reinterpret_cast<uint4*>(dst + core_index<C>(r, col)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Softmax attention of one head over query rows r0 .. r0 + 15 by one warp: q and k of the
// head row-major in shared memory (stride QK_LD), v transposed (stride VT_LD), the head's bias
// rows bias_h [64, 64] bf16. Fragment rows are g and g + 8 of the tile, S columns (keys) 8j + 2t
// and 8j + 2t + 1; mask(j, half) gives the mask's float2 at row r0 + g + 8 half, keys 8j + 2t
// and 8j + 2t + 1. store(row, col, packed) takes the rounded outputs of the neighbouring head
// columns col, col + 1 of a row as one bf16 pair.
template <class Mask, class Store>
__device__ __forceinline__ void attend_tile(const bf16* q, const bf16* k, const bf16* vt,
                                            const bf16* __restrict__ bias_h, int r0,
                                            float scale, Mask&& mask, Store&& store) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qa = q + 2 * t + (r0 + g) * QK_LD;
  const bf16* qb = qa + 8 * QK_LD;
  const uint32_t a16[4] = {ld32(qa), ld32(qb), ld32(qa + 8), ld32(qb + 8)};  // d 0-15
  const uint32_t a8[2] = {ld32(qa + 16), ld32(qb + 16)};                      // d 16-23
  float s[ROWS / 8][4] = {};  // S[r0 .. r0+15, keys 8j .. 8j+7]
#pragma unroll
  for (int j = 0; j < ROWS / 8; ++j) {
    const bf16* kr = k + 2 * t + (8 * j + g) * QK_LD;  // B[d][key] = k[key][d]
    const uint32_t b16[2] = {ld32(kr), ld32(kr + 8)};
    mma_k16(s[j], a16, b16);
    mma_k8(s[j], a8, ld32(kr + 16));
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float row_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      const float2 bb = to_f2(bias_h + (r0 + g + 8 * half) * ROWS + 8 * j + 2 * t);
      const float2 mm = mask(j, half);
      s[j][2 * half] = s[j][2 * half] * scale + bb.x + mm.x;
      s[j][2 * half + 1] = s[j][2 * half + 1] * scale + bb.y + mm.y;
      row_max = fmaxf(row_max, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][2 * half + e] = __expf(s[j][2 * half + e] - row_max);
        row_sum += s[j][2 * half + e];
      }
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float inv = 1.0f / row_sum;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      s[j][2 * half] *= inv;
      s[j][2 * half + 1] *= inv;
    }
  }
  // O = P v over four k16 steps of keys 16i .. 16i+15: the A fragment is S tiles 2i and 2i+1
  // rounded to bf16 (the Pallas kernel's p), B reads v^T rows, one 32-bit load a register.
  float o[HD / 8][4] = {};
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const uint32_t pa[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                            pack_bf16(s[2 * i][2], s[2 * i][3]),
                            pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                            pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const bf16* vr = vt + (8 * n + g) * VT_LD + 2 * t + 16 * i;
      const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
      mma_k16(o[n], pa, b);
    }
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      store(r0 + g + 8 * half, 8 * n + 2 * t, pack_bf16(o[n][2 * half], o[n][2 * half + 1]));
    }
  }
}

// Attention of one group of HEADS_PER_BLOCK heads over one window by the block's 8 warps: q
// and k of the group's GROUP columns row-major in shared memory ([ROWS][QK_LD], head hh at
// columns hh*24 .. +23), v transposed ([GROUP][VT_LD]), bias [heads, 64, 64] bf16, the window's
// mask rows mask_w [64, 64] float32. Warp w takes head w / 2 and query rows 32 (w % 2) .. +31;
// store(row, col, packed) takes group columns. Reads shared memory only after the caller's
// barrier.
template <class Store>
__device__ __forceinline__ void attend_group(const bf16* q_s, const bf16* k_s, const bf16* vt_s,
                                             const bf16* __restrict__ bias,
                                             const float* __restrict__ mask_w, int group,
                                             float scale, Store&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = warp / 2;
  const bf16* bias_h = bias + (long long)(group * HEADS_PER_BLOCK + hh) * ROWS * ROWS;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * (warp % 2) + 16 * mt;
    attend_tile(
        q_s + hh * HD, k_s + hh * HD, vt_s + hh * HD * VT_LD, bias_h, r0, scale,
        [&](int j, int half) {
          return *reinterpret_cast<const float2*>(mask_w + (r0 + g + 8 * half) * ROWS + 8 * j +
                                                  2 * t);
        },
        [&](int r, int col, uint32_t v) { store(r, hh * HD + col, v); });
  }
}

// The same for a warpgroup's 4 warps: warp `warp` takes query rows 16 warp .. +15 of the group's
// heads, one at a time, with the window's mask values at those rows in registers
// (mask_r[j][2 half + e]: row 16 warp + g + 8 half, key 8j + 2t + e), loaded once a window: the
// mask is every head's.
template <class Store>
__device__ __forceinline__ void attend_rows(const bf16* q_s, const bf16* k_s, const bf16* vt_s,
                                            const bf16* __restrict__ bias,
                                            const float (&mask_r)[ROWS / 8][4], int group,
                                            float scale, int warp, Store&& store) {
#pragma unroll 1
  for (int hh = 0; hh < HEADS_PER_BLOCK; ++hh) {
    attend_tile(
        q_s + hh * HD, k_s + hh * HD, vt_s + hh * HD * VT_LD,
        bias + (long long)(group * HEADS_PER_BLOCK + hh) * ROWS * ROWS, 16 * warp, scale,
        [&](int j, int half) { return make_float2(mask_r[j][2 * half], mask_r[j][2 * half + 1]); },
        [&](int r, int col, uint32_t v) { store(r, hh * HD + col, v); });
  }
}

// ---- the slab ring of the warp-specialised kernels ----
//
// STAGES slots, a "full" and an "empty" mbarrier each, ahead of the buffers in shared memory.
// Slab t of a block's life goes to slot t % STAGES, its u = t / STAGES-th use of the slot: the
// producer waits for the slot's empty barrier to complete phase u - 1 (the first use passes at
// once), copies, and has the slot's full barrier count its threads' arrivals as their copies
// land; the consumers wait for the full barrier's phase u, and each consumer warp arrives on the
// empty barrier when its warpgroup's products on the slab are done. RESIDENT: the block's
// slabs fit the ring at once, so they are loaded once and never released.

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

// full: the producer thread's arrival with the slab's TMA byte count.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * CONSUMERS);  // a consumer warp's lane 0 each
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// A consumer warpgroup's side of the ring: acquire() waits for the next slab in the producer's
// order and returns its slot, visible to wgmma; release(slot) once this warpgroup's products on
// the slab are done (a wgmma wait), in any order.
template <int STAGES, bool RESIDENT>
struct Consumer {
  uint64_t* full;
  uint64_t* empty;
  const bf16* ring;
  int slab_values;
  RingPos pos;

  __device__ __forceinline__ int acquire() {
    const int slot = pos.slot;
    hopper::mbar_wait(full + slot, RESIDENT ? 0 : pos.parity);
    hopper::fence_proxy_async();
    pos.next(STAGES);
    return slot;
  }
  __device__ __forceinline__ const bf16* slab(int slot) const {
    return ring + slot * slab_values;
  }
  __device__ __forceinline__ void release(int slot) const {
    // After a wgmma wait, which the whole warp has passed: one arrival for the warp.
    if (!RESIDENT && threadIdx.x % 32 == 0) hopper::mbar_arrive(empty + slot);
  }
};

// Zeroes an accumulator just before its first product: the products read their accumulator, so
// this ends the registers' earlier live range.
template <int P, int R>
__device__ __forceinline__ void zero(float (&d)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < R; ++i) d[p][i] = 0.0f;
  }
}

template <int P, int R>
__device__ __forceinline__ void fence_regs(float (&d)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) hopper::fence_regs(d[p]);
}

// ---- swin_block_fused, launch 1: LN1, qkv and the attention ----

template <int C>
struct BlockAttn {
  static constexpr int KS = 48;                        // rows of w_qkv in a slab
  static constexpr int SLAB = KS * GROUP;              // values of a slab: [48, 96]
  static constexpr int GROUPS = C / GROUP;
  static constexpr int DEPTH = C / KS;                 // slabs of one q, k or v product
  static constexpr int SLABS = GROUPS * 3 * DEPTH;     // a window pair's
  // a window's h [64, C] (core layout), q and k [64][104], v^T [96][72]
  static constexpr int WIN = ROWS * C + 2 * ROWS * QK_LD + GROUP * VT_LD;
  // the barriers, the ring from a 1024-byte boundary, the windows' buffers and b_qkv
  static constexpr int FIXED = 2 * BARRIER_BYTES + (CONSUMERS * WIN + 3 * C) * 2;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (SLAB * 2);
  static constexpr int STAGES = cmin(SLABS, FIT);
  static constexpr bool RESIDENT = STAGES == SLABS;
  static constexpr int SMEM = FIXED + STAGES * SLAB * 2;
  static_assert(FIT >= 2 && C % KS == 0 && KS % 16 == 0, "a ring of at least two slots");
};

// attn[w*64 + r, h*24 + d] for every window w (x [bw*64, C]; wqkv [C, 3C]; bqkv [3C]; bias
// [heads, 64, 64]; mask [mask_count, 64, 64]). Block b takes window pairs b, b + gridDim.x, ...;
// consumer warpgroup i the pair's window 2 p + i (a warpgroup past bw computes on the last window
// and writes nothing).
template <int C>
__global__ void __launch_bounds__(WS_THREADS, 1)
swin_attn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                      const bf16* __restrict__ bqkv, const bf16* __restrict__ bias,
                      const float* __restrict__ mask, int mask_count,
                      const bf16* __restrict__ g1, const bf16* __restrict__ b1,
                      bf16* __restrict__ attn, int bw, float scale,
                      const __grid_constant__ CUtensorMap tqkv) {
  using K = BlockAttn<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + K::STAGES;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((raw + 2 * BARRIER_BYTES - 1) / 1024 * 1024 - raw));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int pairs = (bw + CONSUMERS - 1) / CONSUMERS;
  const int block = blockIdx.x, blocks = gridDim.x;
  const int rounds = block < pairs ? (pairs - 1 - block) / blocks + 1 : 0;
  ring_init(full, empty, K::STAGES);

  if (wg == CONSUMERS) {
    hopper::regs_dec<PRODUCER_REGS>();
    // One thread has TMA stage each slab, [KS, 96] of w_qkv as three 64-byte swizzled boxes of
    // [KS, 32]: a round's slabs are each group's q, k and v in turn, KS rows at a time.
    auto load = [&](int slab, bf16* dst, uint64_t* bar) {
      const int depth = slab % K::DEPTH, part = slab / K::DEPTH % 3;
      const int group = slab / (3 * K::DEPTH);
      hopper::mbar_arrive_expect_tx(bar, K::SLAB * 2);
#pragma unroll
      for (int b = 0; b < GROUP / 32; ++b) {
        hopper::tma_load_2d(dst + b * 32 * K::KS, &tqkv, part * C + group * GROUP + 32 * b,
                            depth * K::KS, bar);
      }
    };
    if (t == 0 && K::RESIDENT && rounds > 0) {
      for (int slab = 0; slab < K::SLABS; ++slab) load(slab, ring + slab * K::SLAB, full + slab);
    } else if (t == 0 && !K::RESIDENT) {
      RingPos pos;
      for (int r = 0; r < rounds; ++r) {
        for (int slab = 0; slab < K::SLABS; ++slab) {
          hopper::mbar_wait(empty + pos.slot, pos.parity ^ 1);
          load(slab, ring + pos.slot * K::SLAB, full + pos.slot);
          pos.next(K::STAGES);
        }
      }
    }
  } else {
    hopper::regs_inc<CONSUMER_REGS>();
    const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    bf16* h_s = ring + K::STAGES * K::SLAB + wg * K::WIN;  // x, then LN1(x)
    bf16* q_s = h_s + ROWS * C;
    bf16* k_s = q_s + ROWS * QK_LD;
    bf16* vt_s = k_s + ROWS * QK_LD;
    bf16* p_bqkv = ring + K::STAGES * K::SLAB + CONSUMERS * K::WIN;
    for (int i = threadIdx.x; i < 3 * C / 8; i += 128 * CONSUMERS) {
      *reinterpret_cast<uint4*>(p_bqkv + 8 * i) = *reinterpret_cast<const uint4*>(bqkv + 8 * i);
    }
    hopper::named_barrier(1 + CONSUMERS, 128 * CONSUMERS);
    Consumer<K::STAGES, K::RESIDENT> in{full, empty, ring, K::SLAB};
    auto window = [&](int pair) {
      const int w = pair * CONSUMERS + wg;
      return (long long)(w < bw ? w : bw - 1);
    };
    if (block < pairs) {
      hopper::copy_cores<ROWS, C, 128>(h_s, x + window(block) * ROWS * C, C, t);
      hopper::cp_async_commit();
    }
    for (int pair = block; pair < pairs; pair += blocks) {
      const bool valid = pair * CONSUMERS + wg < bw;
      const long long win = window(pair);
      float mask_r[ROWS / 8][4];
      const float* mask_w = mask + (win % mask_count) * ROWS * ROWS;
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 v = *reinterpret_cast<const float2*>(
              mask_w + (16 * warp + g + 8 * half) * ROWS + 8 * j + 2 * q);
          mask_r[j][2 * half] = v.x;
          mask_r[j][2 * half + 1] = v.y;
        }
      }
      hopper::cp_async_wait<0>();  // this window's x tile (issued a window ahead)
      hopper::named_barrier(1 + wg, 128);
      ln_window<C>(h_s, h_s, g1, b1, warp, lane);
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + wg, 128);
#pragma unroll 1
      for (int group = 0; group < K::GROUPS; ++group) {
#pragma unroll 1
        for (int part = 0; part < 3; ++part) {  // q, k, v
          float acc[1][GROUP / 2];
          zero(acc);
          int previous = -1;
#pragma unroll 1
          for (int depth = 0; depth < K::DEPTH; ++depth) {
            const int slot = in.acquire();
            fence_regs(acc);
            hopper::fence();
#pragma unroll
            for (int s = 0; s < K::KS / 16; ++s) {
              hopper::mma_ss<GROUP>(acc[0], hopper::desc_a<C>(h_s, depth * (K::KS / 16) + s),
                                    hopper::desc_b_sw64(in.slab(slot), s, K::KS * 64));
            }
            hopper::commit();
            hopper::wait<1>();  // the previous slab's products are done
            if (previous >= 0) in.release(previous);
            previous = slot;
          }
          hopper::wait<0>();
          fence_regs(acc);
          in.release(previous);
          const int col0 = part * C + group * GROUP;
#pragma unroll
          for (int j = 0; j < GROUP / 8; ++j) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = 16 * warp + g + 8 * hr, col = 8 * j + 2 * q;
              const float2 bb = to_f2(p_bqkv + col0 + col);
              const __nv_bfloat162 v = __floats2bfloat162_rn(acc[0][4 * j + 2 * hr] + bb.x,
                                                             acc[0][4 * j + 2 * hr + 1] + bb.y);
              if (part < 2) {
                *reinterpret_cast<__nv_bfloat162*>((part == 0 ? q_s : k_s) + r * QK_LD + col) = v;
              } else {
                vt_s[col * VT_LD + r] = v.x;
                vt_s[(col + 1) * VT_LD + r] = v.y;
              }
            }
          }
        }
        hopper::named_barrier(1 + wg, 128);  // q, k, v complete; every product has read h_s
        if (group == K::GROUPS - 1 && pair + blocks < pairs) {  // the next window's x, meanwhile
          hopper::copy_cores<ROWS, C, 128>(h_s, x + window(pair + blocks) * ROWS * C, C, t);
          hopper::cp_async_commit();
        }
        bf16* dst = attn + win * ROWS * C + group * GROUP;
        attend_rows(q_s, k_s, vt_s, bias, mask_r, group, scale, warp,
                    [&](int r, int col, uint32_t pair_v) {
                      if (valid) *reinterpret_cast<uint32_t*>(dst + r * C + col) = pair_v;
                    });
        hopper::named_barrier(1 + wg, 128);
      }
    }
  }
}

// ---- swin_block_fused, launch 2: the projection, LN2 and the MLP ----

template <int C>
struct BlockMlp {
  // Output columns a pass: all, but at C = 384 two passes of 192, each with its own [64, 192]
  // accumulator (96 registers a thread): its fc1 and GELU run once a pass, twice in all.
  static constexpr int PASSES = C == 384 ? 2 : 1;
  static constexpr int NO = C / PASSES;
  static constexpr int NP = NO < 192 ? NO : 192;         // columns of one product (N <= 256)
  static constexpr int PARTS = NO / NP;
  static constexpr int NC = C == 96 ? 96 : 64;         // hidden columns a chunk
  static constexpr int SLAB = C == 96 ? 9216 : 12288;  // values: 18 or 24 KB
  static constexpr int KP = SLAB / NO;                 // rows of w_proj a slab: [KP, NO]
  static constexpr int W1_ROWS = SLAB / NC;            // rows of W1 a slab: [W1_ROWS, NC]
  static constexpr int W1_SLABS = C / W1_ROWS;         // a chunk's fc1 product; W2: [NC, NO]
  static constexpr int PROJ_SLABS = C / KP;            // a pass's
  static constexpr int CHUNKS = 4 * C / NC;
  static constexpr int SLABS = PASSES * (PROJ_SLABS + (W1_SLABS + 1) * CHUNKS);  // a window pair's
  // x2 stays in shared memory where it fits beside the ring (C < 384); at C = 384 it is parked
  // in out, and read back as each thread stored it.
  static constexpr bool X2_TILE = C < 384;
  // TMA stages the slabs in swizzled boxes of BOX columns: 64 (128-byte rows) where every width
  // is a multiple of 64 (C >= 192), else 32 (64-byte rows).
  static constexpr int BOX = C % 64 == 0 ? 64 : 32;
  static constexpr int WIN = ROWS * C;  // a tile: attn, then LN2(x2); and x, then x2
  static constexpr int PARAMS = 6 * C;  // b_fc1 (4C), b_proj, b_fc2 in shared memory
  // the barriers, then the ring from a 1024-byte boundary (TMA's swizzle atom)
  static constexpr int FIXED =
      2 * BARRIER_BYTES + (CONSUMERS * WIN * (X2_TILE ? 2 : 1) + PARAMS) * 2;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (SLAB * 2);
  static constexpr int STAGES = cmin(SLABS, FIT);
  static constexpr bool RESIDENT = STAGES == SLABS;
  static constexpr int SMEM = FIXED + STAGES * SLAB * 2;
  static_assert(FIT >= 3 && C % KP == 0 && C % W1_ROWS == 0 && NC * NO <= SLAB,
                "a ring of at least three slots, whole slabs");
  static_assert(NO % BOX == 0 && NC % BOX == 0 && KP * NO == SLAB && NC * NO == SLAB &&
                    W1_ROWS <= 256 && KP <= 256,
                "TMA boxes of BOX columns and at most 256 rows fill every slab");
};

// out = x2 + fc2(GELU(fc1(LN2(x2)))), x2 = x + (attn @ wproj + bproj), for every window; attn,
// x, out [bw*64, C]; wfc1 [C, 4C]; wfc2 [4C, C]. Blocks and warpgroups as swin_attn_bf16_kernel.
// A warpgroup's [64, C] tile of shared memory holds the window's attn (the proj product's A),
// then LN2(x2) (fc1's A); below C = 384 a second tile holds x, then x2 in place, each thread
// writing where it read. At C = 384, x is read and x2 parked in out in the accumulator's layout
// (each thread reads back only what it wrote), x2 read back once into the first tile for LN2.
template <int C>
__global__ void __launch_bounds__(WS_THREADS, 1)
swin_mlp_bf16_kernel(const bf16* __restrict__ attn, const bf16* __restrict__ x,
                     const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                     const bf16* __restrict__ g2, const bf16* __restrict__ b2,
                     const bf16* __restrict__ wfc1, const bf16* __restrict__ bfc1,
                     const bf16* __restrict__ wfc2, const bf16* __restrict__ bfc2,
                     bf16* __restrict__ out, int bw,
                     const __grid_constant__ CUtensorMap tproj,
                     const __grid_constant__ CUtensorMap tfc1,
                     const __grid_constant__ CUtensorMap tfc2) {
  using K = BlockMlp<C>;
  constexpr int NO = K::NO, NP = K::NP, NC = K::NC, KP = K::KP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + K::STAGES;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((raw + 2 * BARRIER_BYTES - 1) / 1024 * 1024 - raw));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int pairs = (bw + CONSUMERS - 1) / CONSUMERS;
  const int block = blockIdx.x, blocks = gridDim.x;
  const int rounds = block < pairs ? (pairs - 1 - block) / blocks + 1 : 0;
  ring_init(full, empty, K::STAGES);

  if (wg == CONSUMERS) {
    hopper::regs_dec<PRODUCER_REGS>();
    // One thread has TMA stage each slab as boxes of [rows, BOX]: a round's slabs are each
    // pass's w_proj slabs, then each pass's W1 slabs and W2 slab of every chunk.
    constexpr int PROJ = K::PASSES * K::PROJ_SLABS, PER_CHUNK = K::W1_SLABS + 1, BOX = K::BOX;
    auto load = [&](int slab, bf16* dst, uint64_t* bar) {
      hopper::mbar_arrive_expect_tx(bar, K::SLAB * 2);
      if (slab < PROJ) {  // [KP, NO] of w_proj
        const int pass = slab / K::PROJ_SLABS, d = slab % K::PROJ_SLABS;
        for (int b = 0; b < NO / BOX; ++b) {
          hopper::tma_load_2d(dst + b * BOX * KP, &tproj, pass * NO + BOX * b, d * KP, bar);
        }
        return;
      }
      const int u = slab - PROJ, pass = u / (PER_CHUNK * K::CHUNKS);
      const int chunk = u / PER_CHUNK % K::CHUNKS, part = u % PER_CHUNK;
      if (part < K::W1_SLABS) {  // [W1_ROWS, NC] of W1
        for (int b = 0; b < NC / BOX; ++b) {
          hopper::tma_load_2d(dst + b * BOX * K::W1_ROWS, &tfc1, chunk * NC + BOX * b,
                              part * K::W1_ROWS, bar);
        }
      } else {  // [NC, NO] of W2
        for (int b = 0; b < NO / BOX; ++b) {
          hopper::tma_load_2d(dst + b * BOX * NC, &tfc2, pass * NO + BOX * b, chunk * NC, bar);
        }
      }
    };
    if (t == 0 && K::RESIDENT && rounds > 0) {
      for (int slab = 0; slab < K::SLABS; ++slab) load(slab, ring + slab * K::SLAB, full + slab);
    } else if (t == 0 && !K::RESIDENT) {
      RingPos pos;
      for (int r = 0; r < rounds; ++r) {
        for (int slab = 0; slab < K::SLABS; ++slab) {
          hopper::mbar_wait(empty + pos.slot, pos.parity ^ 1);
          load(slab, ring + pos.slot * K::SLAB, full + pos.slot);
          pos.next(K::STAGES);
        }
      }
    }
  } else {
    hopper::regs_inc<CONSUMER_REGS>();
    const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    bf16* a_s = ring + K::STAGES * K::SLAB + wg * K::WIN;
    bf16* x2_s = a_s + CONSUMERS * K::WIN;  // used where K::X2_TILE
    bf16* p_bfc1 = ring + K::STAGES * K::SLAB + CONSUMERS * K::WIN * (K::X2_TILE ? 2 : 1);
    bf16* p_bproj = p_bfc1 + 4 * C;
    bf16* p_bfc2 = p_bproj + C;
    for (int i = threadIdx.x; i < K::PARAMS / 8; i += 128 * CONSUMERS) {
      const int v = 8 * i;
      const bf16* src = v < 4 * C ? bfc1 + v : v < 5 * C ? bproj + v - 4 * C : bfc2 + v - 5 * C;
      *reinterpret_cast<uint4*>(p_bfc1 + v) = *reinterpret_cast<const uint4*>(src);
    }
    hopper::named_barrier(1 + CONSUMERS, 128 * CONSUMERS);
    Consumer<K::STAGES, K::RESIDENT> in{full, empty, ring, K::SLAB};
    // B of the k16 step s of a slab [rows, *] from column n0: TMA's swizzled boxes of
    // [rows, BOX], rows * BOX * 2 bytes apart.
    auto desc_w = [&](const bf16* slab, int rows, int s, int n0) {
      const bf16* box = slab + (n0 / K::BOX) * K::BOX * rows;
      return K::BOX == 64 ? hopper::desc_b_sw128(box, s, rows * 128)
                          : hopper::desc_b_sw64(box, s, rows * 64);
    };
    auto load_tile = [&](const bf16* src) {  // src [64, C] into a_s, for the whole warpgroup
      hopper::copy_cores<ROWS, C, 128>(a_s, src, C, t);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      hopper::named_barrier(1 + wg, 128);
    };
    for (int pair = block; pair < pairs; pair += blocks) {
      const int w = pair * CONSUMERS + wg;
      const bool valid = w < bw;
      const long long win = valid ? w : bw - 1;
      const bf16* xw = x + win * ROWS * C;
      bf16* ow = out + win * ROWS * C;
      // Calls f(p, j, hr, row, col) for the column pairs (col, col + 1) of each row this
      // thread holds of pass `pass`'s accumulator, acc[p][4 j + 2 hr + e].
      auto for_pairs = [&](int pass, auto&& f) {
#pragma unroll
        for (int p = 0; p < K::PARTS; ++p) {
#pragma unroll
          for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              f(p, j, hr, 16 * warp + g + 8 * hr, pass * NO + p * NP + 8 * j + 2 * q);
            }
          }
        }
      };
      float acc[K::PARTS][NP / 2];

      // x2 = round(x + (attn @ wproj + b_proj)), a pass of columns at a time, into x2_s or out;
      // one slab's products in flight while the next slab is awaited.
      hopper::copy_cores<ROWS, C, 128>(a_s, attn + win * ROWS * C, C, t);
      if constexpr (K::X2_TILE) hopper::copy_cores<ROWS, C, 128>(x2_s, xw, C, t);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + wg, 128);
#pragma unroll 1
      for (int pass = 0; pass < K::PASSES; ++pass) {
        int previous = -1;
        zero(acc);
#pragma unroll 1
        for (int d = 0; d < K::PROJ_SLABS; ++d) {
          const int slot = in.acquire();
          fence_regs(acc);
          hopper::fence();
#pragma unroll
          for (int s = 0; s < KP / 16; ++s) {
#pragma unroll
            for (int p = 0; p < K::PARTS; ++p) {
              hopper::mma_ss<NP>(acc[p], hopper::desc_a<C>(a_s, d * (KP / 16) + s),
                                 desc_w(in.slab(slot), KP, s, p * NP));
            }
          }
          hopper::commit();
          hopper::wait<1>();
          if (previous >= 0) in.release(previous);
          previous = slot;
        }
        hopper::wait<0>();
        fence_regs(acc);
        in.release(previous);
        if constexpr (K::X2_TILE) {
          for_pairs(pass, [&](int p, int j, int hr, int r, int col) {
            uint32_t* v = reinterpret_cast<uint32_t*>(x2_s + core_index<C>(r, col));
            const float2 xr = to_f2(*v), bb = to_f2(p_bproj + col);
            *v = pack_bf16(xr.x + (acc[p][4 * j + 2 * hr] + bb.x),
                           xr.y + (acc[p][4 * j + 2 * hr + 1] + bb.y));
          });
        } else if (valid) {
          for_pairs(pass, [&](int p, int j, int hr, int r, int col) {
            const float2 xr = to_f2(xw + r * C + col), bb = to_f2(p_bproj + col);
            *reinterpret_cast<uint32_t*>(ow + r * C + col) =
                pack_bf16(xr.x + (acc[p][4 * j + 2 * hr] + bb.x),
                          xr.y + (acc[p][4 * j + 2 * hr + 1] + bb.y));
          });
        }
      }
      // LN2 of x2 (rounded, as stored) into a_s.
      if constexpr (K::X2_TILE) {
        hopper::named_barrier(1 + wg, 128);  // x2 complete; every warp's products have read a_s
        ln_window<C>(x2_s, a_s, g2, b2, warp, lane);
      } else {
        __threadfence_block();               // x2's stores, before the warpgroup reads them back
        hopper::named_barrier(1 + wg, 128);  // and every warp's products have read a_s
        load_tile(ow);
        ln_window<C>(a_s, a_s, g2, b2, warp, lane);
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + wg, 128);

      // Per pass, acc = sum over chunks of round(GELU(LN2(x2) @ W1[:, chunk] + b1)) @ W2[chunk,
      // pass columns], the rounded hidden chunk fed to fc2 from registers; fc2 of chunk c and
      // fc1 of chunk c + 1 run back to back on the tensor cores, and nothing reads an
      // accumulator in flight.
      float h[1][NC / 2];
      uint32_t m[NC / 16][4];
      int s_w1[K::W1_SLABS];
      auto fc1 = [&]() {  // acquires the chunk's W1 slabs and issues its products
#pragma unroll
        for (int d = 0; d < K::W1_SLABS; ++d) s_w1[d] = in.acquire();
        zero(h);
        fence_regs(h);
        hopper::fence();
#pragma unroll
        for (int d = 0; d < K::W1_SLABS; ++d) {
#pragma unroll
          for (int s = 0; s < K::W1_ROWS / 16; ++s) {
            hopper::mma_ss<NC>(h[0], hopper::desc_a<C>(a_s, d * (K::W1_ROWS / 16) + s),
                               desc_w(in.slab(s_w1[d]), K::W1_ROWS, s, 0));
          }
        }
        hopper::commit();
      };
#pragma unroll 1
      for (int pass = 0; pass < K::PASSES; ++pass) {
        zero(acc);
        int s_w2 = -1;
        fc1();
#pragma unroll 1
        for (int chunk = 0; chunk < K::CHUNKS; ++chunk) {
          hopper::wait<0>();
          fence_regs(h);
          fence_regs(acc);
#pragma unroll
          for (int d = 0; d < K::W1_SLABS; ++d) in.release(s_w1[d]);
          if (s_w2 >= 0) in.release(s_w2);
#pragma unroll
          for (int kk = 0; kk < NC / 16; ++kk) {
            const int c0 = chunk * NC + 16 * kk + 2 * q;
            const float2 lo = to_f2(p_bfc1 + c0), hi = to_f2(p_bfc1 + c0 + 8);
            m[kk][0] = pack_bf16(gelu(h[0][8 * kk] + lo.x), gelu(h[0][8 * kk + 1] + lo.y));
            m[kk][1] = pack_bf16(gelu(h[0][8 * kk + 2] + lo.x), gelu(h[0][8 * kk + 3] + lo.y));
            m[kk][2] = pack_bf16(gelu(h[0][8 * kk + 4] + hi.x), gelu(h[0][8 * kk + 5] + hi.y));
            m[kk][3] = pack_bf16(gelu(h[0][8 * kk + 6] + hi.x), gelu(h[0][8 * kk + 7] + hi.y));
          }
          s_w2 = in.acquire();
          fence_regs(acc);
          hopper::fence();
#pragma unroll
          for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
            for (int p = 0; p < K::PARTS; ++p) {
              hopper::mma_rs<NP>(acc[p], m[kk],
                                 desc_w(in.slab(s_w2), NC, kk, p * NP));
            }
          }
          hopper::commit();
          if (chunk + 1 < K::CHUNKS) fc1();
        }
        hopper::wait<0>();
        fence_regs(acc);
        in.release(s_w2);
        if (valid) {  // out = round(x2 + (acc + b_fc2)), x2 as this thread stored it
          for_pairs(pass, [&](int p, int j, int hr, int r, int col) {
            const float2 x2 = to_f2(K::X2_TILE ? x2_s + core_index<C>(r, col) : ow + r * C + col);
            const float2 bb = to_f2(p_bfc2 + col);
            *reinterpret_cast<uint32_t*>(ow + r * C + col) =
                pack_bf16(x2.x + (acc[p][4 * j + 2 * hr] + bb.x),
                          x2.y + (acc[p][4 * j + 2 * hr + 1] + bb.y));
          });
        }
      }
      hopper::named_barrier(1 + wg, 128);  // every warp's products have read a_s
    }
  }
}

// ---- window_attention_fused: the attention half as token-tile GEMMs over all windows ----

// LN1 of each row of x [m, c] into a [m, c], rounded to bf16; one warp per row.
__global__ void __launch_bounds__(THREADS)
ln_rows_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g1,
                    const bf16* __restrict__ b1, bf16* __restrict__ a, int m, int c) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= m) return;
  ln_row(x + (long long)row * c, c, g1, b1, a + (long long)row * c);
}

constexpr int GEMM_BM = 64 * CONSUMERS;  // rows of an output tile: 64 a consumer
constexpr int GEMM_BN = 192;             // columns of an output tile: three TMA boxes of 64
constexpr int GEMM_KS = 64;              // depth of a slab: one TMA box of 128-byte rows
constexpr int GEMM_SLAB_BYTES = (GEMM_BM + GEMM_BN) * GEMM_KS * 2;  // A [128, 64], B [64, 192]
constexpr int GEMM_STAGES = 4;
// The output tile [128, 192] bf16 as three swizzled boxes of [128, 64]: the residual's TMA
// load, then the output for the TMA store.
constexpr int GEMM_TILE_BYTES = GEMM_BM * GEMM_BN * 2;
// The ring's 1024-byte aligned slots (the 128-byte swizzle's atom) after the barriers, then the
// output tile.
constexpr int GEMM_SMEM = 2 * BARRIER_BYTES + GEMM_STAGES * GEMM_SLAB_BYTES + GEMM_TILE_BYTES;

// out[r, j] = round((a @ w)[r, j] + bias[j] (+ residual[r, j])) for r < m, j < n: a [m, k],
// w [k, n], the residual and out [m, n], row-major bf16, with tensor maps over them (ta: boxes
// of 64 values by 128 rows; tb, tr, to: by 64 rows; 128-byte swizzle), float32 sums. Block
// (blockIdx.x, blockIdx.y) takes the [128, 192] tile at columns GEMM_BN * blockIdx.x and rows
// GEMM_BM * blockIdx.y, consumer warpgroup i its rows 64 i .. 64 i + 63. One producer thread has
// TMA stage each slab (a's tile rows, w's tile columns, 64 deep; whatever lies past m, n or k
// reads as zero) and the residual's tile, and a consumer keeps one slab's products in flight
// while it waits for the next; it rounds its outputs into the staged tile (where it read the
// residual) and has TMA store them, which writes nothing past m or n. n % 8 == 0, k % 8 == 0,
// pointers 16-byte aligned.
__global__ void __launch_bounds__(WS_THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap to,
                 const bf16* __restrict__ bias, bool has_residual, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + GEMM_STAGES;
  uint64_t* staged = empty + GEMM_STAGES;  // the residual's tile has landed
  const uint32_t raw = hopper::smem_u32(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((raw + 2 * BARRIER_BYTES - 1) / 1024 * 1024 - raw));
  bf16* tile = ring + GEMM_STAGES * GEMM_SLAB_BYTES / 2;  // [3][128][64] swizzled
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int slabs = (k + GEMM_KS - 1) / GEMM_KS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * CONSUMERS);  // a consumer warp's lane 0 each
    }
    hopper::mbar_init(staged, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  constexpr int SLAB = GEMM_SLAB_BYTES / 2;
  if (wg == CONSUMERS) {
    hopper::regs_dec<PRODUCER_REGS>();
    if (t == 0) {
      if (has_residual) {
        hopper::mbar_arrive_expect_tx(staged, GEMM_TILE_BYTES);
#pragma unroll
        for (int b = 0; b < GEMM_BN / 64; ++b) {
#pragma unroll
          for (int h = 0; h < CONSUMERS; ++h) {
            hopper::tma_load_2d(tile + (b * GEMM_BM + 64 * h) * 64, &tr, n0 + 64 * b, m0 + 64 * h,
                                staged);
          }
        }
      }
      RingPos pos;
      for (int s = 0; s < slabs; ++s) {
        hopper::mbar_wait(empty + pos.slot, pos.parity ^ 1);
        bf16* dst = ring + pos.slot * SLAB;
        hopper::mbar_arrive_expect_tx(full + pos.slot, GEMM_SLAB_BYTES);
        hopper::tma_load_2d(dst, &ta, s * GEMM_KS, m0, full + pos.slot);
#pragma unroll
        for (int b = 0; b < GEMM_BN / 64; ++b) {
          hopper::tma_load_2d(dst + GEMM_BM * GEMM_KS + b * 64 * GEMM_KS, &tb, n0 + 64 * b,
                              s * GEMM_KS, full + pos.slot);
        }
        pos.next(GEMM_STAGES);
      }
    }
  } else {
    hopper::regs_inc<CONSUMER_REGS>();
    const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    float acc[1][GEMM_BN / 2];
    zero(acc);
    Consumer<GEMM_STAGES, false> in{full, empty, ring, SLAB};
    int previous = -1;
    for (int s = 0; s < slabs; ++s) {
      const int slot = in.acquire();
      const bf16* slab = in.slab(slot);
      fence_regs(acc);
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_KS / 16; ++kk) {
        hopper::mma_ss<GEMM_BN>(acc[0], hopper::desc_a_sw128(slab + wg * 64 * GEMM_KS, kk),
                                hopper::desc_b_sw128(slab + GEMM_BM * GEMM_KS, kk, 64 * GEMM_KS * 2));
      }
      hopper::commit();
      hopper::wait<1>();  // the previous slab's products are done: its slot is free
      if (previous >= 0) in.release(previous);
      previous = slot;
    }
    hopper::wait<0>();
    fence_regs(acc);

    // This warpgroup's rows of the tile: round(residual + (acc + bias)) where the residual lay.
    if (has_residual) hopper::mbar_wait(staged, 0);
    unsigned char* mine = reinterpret_cast<unsigned char*>(tile) + 64 * wg * 128;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * warp + g + 8 * hr, col = 8 * j + 2 * q;
        uint32_t* v = reinterpret_cast<uint32_t*>(mine + (col / 64) * GEMM_BM * 128 +
                                                  hopper::sw128_offset(row, col % 64));
        const float2 bb = to_f2(bias + (n0 + col < n ? n0 + col : n - 2));  // past n: unstored
        float v0 = acc[0][4 * j + 2 * hr] + bb.x, v1 = acc[0][4 * j + 2 * hr + 1] + bb.y;
        if (has_residual) {
          const float2 r = to_f2(*v);
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        *v = pack_bf16(v0, v1);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < GEMM_BN / 64; ++b) {
        hopper::tma_store_2d(&to, mine + b * GEMM_BM * 128, n0 + 64 * b, m0 + 64 * wg);
      }
      hopper::tma_store_commit_and_wait();
    }
  }
}

constexpr int ATTN_SMEM_BYTES = (2 * ROWS * QK_LD + GROUP * VT_LD) * (int)sizeof(bf16);

// The attention of window blockIdx.x, heads 4*blockIdx.y .. +3, from qkv [bw*64, 3c] (q | k |
// v, b_qkv added), into attn [bw*64, c].
__global__ void __launch_bounds__(THREADS)
attention_from_qkv_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                               const float* __restrict__ mask, int mask_count,
                               bf16* __restrict__ attn, int c, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][QK_LD]
  bf16* k_s = q_s + ROWS * QK_LD;                  // [ROWS][QK_LD]
  bf16* vt_s = k_s + ROWS * QK_LD;                 // [GROUP][VT_LD]
  const long long win = blockIdx.x;
  const int group = blockIdx.y;
  const bf16* src = qkv + win * ROWS * 3 * c + group * GROUP;
  for (int i = threadIdx.x; i < 2 * ROWS * (GROUP / 8); i += THREADS) {
    const int part = i / (ROWS * (GROUP / 8)), r = (i / (GROUP / 8)) % ROWS;
    const int col = 8 * (i % (GROUP / 8));
    hopper::cp_async16((part == 0 ? q_s : k_s) + r * QK_LD + col,
                       src + (long long)r * 3 * c + part * c + col);
  }
  hopper::cp_async_commit();
  for (int i = threadIdx.x; i < ROWS * (GROUP / 2); i += THREADS) {
    const int r = i / (GROUP / 2), col = 2 * (i % (GROUP / 2));
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(src + (long long)r * 3 * c + 2 * c + col);
    vt_s[col * VT_LD + r] = v.x;
    vt_s[(col + 1) * VT_LD + r] = v.y;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  bf16* dst = attn + win * ROWS * c + group * GROUP;
  attend_group(q_s, k_s, vt_s, bias, mask + (win % mask_count) * ROWS * ROWS, group, scale,
               [=](int r, int col, uint32_t pair) {
                 *reinterpret_cast<uint32_t*>(dst + (long long)r * c + col) = pair;
               });
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int check_args(int bw, int c, int heads, int mask_count) {
  if (bw <= 0 || heads <= 0 || heads % HEADS_PER_BLOCK || c != heads * HD || mask_count <= 0) {
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

// A tensor map over the row-major bf16 matrix p [rows, cols]: boxes of box_cols columns (64:
// 128 bytes, 128-byte swizzle; 32: 64 bytes, 64-byte swizzle) by box_rows rows.
int tensor_map(CUtensorMap* map, const bf16* p, int rows, int cols, int box_rows,
               int box_cols = 64) {
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
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The two launches of the block at width C: grid of at most one block per SM.
template <int C>
int launch_block(const bf16* x, const bf16* wqkv, const bf16* bqkv, const bf16* wproj,
                 const bf16* bproj, const bf16* bias, const float* mask, int mask_count,
                 const bf16* g1, const bf16* b1, const bf16* g2, const bf16* b2,
                 const bf16* wfc1, const bf16* bfc1, const bf16* wfc2, const bf16* bfc2,
                 bf16* attn, bf16* out, int bw, cudaStream_t stream) {
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  const int pairs = (bw + CONSUMERS - 1) / CONSUMERS;
  const int grid = pairs < sms ? pairs : sms;
  CUtensorMap tqkv;
  err = tensor_map(&tqkv, wqkv, C, 3 * C, BlockAttn<C>::KS, 32);
  if (err) return err;
  err = set_smem(swin_attn_bf16_kernel<C>, BlockAttn<C>::SMEM);
  if (err) return err;
  swin_attn_bf16_kernel<C><<<grid, WS_THREADS, BlockAttn<C>::SMEM, stream>>>(
      x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, bw, 1.0f / sqrtf((float)HD), tqkv);
  err = (int)cudaGetLastError();
  if (err) return err;
  using M = BlockMlp<C>;
  CUtensorMap tproj, tfc1, tfc2;
  err = tensor_map(&tproj, wproj, C, C, M::KP, M::BOX);
  if (!err) err = tensor_map(&tfc1, wfc1, C, 4 * C, M::W1_ROWS, M::BOX);
  if (!err) err = tensor_map(&tfc2, wfc2, 4 * C, C, M::NC, M::BOX);
  if (err) return err;
  err = set_smem(swin_mlp_bf16_kernel<C>, BlockMlp<C>::SMEM);
  if (err) return err;
  swin_mlp_bf16_kernel<C><<<grid, WS_THREADS, BlockMlp<C>::SMEM, stream>>>(
      attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out, bw, tproj, tfc1, tfc2);
  return (int)cudaGetLastError();
}

int launch_gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* residual, bf16* out,
                int m, int n, int k, cudaStream_t stream) {
  CUtensorMap ta, tb, tr, to;
  int err = tensor_map(&ta, a, m, k, GEMM_BM);
  if (!err) err = tensor_map(&tb, w, k, n, GEMM_KS);
  if (!err) err = tensor_map(&tr, residual != nullptr ? residual : out, m, n, 64);
  if (!err) err = tensor_map(&to, out, m, n, 64);
  if (!err) err = set_smem(gemm_bf16_kernel, GEMM_SMEM);
  if (err) return err;
  gemm_bf16_kernel<<<dim3((n + GEMM_BN - 1) / GEMM_BN, (m + GEMM_BM - 1) / GEMM_BM), WS_THREADS,
                     GEMM_SMEM, stream>>>(ta, tb, tr, to, bias, residual != nullptr, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x + proj(attn(LN1(x))) into out [bw, 64, c], all bf16 but the float32 mask, in four launches:
// LN1, the qkv GEMM with b_qkv, the attention, the proj GEMM with b_proj and the residual.
// Scratch: a [bw*64, c] (LN1(x), then attn) and qkv [bw*64, 3c], bf16. Launches on `stream`
// and returns the first cudaError_t (0 = ok; cudaErrorInvalidValue for shapes the kernels do
// not take). Does not synchronise and allocates nothing.
int window_attention_bf16_launch(const bf16* x, const bf16* wqkv, const bf16* bqkv,
                                 const bf16* wproj, const bf16* bproj, const bf16* bias,
                                 const float* mask, int mask_count, const bf16* g1,
                                 const bf16* b1, bf16* a, bf16* qkv, bf16* out, int bw, int c,
                                 int heads, void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  if (bw > 65535) return (int)cudaErrorInvalidValue;  // as window_attention_launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = bw * ROWS;

  ln_rows_bf16_kernel<<<(m + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(x, g1, b1, a,
                                                                                   m, c);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_gemm(a, wqkv, bqkv, nullptr, qkv, m, 3 * c, c, s);
  if (err) return err;

  err = set_smem(attention_from_qkv_bf16_kernel, ATTN_SMEM_BYTES);
  if (err) return err;
  attention_from_qkv_bf16_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS, ATTN_SMEM_BYTES,
                                   s>>>(qkv, bias, mask, mask_count, a, c,
                                        1.0f / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_gemm(a, wproj, bproj, x, out, m, c, c, s);
}

// The whole block into out [bw, 64, c], c = 96, 192 or 384, in two launches; attn [bw*64, c]
// bf16 is scratch. Same conventions as window_attention_bf16_launch.
int swin_block_bf16_launch(const bf16* x, const bf16* wqkv, const bf16* bqkv, const bf16* wproj,
                           const bf16* bproj, const bf16* bias, const float* mask,
                           int mask_count, const bf16* g1, const bf16* b1, const bf16* g2,
                           const bf16* b2, const bf16* wfc1, const bf16* bfc1, const bf16* wfc2,
                           const bf16* bfc2, bf16* attn, bf16* out, int bw, int c, int heads,
                           void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 96:
      return launch_block<96>(x, wqkv, bqkv, wproj, bproj, bias, mask, mask_count, g1, b1, g2,
                              b2, wfc1, bfc1, wfc2, bfc2, attn, out, bw, s);
    case 192:
      return launch_block<192>(x, wqkv, bqkv, wproj, bproj, bias, mask, mask_count, g1, b1, g2,
                               b2, wfc1, bfc1, wfc2, bfc2, attn, out, bw, s);
    case 384:
      return launch_block<384>(x, wqkv, bqkv, wproj, bproj, bias, mask, mask_count, g1, b1, g2,
                               b2, wfc1, bfc1, wfc2, bfc2, attn, out, bw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
