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
// the tensor cores (mma.sync.m16n8k16, and one m16n8k8 for the last 8 of head_dim 24 in q k^T)
// with float32 sums; a bf16 operand is exact, so there is no hi/lo split. LayerNorm (two-pass),
// the softmax (from the row max) and GELU (erff) run in float32 SIMT. Values are rounded to
// bf16 (round to nearest even) exactly where _attention_half and _block_kernel round: LN1's
// output h; qkv after b_qkv; the probabilities p; each head's p v; the attention residual
// x2 = x + (attn @ w_proj + b_proj), whose rounded value LN2's moments are taken over; LN2's
// output; GELU's output; and the output x2 + (m @ w_fc2 + b_fc2). The accumulators start at
// zero and the biases and residuals are added after the products, in the Pallas kernels'
// order.
//
// What bounds it on the H100: the float32 instances' flops (24*M*C^2 + 4*M*64*C for the block,
// 8*M*C^2 + 4*M*64*C for the attention half, M = BW * 64 tokens) at the dense bf16 rate of
// 989 TFLOP/s, against x, out and the weights in bf16 at 3.35 TB/s: some 640 flops a byte
// at C = 96, beyond the 295 at which the rate binds, so both are bound by operations.
//
// How it is laid out: as the float32 instances, with bf16 operands staged in shared memory
// (half the bytes of their float32 slabs, refitted below), 16-byte cp.async moving 8 values.
// - swin_block_fused, two launches. window_core_bf16_kernel, one block per (window, group of 4
//   heads): h = LN1(x) of the window's 64 rows into shared memory ([64, C] bf16); q, k and v of
//   its heads by block_mma (h resident, w_qkv streamed in [32, 96] slabs through a two-stage
//   ring), q and k row-major and v transposed, so that every attention fragment is one 32-bit
//   shared load; then one warp per (head, 32 query rows): S = q k^T, bias and mask, softmax,
//   P v with P taken from the S accumulator as the A operand. attn [M, C] bf16 is the only
//   intermediate in device memory. swin_mlp_bf16_kernel<C>, one block per window: x2 =
//   round(x + attn @ w_proj + b_proj) kept in shared memory, LN2(x2) beside it, and for each
//   96-column chunk of the hidden layer m = round(GELU(LN2(x2) @ W1[:, chunk] + b1)) in shared
//   memory and acc += m @ W2[chunk, :]; only out is written.
// - window_attention_fused (CLAP stage 4, C = 768), four launches: LN1(x) to device memory;
//   qkv = LN1(x) @ w_qkv + b_qkv and out = x + attn @ w_proj + b_proj as token-tile GEMMs
//   (gemm_bf16_kernel: [BM, BN] tiles over 8 warps, 32-deep slabs through a four-stage
//   cp.async ring, ldmatrix fragments); the attention per (window, 4 heads) from qkv between
//   them.
// Row strides are padded by 8 values (16 bytes) so that ldmatrix and the 32-bit fragment loads
// are free of bank conflicts.
//
// The wrapper (ops/window_attn.py) checks shapes, types (bf16 operands with a float32 mask),
// devices, contiguity and 16-byte alignment, and allocates the output and the scratch; a bf16
// CUDA tensor reaches these kernels or the wrapper raises, and there is no fallback to the
// plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;          // eight warps: every kernel but swin_mlp_bf16_kernel<C>
template <int C>
constexpr int mlp_warps() {           // as few as hold the [64, C] fc2 accumulator in registers
  return C == 96 ? 4 : C == 192 ? 8 : 12;
}
constexpr int ROWS = 64;              // tokens of an 8x8 window
constexpr int HD = 24;                // head_dim
constexpr int GROUP = 96;             // columns of 4 heads: the attention's tile width
constexpr int HEADS_PER_BLOCK = GROUP / HD;
constexpr int PAD = 8;                // values of row padding: 16 bytes
constexpr int QK_LD = GROUP + PAD;    // q and k of a block's heads, [64][104]
constexpr int VT_LD = ROWS + PAD;     // v transposed, [96][72]
constexpr int KT = 32;                // depth of a staged weight slab: two k16 steps
constexpr int HIDDEN_CHUNK = 96;      // hidden columns kept on chip at a time
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// cp.async of 16 bytes that writes zeros where !valid (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float2 to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half: one mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 tiles from shared memory: lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The same, each tile transposed on delivery (a row-major [k][n] slab gives B fragments).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
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

constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// bf16 values of block_mma's ring: two [KT, NT] slabs of W with padded rows.
template <int NT>
constexpr int ring_values() {
  return 2 * KT * (NT + PAD);
}

// acc += A[0:64, 0:k] @ W[0:k, col0:col0+NT] on the tensor cores. A is bf16, resident in shared
// memory (row stride lda); W bf16 row-major in device memory (ldw values a row), streamed in
// [KT, NT] slabs through a two-stage cp.async ring, so a slab's load overlaps the previous
// slab's products. A fragments come by ldmatrix, B fragments by ldmatrix.trans (two n8 tiles
// at a time). k % KT == 0; lda, ldw and col0 multiples of 8, pointers 16-byte aligned. Starts
// and ends with the ring free; the caller synchronises before it after writing A.
template <int NT, int WARPS>
__device__ __forceinline__ void block_mma(const bf16* a, int lda, int k,
                                          const bf16* __restrict__ w, int ldw, int col0,
                                          bf16* ring,
                                          float (&acc)[2][Tiling<NT, WARPS>::N_TILES][4]) {
  using T = Tiling<NT, WARPS>;
  constexpr int NTHREADS = 32 * WARPS;
  constexpr int W_LD = NT + PAD;
  constexpr int STAGE = KT * W_LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int arow = 32 * (warp / T::COLS) + lane % 16;
  const int acol = 8 * (lane / 16);
  const int bcol = (warp % T::COLS) * T::WN + 8 * (lane / 16);
  const int slabs = k / KT;

  auto load = [&](int s) {
    bf16* ws = ring + (s & 1) * STAGE;
    const int k0 = s * KT;
    for (int i = threadIdx.x; i < KT * NT / 8; i += NTHREADS) {
      const int r = i / (NT / 8), c = 8 * (i % (NT / 8));
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
    const bf16* ws = ring + (s & 1) * STAGE;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4(af[mt], a + (arow + 16 * mt) * lda + s * KT + kk + acol);
      }
      const bf16* wp = ws + (kk + lane % 16) * W_LD + bcol;
#pragma unroll
      for (int nt = 0; nt < T::N_TILES; nt += 2) {
        if (nt + 1 < T::N_TILES) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, wp + 8 * nt);
          const uint32_t b0[2] = {bfr[0], bfr[1]}, b1[2] = {bfr[2], bfr[3]};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_k16(acc[mt][nt], af[mt], b0);
            mma_k16(acc[mt][nt + 1], af[mt], b1);
          }
        } else {
          uint32_t b0[2];
          // Lanes 16-31 give no address to an .x2 load; theirs stays in the slab all the same.
          ldsm_x2_trans(b0, ws + (kk + lane % 16) * W_LD + (warp % T::COLS) * T::WN + 8 * nt);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_k16(acc[mt][nt], af[mt], b0);
        }
      }
    }
    __syncthreads();
  }
}

// Attention of one group of HEADS_PER_BLOCK heads over one window: q and k of the group's GROUP
// columns row-major in shared memory ([ROWS][QK_LD], head hh at columns hh*24 .. +23), v
// transposed ([GROUP][VT_LD]), bias [heads, 64, 64] bf16, the window's mask rows mask_w
// [64, 64] float32. Warp w takes head w/2 of the group and query rows 32*(w%2) .. +31, one m16
// tile at a time; fragment rows are g and g + 8 of the tile, S columns (keys) 8j + 2t and
// 8j + 2t + 1. store(row, col, packed) takes the rounded outputs of the neighbouring group
// columns col, col + 1 of a row as one bf16 pair. Reads shared memory only after the caller's
// __syncthreads.
template <class Store>
__device__ __forceinline__ void attend_group(const bf16* q_s, const bf16* k_s, const bf16* vt_s,
                                             const bf16* __restrict__ bias,
                                             const float* __restrict__ mask_w, int group,
                                             float scale, Store&& store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = warp / 2;
  const int h = group * HEADS_PER_BLOCK + hh;
  const bf16* q = q_s + hh * HD + 2 * t;
  const bf16* k = k_s + hh * HD + 2 * t;
  const bf16* vt = vt_s + hh * HD * VT_LD + 2 * t;
  const bf16* bias_h = bias + (long long)h * ROWS * ROWS;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 32 * (warp % 2) + 16 * mt;
    const bf16* qa = q + (r0 + g) * QK_LD;
    const bf16* qb = qa + 8 * QK_LD;
    const uint32_t a16[4] = {ld32(qa), ld32(qb), ld32(qa + 8), ld32(qb + 8)};  // d 0-15
    const uint32_t a8[2] = {ld32(qa + 16), ld32(qb + 16)};                      // d 16-23
    float s[ROWS / 8][4] = {};  // S[r0 .. r0+15, keys 8j .. 8j+7]
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
      const bf16* kr = k + (8 * j + g) * QK_LD;  // B[d][key] = k[key][d]
      const uint32_t b16[2] = {ld32(kr), ld32(kr + 8)};
      mma_k16(s[j], a16, b16);
      mma_k8(s[j], a8, ld32(kr + 16));
    }
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (r0 + g + 8 * half) * ROWS + 8 * j + 2 * t;
        const float2 bb = to_f2(bias_h + off);
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
        const bf16* vr = vt + (8 * n + g) * VT_LD + 16 * i;
        const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
        mma_k16(o[n], pa, b);
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store(r0 + g + 8 * half, hh * HD + 8 * n + 2 * t,
              pack_bf16(o[n][2 * half], o[n][2 * half + 1]));
      }
    }
  }
}

// Shared memory of window_core_bf16_kernel at width c: h [64][c+8], q and k [64][104], v^T
// [96][72] and block_mma's ring, all bf16.
int core_smem_bytes(int c) {
  return (ROWS * (c + PAD) + 2 * ROWS * QK_LD + GROUP * VT_LD + ring_values<GROUP>()) *
         (int)sizeof(bf16);
}

// attn[w*64 + r, h*24 + d] for the window w = blockIdx.x and heads 4*blockIdx.y .. +3.
// x [bw*64, c]; wqkv [c, 3c]; bqkv [3c]; bias [heads, 64, 64]; mask [mask_count, 64, 64].
__global__ void __launch_bounds__(THREADS)
window_core_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ bqkv, const bf16* __restrict__ bias,
                        const float* __restrict__ mask, int mask_count,
                        const bf16* __restrict__ g1, const bf16* __restrict__ b1,
                        bf16* __restrict__ attn, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h_ld = c + PAD;
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);  // LN1(x): [ROWS][h_ld]
  bf16* q_s = h_s + ROWS * h_ld;                  // [ROWS][QK_LD]
  bf16* k_s = q_s + ROWS * QK_LD;                 // [ROWS][QK_LD]
  bf16* vt_s = k_s + ROWS * QK_LD;                // [GROUP][VT_LD]
  bf16* ring = vt_s + GROUP * VT_LD;

  const long long win = blockIdx.x;
  const bf16* xw = x + win * ROWS * c;
  const int group = blockIdx.y;
  for (int r = threadIdx.x / 32; r < ROWS; r += THREADS / 32) {
    ln_row(xw + (long long)r * c, c, g1, b1, h_s + r * h_ld);
  }
  __syncthreads();

  for (int part = 0; part < 3; ++part) {  // q, k, v
    const int col0 = part * c + group * GROUP;
    float acc[2][Tiling<GROUP, THREADS / 32>::N_TILES][4] = {};
    block_mma<GROUP, THREADS / 32>(h_s, h_ld, c, wqkv, 3 * c, col0, ring, acc);
    for_each_pair<GROUP, THREADS / 32>(acc, [&](int r, int col, float v0, float v1) {
      const float2 bb = to_f2(bqkv + col0 + col);
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0 + bb.x, v1 + bb.y);
      if (part < 2) {
        *reinterpret_cast<__nv_bfloat162*>((part == 0 ? q_s : k_s) + r * QK_LD + col) = v;
      } else {
        vt_s[col * VT_LD + r] = v.x;
        vt_s[(col + 1) * VT_LD + r] = v.y;
      }
    });
  }
  __syncthreads();

  bf16* dst = attn + win * ROWS * c + group * GROUP;
  attend_group(q_s, k_s, vt_s, bias, mask + (win % mask_count) * ROWS * ROWS, group, scale,
               [&](int r, int col, uint32_t pair) {
                 *reinterpret_cast<uint32_t*>(dst + (long long)r * c + col) = pair;
               });
}

// Shared memory of swin_mlp_bf16_kernel<C>: x2 and a (attn, then LN2(x2)) [64][C+8], the
// hidden chunk [64][104], and block_mma's ring for the widest slab, all bf16.
template <int C>
constexpr int mlp_smem_bytes() {
  return (2 * ROWS * (C + PAD) + ROWS * (HIDDEN_CHUNK + PAD) +
          cmax(ring_values<C>(), ring_values<HIDDEN_CHUNK>())) *
         (int)sizeof(bf16);
}

// The rest of the block for the window blockIdx.x: out = x2 + (fc2(GELU(fc1(LN2(x2)))) with
// x2 = x + (attn @ wproj + bproj). attn, x, out [bw*64, C]; wfc1 [C, 4C]; wfc2 [4C, C].
template <int C, int MLP_WARPS = mlp_warps<C>()>
__global__ void __launch_bounds__(32 * MLP_WARPS, 1)
swin_mlp_bf16_kernel(const bf16* __restrict__ attn, const bf16* __restrict__ x,
                     const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                     const bf16* __restrict__ g2, const bf16* __restrict__ b2,
                     const bf16* __restrict__ wfc1, const bf16* __restrict__ bfc1,
                     const bf16* __restrict__ wfc2, const bf16* __restrict__ bfc2,
                     bf16* __restrict__ out) {
  constexpr int LD = C + PAD;
  constexpr int M_LD = HIDDEN_CHUNK + PAD;
  constexpr int NTHREADS = 32 * MLP_WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x2_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]: x2, rounded
  bf16* a_s = x2_s + ROWS * LD;                     // [ROWS][LD]: attn, then LN2(x2)
  bf16* m_s = a_s + ROWS * LD;                      // [ROWS][M_LD]: a hidden chunk after GELU
  bf16* ring = m_s + ROWS * M_LD;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const bf16* xw = x + row0 * C;

  for (int i = threadIdx.x; i < ROWS * C / 8; i += NTHREADS) {
    const int r = i / (C / 8), col = 8 * (i % (C / 8));
    cp_async16(a_s + r * LD + col, attn + (row0 + r) * C + col);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // x2 = round(x + (attn @ wproj + bproj)).
  float acc[2][Tiling<C, MLP_WARPS>::N_TILES][4] = {};
  block_mma<C, MLP_WARPS>(a_s, LD, C, wproj, C, 0, ring, acc);
  for_each_pair<C, MLP_WARPS>(acc, [&](int r, int col, float& v0, float& v1) {
    const float2 xr = to_f2(xw + r * C + col), bb = to_f2(bproj + col);
    *reinterpret_cast<uint32_t*>(x2_s + r * LD + col) =
        pack_bf16(xr.x + (v0 + bb.x), xr.y + (v1 + bb.y));
    v0 = 0.0f;  // the accumulator is reused for fc2
    v1 = 0.0f;
  });
  __syncthreads();
  for (int r = threadIdx.x / 32; r < ROWS; r += MLP_WARPS) {
    ln_row(x2_s + r * LD, C, g2, b2, a_s + r * LD);
  }
  __syncthreads();

  for (int j0 = 0; j0 < 4 * C; j0 += HIDDEN_CHUNK) {
    float hacc[2][Tiling<HIDDEN_CHUNK, MLP_WARPS>::N_TILES][4] = {};
    block_mma<HIDDEN_CHUNK, MLP_WARPS>(a_s, LD, C, wfc1, 4 * C, j0, ring, hacc);
    for_each_pair<HIDDEN_CHUNK, MLP_WARPS>(hacc, [&](int r, int col, float v0, float v1) {
      const float2 bb = to_f2(bfc1 + j0 + col);
      *reinterpret_cast<uint32_t*>(m_s + r * M_LD + col) =
          pack_bf16(gelu(v0 + bb.x), gelu(v1 + bb.y));
    });
    __syncthreads();
    block_mma<C, MLP_WARPS>(m_s, M_LD, HIDDEN_CHUNK, wfc2 + (long long)j0 * C, C, 0, ring, acc);
  }
  for_each_pair<C, MLP_WARPS>(acc, [&](int r, int col, float v0, float v1) {
    const float2 x2 = to_f2(x2_s + r * LD + col), bb = to_f2(bfc2 + col);
    *reinterpret_cast<uint32_t*>(out + (row0 + r) * C + col) =
        pack_bf16(x2.x + (v0 + bb.x), x2.y + (v1 + bb.y));
  });
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

constexpr int GEMM_KT = 32;              // depth of a staged slab
constexpr int GEMM_A_LD = GEMM_KT + PAD;  // 40 values: conflict-free ldmatrix
constexpr int GEMM_STAGES = 4;           // cp.async ring

// A [BM, BN] output tile over 8 warps in 2 rows by 4 columns, each warp MT m16 by NT n8 tiles.
template <int BM, int BN>
struct GemmTile {
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && NT % 2 == 0, "whole m16 tiles and pairs of n8 tiles");
  static constexpr int B_LD = BN + PAD;
  static constexpr int STAGE = BM * GEMM_A_LD + GEMM_KT * B_LD;
  static constexpr int SMEM_BYTES = GEMM_STAGES * STAGE * (int)sizeof(bf16);
};

// out[r, j] = round((a @ w)[r, j] + bias[j] (+ residual[r, j])) for r < m, j < n: a [m, k] and
// w [k, n] row-major bf16, float32 sums. Block (blockIdx.x, blockIdx.y) takes output columns
// BN * blockIdx.x and rows BM * blockIdx.y; 32-deep slabs stream through a four-stage cp.async
// ring (rows past m and columns past n read as zero and are not written); A fragments by
// ldmatrix, B fragments by ldmatrix.trans. k % 32 == 0, n % 8 == 0, pointers 16-byte aligned.
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, const bf16* __restrict__ residual,
                 bf16* __restrict__ out, int m, int n, int k) {
  using T = GemmTile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;

  auto load = [&](int slab, int stage) {
    bf16* as = smem + stage * T::STAGE;
    bf16* bs = as + BM * GEMM_A_LD;
    const int k0 = slab * GEMM_KT;
    for (int i = threadIdx.x; i < BM * (GEMM_KT / 8); i += THREADS) {
      const int r = i / (GEMM_KT / 8), c = 8 * (i % (GEMM_KT / 8));
      const bool valid = m0 + r < m;
      cp_async16_zfill(as + r * GEMM_A_LD + c, a + (long long)(valid ? m0 + r : 0) * k + k0 + c,
                       valid);
    }
    for (int i = threadIdx.x; i < GEMM_KT * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      const bool valid = n0 + c < n;
      cp_async16_zfill(bs + r * T::B_LD + c, w + (long long)(k0 + r) * n + (valid ? n0 + c : 0),
                       valid);
    }
  };

  float acc[T::MT][T::NT][4] = {};
  const int a_row = wm * T::WM + lane % 16, a_col = 8 * (lane / 16);
  const int b_col = wn * T::WN + 8 * (lane / 16);
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
    const bf16* as = smem + (s % GEMM_STAGES) * T::STAGE;
    const bf16* bs = as + BM * GEMM_A_LD;
#pragma unroll
    for (int kk = 0; kk < GEMM_KT; kk += 16) {
      uint32_t bfr[T::NT][2];
#pragma unroll
      for (int nt = 0; nt < T::NT; nt += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk + lane % 16) * T::B_LD + b_col + 8 * nt);
        bfr[nt][0] = r[0];
        bfr[nt][1] = r[1];
        bfr[nt + 1][0] = r[2];
        bfr[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, as + (a_row + 16 * mt) * GEMM_A_LD + kk + a_col);
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) mma_k16(acc[mt][nt], af, bfr[nt]);
      }
    }
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
          const float2 bb = to_f2(bias + col);
          float v0 = acc[mt][nt][2 * h] + bb.x, v1 = acc[mt][nt][2 * h + 1] + bb.y;
          if (residual != nullptr) {
            const float2 r = to_f2(residual + o);
            v0 = r.x + v0;
            v1 = r.y + v1;
          }
          *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
        }
      }
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][QK_LD]
  bf16* k_s = q_s + ROWS * QK_LD;                  // [ROWS][QK_LD]
  bf16* vt_s = k_s + ROWS * QK_LD;                 // [GROUP][VT_LD]
  const long long win = blockIdx.x;
  const int group = blockIdx.y;
  const bf16* src = qkv + win * ROWS * 3 * c + group * GROUP;
  for (int i = threadIdx.x; i < 2 * ROWS * (GROUP / 8); i += THREADS) {
    const int part = i / (ROWS * (GROUP / 8)), r = (i / (GROUP / 8)) % ROWS;
    const int col = 8 * (i % (GROUP / 8));
    cp_async16((part == 0 ? q_s : k_s) + r * QK_LD + col,
               src + (long long)r * 3 * c + part * c + col);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < ROWS * (GROUP / 2); i += THREADS) {
    const int r = i / (GROUP / 2), col = 2 * (i % (GROUP / 2));
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(src + (long long)r * 3 * c + 2 * c + col);
    vt_s[col * VT_LD + r] = v.x;
    vt_s[(col + 1) * VT_LD + r] = v.y;
  }
  cp_async_wait<0>();
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

template <int C>
int launch_mlp(const bf16* attn, const bf16* x, const bf16* wproj, const bf16* bproj,
               const bf16* g2, const bf16* b2, const bf16* wfc1, const bf16* bfc1,
               const bf16* wfc2, const bf16* bfc2, bf16* out, int bw, cudaStream_t stream) {
  constexpr int bytes = mlp_smem_bytes<C>();
  int err = set_smem(swin_mlp_bf16_kernel<C>, bytes);
  if (err) return err;
  swin_mlp_bf16_kernel<C><<<bw, 32 * mlp_warps<C>(), bytes, stream>>>(
      attn, x, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2, out);
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
  if (bw > 65535) return (int)cudaErrorInvalidValue;  // the proj GEMM's row tiles on gridDim.y
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = bw * ROWS;

  ln_rows_bf16_kernel<<<(m + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(x, g1, b1, a,
                                                                                   m, c);
  err = (int)cudaGetLastError();
  if (err) return err;

  using QkvTile = GemmTile<128, 128>;
  err = set_smem(gemm_bf16_kernel<128, 128>, QkvTile::SMEM_BYTES);
  if (err) return err;
  gemm_bf16_kernel<128, 128><<<dim3((3 * c + 127) / 128, (m + 127) / 128), THREADS,
                               QkvTile::SMEM_BYTES, s>>>(a, wqkv, bqkv, nullptr, qkv, m, 3 * c,
                                                         c);
  err = (int)cudaGetLastError();
  if (err) return err;

  err = set_smem(attention_from_qkv_bf16_kernel, ATTN_SMEM_BYTES);
  if (err) return err;
  attention_from_qkv_bf16_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS, ATTN_SMEM_BYTES,
                                   s>>>(qkv, bias, mask, mask_count, a, c,
                                        1.0f / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err) return err;

  using ProjTile = GemmTile<64, 128>;
  err = set_smem(gemm_bf16_kernel<64, 128>, ProjTile::SMEM_BYTES);
  if (err) return err;
  gemm_bf16_kernel<64, 128><<<dim3((c + 127) / 128, (m + 63) / 64), THREADS,
                              ProjTile::SMEM_BYTES, s>>>(a, wproj, bproj, x, out, m, c, c);
  return (int)cudaGetLastError();
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
  if (c != 96 && c != 192 && c != 384) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = core_smem_bytes(c);
  err = set_smem(window_core_bf16_kernel, smem);
  if (err) return err;
  window_core_bf16_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS, smem, s>>>(
      x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, c, 1.0f / sqrtf((float)HD));
  err = (int)cudaGetLastError();
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
