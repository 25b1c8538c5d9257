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
// row max. Everything is exact float32: FMA loops, no tensor cores, no TF32.
//
// What bounds it on the H100: for M = BW * 64 tokens the block does 24*M*C^2 + 4*M*64*C
// flops (qkv 6, proj 2, fc1 8, fc2 8 times M*C^2; q k^T and p v 4*M*64*C), the attention
// half 8*M*C^2 + 4*M*64*C, while it reads and writes only x, out and the weights: about 80
// flops per byte at C = 96, far above the 20 of float32 SIMT (67 TFLOP/s over 3.35 TB/s). So
// both are compute-bound.
//
// How it is laid out. The TPU kernel keeps a window's qkv [64, 3C] and MLP hidden layer
// [64, 4C] whole in VMEM; at C = 384 those are 288 KB and 384 KB, beyond a block's 227 KB of
// shared memory. So each TPU kernel becomes a short sequence of launches, every product of
// its body computed by a kernel written here:
// 1. window_attention_core_kernel, one block per (window, group of 4 heads): the LayerNorm
//    statistics of the window's 64 rows, then q, k and v of its 4 heads ([64, 96] each, LN1
//    applied as the rows are staged), kept in shared memory (75 KB); then attention with 4
//    threads per query row (16 keys each, row max and sum by warp shuffles, logits and
//    probabilities in registers); writes its heads' columns of attn [M, C]. Splitting heads
//    over blocks gives stage 4 (64 windows at a batch of 64) 512 blocks, not 64.
// 2. rowtile_gemm_kernel, one block per (64 rows, 96 columns) of out = epilogue(op(A) @ W +
//    b): op is the identity or a LayerNorm (statistics per block, applied as A is staged);
//    the epilogue adds a residual or applies GELU. It runs proj + residual (-> out, or x2
//    for the block), LN2 + fc1 + GELU (-> hidden [M, 4C]) and fc2 + residual (-> out).
// Every product stages a [64, 32] slab of A and a [32, 96] slab of W in shared memory (W is
// streamed from L2, where all blocks share it); each of 256 threads keeps a 4 x 6 register
// tile. The columns of q, k, v (3C, in 96-wide head groups), proj (C) and the MLP (4C) are
// all multiples of 96, and every depth (C, 4C) a multiple of 32, at every stage.
// The price of the split: attn, x2 and hidden go through device memory (at stage 1, batch
// 64: 100, 100 and 403 MB written and read once each, about 0.4 ms at 3.35 TB/s against a
// 0.96 ms compute bound). Keeping the hidden layer in shared memory in column chunks, and
// tensor cores with an FAD-delta check, are later work.
//
// The wrapper (ops/window_attn.py) checks shapes, types, devices and contiguity and
// allocates the output and the scratch; a CUDA tensor reaches these kernels or the wrapper
// raises, and there is no fallback to the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 64;               // tokens of an 8x8 window
constexpr int HD = 24;                // head_dim
constexpr int TM = 64;                // rows of a block tile
constexpr int TN = 96;                // columns of a block tile: 4 heads of 24
constexpr int TK = 32;                // depth of a staged slab
constexpr int RM = 4;                 // rows per thread
constexpr int CX = 16;                // threads across the columns of a tile
constexpr int RN = TN / CX;           // columns per thread
constexpr int A_LD = TK + 1;          // padded row stride of the staged A slab
constexpr int QKV_LD = TN + 1;        // padded row stride of the staged q, k, v
constexpr int HEADS_PER_BLOCK = TN / HD;
constexpr int KEYS_PER_THREAD = WIN / 4;
constexpr float LN_EPS = 1e-5f;

static_assert(THREADS / CX * RM == TM, "the register tiles cover the block tile's rows");
static_assert(THREADS == 4 * WIN, "four threads per query row");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two-pass LayerNorm statistics of rows [row0, row0 + TM) of a row-major [m, k] matrix: the
// mean and 1 / sqrt(var + eps) of each row, one warp per row. Rows at or past m get zeros.
__device__ __forceinline__ void row_stats(const float* __restrict__ a, long long m, int k,
                                          long long row0, float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TM; r += THREADS / 32) {
    float mean = 0.0f, rstd = 0.0f;
    if (row0 + r < m) {
      const float* p = a + (row0 + r) * k;
      float s = 0.0f;
      for (int c = lane; c < k; c += 32) s += p[c];
      mean = warp_sum(s) / k;
      float v = 0.0f;
      for (int c = lane; c < k; c += 32) {
        const float d = p[c] - mean;
        v = fmaf(d, d, v);
      }
      rstd = 1.0f / sqrtf(warp_sum(v) / k + LN_EPS);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

// acc += op(A)[row0 : row0 + TM, 0 : k] @ W[0 : k, col0 : col0 + TN], where A is row-major
// [m, k] (rows at or past m read as zero), W row-major [k, ldw], and op is the identity or,
// with LN, the LayerNorm (x - mean) * rstd * g + b of the row statistics in shared memory.
// Thread (ty, tx) owns rows ty*RM + i and columns tx + CX*j of the tile. k % TK == 0.
template <bool LN>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ a, long long m, int k,
                                          long long row0, const float* __restrict__ w, int ldw,
                                          int col0, const float* mean_s, const float* rstd_s,
                                          const float* __restrict__ g,
                                          const float* __restrict__ b, float* a_s, float* w_s,
                                          float (&acc)[RM][RN]) {
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  for (int k0 = 0; k0 < k; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      const int r = i / TK, kk = i % TK;
      float v = 0.0f;
      if (row0 + r < m) {
        v = a[(row0 + r) * k + k0 + kk];
        if (LN) v = (v - mean_s[r]) * rstd_s[r] * g[k0 + kk] + b[k0 + kk];
      }
      a_s[r * A_LD + kk] = v;
    }
    for (int i = threadIdx.x; i < TK * TN; i += THREADS) {
      const int kk = i / TN, c = i % TN;
      w_s[i] = w[(long long)(k0 + kk) * ldw + col0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float av[RM], wv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a_s[(ty * RM + i) * A_LD + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) wv[j] = w_s[kk * TN + tx + CX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// out[m, n] = epilogue(op(A)[m, k] @ W[k, n] + bias[n]); grid (ceil(m / TM), n / TN).
// LN: op is the LayerNorm with (ln_g, ln_b); GELU: exact erf GELU; RESID: + resid[m, n].
template <bool LN, bool GELU, bool RESID>
__global__ void __launch_bounds__(THREADS)
rowtile_gemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ ln_g,
                    const float* __restrict__ ln_b, const float* __restrict__ resid,
                    float* __restrict__ out, long long m, int k, int n) {
  __shared__ float a_s[TM * A_LD];
  __shared__ float w_s[TK * TN];
  __shared__ float mean_s[TM], rstd_s[TM];
  const long long row0 = (long long)blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  if (LN) {
    row_stats(a, m, k, row0, mean_s, rstd_s);
    __syncthreads();
  }
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
  }
  tile_gemm<LN>(a, m, k, row0, w, n, col0, mean_s, rstd_s, ln_g, ln_b, a_s, w_s, acc);
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long row = row0 + ty * RM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = col0 + tx + CX * j;
      float v = acc[i][j] + bias[col];
      if (GELU) v = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
      if (RESID) v += resid[row * n + col];
      out[row * n + col] = v;
    }
  }
}

constexpr size_t CORE_SMEM_FLOATS = 2 * TM + TM * A_LD + TK * TN + 3 * TM * QKV_LD;

// attn[w*64 + r, h*24 + d] for the window w = blockIdx.x and heads 4*blockIdx.y .. +3.
// x [bw*64, c]; wqkv [c, 3c]; bqkv [3c]; bias [heads, 64, 64]; mask [mask_count, 64, 64].
__global__ void __launch_bounds__(THREADS)
window_attention_core_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                             const float* __restrict__ bqkv, const float* __restrict__ bias,
                             const float* __restrict__ mask, int mask_count,
                             const float* __restrict__ g1, const float* __restrict__ b1,
                             float* __restrict__ attn, long long m, int c, float scale) {
  extern __shared__ float smem[];
  float* mean_s = smem;
  float* rstd_s = mean_s + TM;
  float* a_s = rstd_s + TM;
  float* w_s = a_s + TM * A_LD;
  float* qkv_s = w_s + TK * TN;  // q, k, v of this block's heads: [3][TM][QKV_LD]

  const long long win = blockIdx.x;
  const long long row0 = win * WIN;
  const int group = blockIdx.y;
  row_stats(x, m, c, row0, mean_s, rstd_s);
  __syncthreads();

  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  for (int part = 0; part < 3; ++part) {  // q, k, v
    const int col0 = part * c + group * TN;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    }
    tile_gemm<true>(x, m, c, row0, wqkv, 3 * c, col0, mean_s, rstd_s, g1, b1, a_s, w_s, acc);
    float* dst = qkv_s + part * TM * QKV_LD;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = tx + CX * j;
        dst[(ty * RM + i) * QKV_LD + col] = acc[i][j] + bqkv[col0 + col];
      }
    }
  }
  __syncthreads();

  // Attention: query row r, keys j = quarter + 4*jj (neighbouring quarters read neighbouring
  // rows of k and v, so their shared-memory banks differ).
  const int r = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const float* q_s = qkv_s;
  const float* k_s = qkv_s + TM * QKV_LD;
  const float* v_s = qkv_s + 2 * TM * QKV_LD;
  const float* mrow = mask + ((long long)(win % mask_count) * WIN + r) * WIN;
  for (int hh = 0; hh < HEADS_PER_BLOCK; ++hh) {
    const int h = group * HEADS_PER_BLOCK + hh;
    const int d0 = hh * HD;
    const float* brow = bias + ((long long)h * WIN + r) * WIN;
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = q_s[r * QKV_LD + d0 + d];
    float s[KEYS_PER_THREAD];
    float row_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) {
      const int j = quarter + 4 * jj;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(q[d], k_s[j * QKV_LD + d0 + d], dot);
      s[jj] = dot * scale + brow[j] + mrow[j];
      row_max = fmaxf(row_max, s[jj]);
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    float row_sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) {
      s[jj] = expf(s[jj] - row_max);
      row_sum += s[jj];
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    float o[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) {
      const int j = quarter + 4 * jj;
      const float p = s[jj] / row_sum;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = fmaf(p, v_s[j * QKV_LD + d0 + d], o[d]);
    }
    float* orow = attn + (row0 + r) * c + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[d] += __shfl_xor_sync(0xffffffffu, o[d], 1);
      o[d] += __shfl_xor_sync(0xffffffffu, o[d], 2);
      if ((d & 3) == quarter) orow[d] = o[d];
    }
  }
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
  const size_t smem = CORE_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(window_attention_core_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)HD);
  window_attention_core_kernel<<<dim3(bw, heads / HEADS_PER_BLOCK), THREADS, smem, stream>>>(
      x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, (long long)bw * WIN, c, scale);
  return (int)cudaGetLastError();
}

template <bool LN, bool GELU, bool RESID>
int launch_gemm(const float* a, const float* w, const float* bias, const float* ln_g,
                const float* ln_b, const float* resid, float* out, long long m, int k, int n,
                cudaStream_t stream) {
  const dim3 grid((unsigned)((m + TM - 1) / TM), n / TN);
  rowtile_gemm_kernel<LN, GELU, RESID><<<grid, THREADS, 0, stream>>>(
      a, w, bias, ln_g, ln_b, resid, out, m, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x + proj(attn(LN1(x))) into out [bw, 64, c]; attn [bw*64, c] is scratch. Launches on
// `stream` and returns the first cudaError_t (0 = ok; cudaErrorInvalidValue for shapes the
// kernels do not take). Does not synchronise and allocates nothing.
int window_attention_launch(const float* x, const float* wqkv, const float* bqkv,
                            const float* wproj, const float* bproj, const float* bias,
                            const float* mask, int mask_count, const float* g1, const float* b1,
                            float* attn, float* out, int bw, int c, int heads, void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = (long long)bw * WIN;
  err = launch_core(x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, bw, c, heads, s);
  if (err) return err;
  return launch_gemm<false, false, true>(attn, wproj, bproj, nullptr, nullptr, x, out, m, c, c, s);
}

// The whole block into out [bw, 64, c]; attn and x2 [bw*64, c] and hidden [bw*64, 4c] are
// scratch. Same conventions as window_attention_launch.
int swin_block_launch(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
                      const float* bproj, const float* bias, const float* mask, int mask_count,
                      const float* g1, const float* b1, const float* g2, const float* b2,
                      const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                      float* attn, float* x2, float* hidden, float* out, int bw, int c, int heads,
                      void* stream) {
  int err = check_args(bw, c, heads, mask_count);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long m = (long long)bw * WIN;
  err = launch_core(x, wqkv, bqkv, bias, mask, mask_count, g1, b1, attn, bw, c, heads, s);
  if (err) return err;
  err = launch_gemm<false, false, true>(attn, wproj, bproj, nullptr, nullptr, x, x2, m, c, c, s);
  if (err) return err;
  err = launch_gemm<true, true, false>(x2, wfc1, bfc1, g2, b2, nullptr, hidden, m, c, 4 * c, s);
  if (err) return err;
  return launch_gemm<false, false, true>(hidden, wfc2, bfc2, nullptr, nullptr, x2, out, m, 4 * c,
                                         c, s);
}

}  // extern "C"
