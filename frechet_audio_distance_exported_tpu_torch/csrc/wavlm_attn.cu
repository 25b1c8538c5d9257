// WavLM's gated relative-position self-attention, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no WavLM. It takes the place of five ATen passes
// over materialised [B * H, T, T] scores (baddbmm, addcmul_ of the gated bias, softmax, bmm, and
// the copies that split q, k and v by head and gather the heads' outputs) in each of the 24
// layers of models/wavlm.py. Per clip b and head h, over the layer's qkvg rows [B * T, 3C + 8H]
// (q at columns 64 h, k at C + 64 h, v at 2C + 64 h, the gate's 8 logits at 3C + 8 h; C = 64 H):
//     out[b, t, 64 h : 64 h + 64] = softmax_s(q_t . k_s / 8 + gate[b, h, t] * rel[h, s - t]) v
// with rel[h, r] = E[bucket(r), h] the relative-position bias (one [H, 2T - 1] table a forward:
// the entries of layer 0's [320, H] table that every layer reuses, not recomputed), and
// gate = a * (b' * c_h - 1) + 2, a and b' the sigmoids of the sums of the gate's logits 0-3 and
// 4-7 and c_h the layer's gru_rel_pos_const[h]. Head dim 64, float32 in and out.
//
// Arithmetic: both products (q k^T and p v) run on the tensor cores as 3xTF32, each float32
// operand split into hi = tf32(a) (rounded to nearest, as wgmma_tf32.cuh's split_tf32) and lo =
// a - hi, which the tensor core truncates to TF32 as it reads it (at most 2^-10 of lo, 2^-20 of
// a: one integer operation and one add fewer a value than rounding it, for all of k, v and p),
// a b formed as a_lo b_hi + a_hi b_lo + a_hi b_hi: about 2^-20 relative, where 1xTF32 is 2^-11.
// The tensor core truncates as it accumulates (PERF.md, §6), so each 32-deep part of a product
// goes into a fresh accumulator that a float32 add folds into the total, as the Swin kernels do.
// The scores, the running max and sum and the rescaling stay float32; the exponentials are
// ex2.approx (2^-22 relative) of scores taken in the log2 domain (q k^T / 8 * log2 e + gate *
// log2 e * rel). On an H100 the output is within 2.7e-6 of float64 on outputs of order 1, where
// 1xTF32 products miss by about 1e-3 (tests/test_torch_wavlm_attention.py).
//
// What bounds it on the H100: 4 T^2 64 flops a (clip, head), 65.3 GFLOP a layer at B = 64, T =
// 499, against 541 MB read and written (the qkvg rows once, the output once): 121 flops a byte,
// so operations at 3xTF32's 165 TFLOP/s, 0.396 ms a layer. Beside the products each score costs
// some twenty SIMT instructions (the bias, the exponential, the split of p) and each staged key
// and value a split; measured (PERF.md, §6), staging the keys and values was what held the
// products back. So the design keeps the scores on chip and the staging off the products' path:
// - A block of 512 threads takes one (clip, head, 128 query rows): two consumer warpgroups of 64
//   rows each, sharing the staged keys and values, so each key tile staged feeds 128 rows, and
//   two producer warpgroups that stage them (setmaxnreg: 40 registers for a producer, 216 for a
//   consumer).
// - Keys go in tiles of 64. One producer thread has TMA bring a tile's k and v rows ([64 rows,
//   64 values] boxes straight from the qkvg rows, no head-split copy) into one of two raw
//   buffers, two tiles ahead. The producers then split the tile into hi and lo in the layouts TF32
//   wgmma reads (both operands K-major, no transpose bit): k as [64 keys][64 d], v transposed as
//   [64 d][64 keys] with the keys of each 8 in the order 0 2 4 6 1 3 5 7, so that the S
//   accumulator of q k^T is p v's A fragment with no exchange (k-step index q takes key 2q, q + 4
//   takes key 2q + 1); beside it the tile's span of the relative table (192 values). Each
//   operand is two 32-deep slabs of [64][32] floats in TMA's 128-byte swizzle. Two split slots
//   form a ring tracked by mbarriers ("full" once the producers have split a tile into the
//   slot, "empty" once both consumers' products on it are retired), so the consumers never wait
//   on each other; the second consumer starts once the first has its first scores, so that one's
//   softmax tends to run while the other's products do.
// - A consumer keeps q in registers as wgmma A fragments, split once (64 registers). Per tile:
//   S = q k^T (m64n64k8, 2 x 12 wgmmas into two accumulators), the gated bias, the online
//   softmax (running max and a per-thread partial sum, the output accumulator rescaled as each
//   tile arrives), and O += P v in two 32-key halves, each in a fresh accumulator folded into O;
//   the second half's exponentials run while the first half's products do.
// - Ragged edges: keys past T are zero in the staged tiles and -inf in the scores; query rows
//   past T read zero q and a zero gate and are not stored. Any T >= 1 and any B; no T x T memory.
// The output [B * T, C] has head h at columns 64 h: the layout the proj GEMM reads.
//
// The wrapper (ops/wavlm_attn.py) checks types, devices, shapes, contiguity and alignment, and
// allocates the output; a CUDA tensor reaches this kernel or the wrapper raises, and there is no
// fallback to ATen.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

using hopper::tf32::mma_rs;

// a = hi + lo: hi = tf32(a) rounded as split_tf32 rounds it, lo = a - hi left for the tensor
// core to truncate (the header's note on the arithmetic).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

constexpr int HD = 64;               // head dim
constexpr int GATE = 8;              // gate logits a head
constexpr int BQ = 128;              // query rows a block: two consumer warpgroups of 64
constexpr int BK = 64;               // keys a tile
constexpr int CONSUMERS = 2;
constexpr int PRODUCERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + PRODUCERS);  // the consumers, then the producers
constexpr int PT = 128 * PRODUCERS;  // producer threads
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 216;   // 2 * 128 * 216 + 2 * 128 * 40 = 512 * 128: the launch's
constexpr int PRODUCER_BARRIER = 1;  // the producers' named barrier
constexpr int START_BARRIER = 2;     // the second consumer's start
constexpr int SPAN = BQ + BK;        // relative offsets a [BQ, BK] tile spans (191), staged 192
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE_LOG2 = 0.125f * LOG2E;  // head_dim^-1/2 in the log2 domain

// Shared memory, in bytes from a 1024-byte boundary (the swizzle's atom). A slab is [64][32]
// floats, 128 bytes a row; an operand two slabs (d 0-31 and 32-63 for k, keys 0-31 and 32-63
// for v^T); a split slot k hi, k lo, v^T hi, v^T lo and the tile's span of rel.
constexpr int SLAB = 64 * 128;
constexpr int OPERAND = 2 * SLAB;
constexpr int K_HI = 0, K_LO = OPERAND, V_HI = 2 * OPERAND, V_LO = 3 * OPERAND;
constexpr int SLOT_SPAN = 4 * OPERAND;
constexpr int SLOT_BYTES = SLOT_SPAN + 1024;             // 65 KB: the span padded to 1024
constexpr int RAW = 2 * SLOT_BYTES;                      // two raw tiles: k [64][64], then v
constexpr int RAW_BYTES = 2 * BK * HD * 4;
constexpr int BARRIERS = RAW + 2 * RAW_BYTES;            // full[2], empty[2], raw_full[2]
constexpr int SMEM = 1024 + BARRIERS + 6 * 8;            // with the alignment's slack

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint4 split4(float4 v, uint4& lo) {
  uint4 hi;
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
  return hi;
}

// Block (tile, h, b) = blockIdx.x as tile + q_tiles (h + heads b): query rows 128 tile .. +127
// of clip b, head h. qkvg [batch * t_len, 3C + 8H] and out [batch * t_len, C] row-major, C = 64
// heads; rel [heads, 2 t_len - 1] (rel[h, r + t_len - 1] the bias of s - t = r); gate_const
// [heads].
__global__ void __launch_bounds__(THREADS, 1)
wavlm_attention_kernel(const __grid_constant__ CUtensorMap tq, const float* __restrict__ qkvg,
                       const float* __restrict__ rel,
                       const float* __restrict__ gate_const, float* __restrict__ out, int t_len,
                       int heads, int q_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = hopper::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((raw_addr + 1023) / 1024 * 1024 - raw_addr);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARRIERS);
  uint64_t* empty = full + 2;
  uint64_t* raw_full = full + 4;
  const int tile = blockIdx.x % q_tiles;
  const int h = (blockIdx.x / q_tiles) % heads;
  const long long b = blockIdx.x / q_tiles / heads;
  const int c = heads * HD, ld = 3 * c + GATE * heads;
  const float* rows = qkvg + b * t_len * ld;
  const int t0 = tile * BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = (t_len + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(full + s, PT);          // every producer thread
      hopper::mbar_init(empty + s, 4 * CONSUMERS);  // each consumer warp's lane 0
      hopper::mbar_init(raw_full + s, 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg >= CONSUMERS) {
    // ---- the producers ----
    hopper::regs_dec<PRODUCER_REGS>();
    const int ptid = threadIdx.x - 128 * CONSUMERS;
    const float* rel_h = rel + (long long)h * (2LL * t_len - 1);
    // TMA of key tile kt's k and v rows into raw buffer kt % 2: boxes of [64 rows, 64 values]
    // from the qkvg rows (rows past the clip are split as zeros, past the tensor read as zero).
    auto fetch = [&](int kt) {
      if (kt < n_tiles && ptid == 0) {
        unsigned char* raw = smem + RAW + (kt & 1) * RAW_BYTES;
        hopper::mbar_arrive_expect_tx(raw_full + (kt & 1), RAW_BYTES);
        const int row = (int)(b * t_len) + kt * BK;
        hopper::tma_load_2d(raw, &tq, c + HD * h, row, raw_full + (kt & 1));
        hopper::tma_load_2d(raw + BK * HD * 4, &tq, 2 * c + HD * h, row, raw_full + (kt & 1));
      }
    };
    fetch(0);
    fetch(1);
#pragma unroll 1
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int slot = kt & 1;
      const uint32_t parity = (kt >> 1) & 1;
      // This tile's span of rel: span[i] = rel[h, s0 - t0 - (BQ - 1) + i] (0 outside the table).
      float span_v = 0.0f;
      if (ptid < SPAN) {
        const long long idx = (long long)kt * BK - t0 - (BQ - 1) + t_len - 1 + ptid;
        if (idx >= 0 && idx < 2LL * t_len - 1) span_v = rel_h[idx];
      }
      hopper::mbar_wait(raw_full + slot, parity);     // the tile's raw rows
      hopper::mbar_wait(empty + slot, parity ^ 1);   // the slot's last tile retired
      const float* raw = reinterpret_cast<const float*>(smem + RAW + slot * RAW_BYTES);
      unsigned char* dst = smem + slot * SLOT_BYTES;
      const int valid = t_len - kt * BK;  // keys of the tile that exist
      // k [key][d], hi and lo: each 16-byte chunk cc of row n at chunk cc ^ (n % 8). Eight
      // neighbouring threads read one 128-byte row of raw k and write eight distinct chunks.
#pragma unroll 2
      for (int i = ptid; i < BK * 16; i += PT) {
        const int n = i / 16, sl = i / 8 % 2, cc = i % 8;
        const float4 v = n < valid
            ? *reinterpret_cast<const float4*>(raw + n * HD + 32 * sl + 4 * cc)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        uint4 lo;
        const uint4 hi = split4(v, lo);
        const int off = sl * SLAB + n * 128 + ((cc ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(dst + K_HI + off) = hi;
        *reinterpret_cast<uint4*>(dst + K_LO + off) = lo;
      }
      // v^T [d][key, permuted]: chunk cc of row d holds keys key0, +2, +4, +6. A warp reads one
      // row of raw v (32 neighbouring d) and writes eight distinct chunk positions a quarter.
      const float* raw_v = raw + BK * HD;
#pragma unroll 2
      for (int i = ptid; i < HD * 16; i += PT) {
        const int d = i % HD, sl = i / HD % 2, cc = i / (2 * HD);
        const int key0 = 32 * sl + 8 * (cc >> 1) + (cc & 1);
        float4 v;
        v.x = key0 < valid ? raw_v[key0 * HD + d] : 0.0f;
        v.y = key0 + 2 < valid ? raw_v[(key0 + 2) * HD + d] : 0.0f;
        v.z = key0 + 4 < valid ? raw_v[(key0 + 4) * HD + d] : 0.0f;
        v.w = key0 + 6 < valid ? raw_v[(key0 + 6) * HD + d] : 0.0f;
        uint4 lo;
        const uint4 hi = split4(v, lo);
        const int off = sl * SLAB + d * 128 + ((cc ^ (d & 7)) << 4);
        *reinterpret_cast<uint4*>(dst + V_HI + off) = hi;
        *reinterpret_cast<uint4*>(dst + V_LO + off) = lo;
      }
      if (ptid < SPAN) reinterpret_cast<float*>(dst + SLOT_SPAN)[ptid] = span_v;
      hopper::fence_proxy_async();  // the writes, before wgmma reads them
      hopper::mbar_arrive(full + slot);
      hopper::named_barrier(PRODUCER_BARRIER, PT);  // raw buffer kt % 2 read by all
      fetch(kt + 2);
    }
    return;
  }

  // ---- a consumer: query rows 64 wg .. 64 wg + 63 of the tile ----
  hopper::regs_inc<CONSUMER_REGS>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int row0 = 64 * wg + 16 * warp + g;  // this thread's rows of the tile: row0, row0 + 8

  // q as wgmma A fragments (k-step kk: columns 8 kk + q and 8 kk + q + 4 of rows row0 and
  // row0 + 8), split once, and the gate of both rows in the log2 domain. Rows past t_len: 0.
  uint32_t qhi[HD / 8][4], qlo[HD / 8][4];
  float gate_log2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + row0 + 8 * hh;
    const float* row = rows + (long long)(t < t_len ? t : 0) * ld;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = t < t_len ? row[HD * h + 8 * kk + q + 4 * u] : 0.0f;
        split_tf32(v, qhi[kk][hh + 2 * u], qlo[kk][hh + 2 * u]);
      }
    }
    float gate = 0.0f;
    if (t < t_len) {
      const float4* logits = reinterpret_cast<const float4*>(row + 3 * c + GATE * h);
      const float4 x = logits[0], y = logits[1];
      const float ga = 1.0f / (1.0f + expf(-(((x.x + x.y) + x.z) + x.w)));
      const float gb = 1.0f / (1.0f + expf(-(((y.x + y.y) + y.z) + y.w)));
      gate = ga * (gb * gate_const[h] - 1.0f) + 2.0f;
    }
    gate_log2[hh] = gate * LOG2E;
  }

  // The output accumulator, the scores of d 0-31 and 32-63, and a fresh accumulator for p v.
  float o[HD / 2] = {}, s[HD / 2] = {}, s2[HD / 2] = {}, part[HD / 2] = {};
  float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.0f, 0.0f};
  // span[col - row + BQ - 1] is the bias of (row, col): this thread's rows' base offsets.
  const int span_off = 2 * q - row0 + BQ - 1;

  if (wg == 1) hopper::named_barrier(START_BARRIER, 128 * CONSUMERS);  // after 0's first S
#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int slot = kt & 1;
    hopper::mbar_wait(full + slot, (kt >> 1) & 1);
    const unsigned char* tile_base = smem + slot * SLOT_BYTES;

    // S = q k^T, d 0-31 into s and d 32-63 into s2 (each 12 wgmmas, the small terms first).
    hopper::fence_regs(s);
    hopper::fence_regs(s2);
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<64>(s, qlo[kk], hopper::desc_a_sw128(tile_base + K_HI, kk), kk > 0);
      mma_rs<64>(s, qhi[kk], hopper::desc_a_sw128(tile_base + K_LO, kk), 1);
      mma_rs<64>(s, qhi[kk], hopper::desc_a_sw128(tile_base + K_HI, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<64>(s2, qlo[4 + kk], hopper::desc_a_sw128(tile_base + K_HI + SLAB, kk), kk > 0);
      mma_rs<64>(s2, qhi[4 + kk], hopper::desc_a_sw128(tile_base + K_LO + SLAB, kk), 1);
      mma_rs<64>(s2, qhi[4 + kk], hopper::desc_a_sw128(tile_base + K_HI + SLAB, kk), 1);
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(s2);
    if (wg == 0 && kt == 0) named_arrive(START_BARRIER, 128 * CONSUMERS);

    // Scores in the log2 domain with the gated bias, masked past t_len; the online softmax.
    const float* span = reinterpret_cast<const float*>(tile_base + SLOT_SPAN) + span_off;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      const int j = i / 4, hh = (i >> 1) & 1, e = i & 1;  // column 8 j + 2 q + e, row + 8 hh
      s[i] = fmaf(s[i] + s2[i], SCALE_LOG2, gate_log2[hh] * span[8 * j + e - 8 * hh]);
    }
    const int valid = t_len - kt * BK;
    if (valid < BK) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        if (8 * (i / 4) + 2 * q + (i & 1) >= valid) s[i] = -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = run_max[hh];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        m = fmaxf(m, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      corr[hh] = exp2_approx(run_max[hh] - m);  // 0 at the first tile
      run_max[hh] = m;
      run_sum[hh] *= corr[hh];
    }
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {  // keys 0-31 now, 32-63 while their p v runs
      const int hh = (i >> 1) & 1;
      s[i] = exp2_approx(s[i] - run_max[hh]);
      run_sum[hh] += s[i];
    }

    // O = O * corr + P v, keys 0-31 then 32-63, each in a fresh accumulator. The k-step j takes
    // keys 8 j + 2 q (k index q) and 8 j + 2 q + 1 (k index q + 4): the A fragment is
    // (s[4j], s[4j + 2], s[4j + 1], s[4j + 3]).
    uint32_t phi[BK / 8][4], plo[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      split_tf32(s[4 * j], phi[j][0], plo[j][0]);
      split_tf32(s[4 * j + 2], phi[j][1], plo[j][1]);
      split_tf32(s[4 * j + 1], phi[j][2], plo[j][2]);
      split_tf32(s[4 * j + 3], phi[j][3], plo[j][3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      hopper::fence_regs(part);
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 4 * half + kk;
        const unsigned char* v_hi = tile_base + V_HI + half * SLAB;
        const unsigned char* v_lo = tile_base + V_LO + half * SLAB;
        mma_rs<64>(part, plo[j], hopper::desc_a_sw128(v_hi, kk), kk > 0);
        mma_rs<64>(part, phi[j], hopper::desc_a_sw128(v_lo, kk), 1);
        mma_rs<64>(part, phi[j], hopper::desc_a_sw128(v_hi, kk), 1);
      }
      hopper::commit();
      if (half == 0) {  // the second half's fragments while the first half runs
#pragma unroll
        for (int i = HD / 4; i < HD / 2; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = exp2_approx(s[i] - run_max[hh]);
          run_sum[hh] += s[i];
        }
#pragma unroll
        for (int j = BK / 16; j < BK / 8; ++j) {
          split_tf32(s[4 * j], phi[j][0], plo[j][0]);
          split_tf32(s[4 * j + 2], phi[j][1], plo[j][1]);
          split_tf32(s[4 * j + 1], phi[j][2], plo[j][2]);
          split_tf32(s[4 * j + 3], phi[j][3], plo[j][3]);
        }
      }
      hopper::wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::tf32::fence_frag(phi[4 * half + kk]);
        hopper::tf32::fence_frag(plo[4 * half + kk]);
      }
      if (half == 1 && lane == 0) hopper::mbar_arrive(empty + slot);  // the slot is read
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        o[i] = half == 0 ? fmaf(o[i], corr[(i >> 1) & 1], part[i]) : o[i] + part[i];
      }
    }
  }

  // The row sums across the four threads of each row, then out = O / sum, rows < t_len only.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    run_sum[hh] += __shfl_xor_sync(0xffffffffu, run_sum[hh], 1);
    run_sum[hh] += __shfl_xor_sync(0xffffffffu, run_sum[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + row0 + 8 * hh;
    if (t < t_len) {
      const float inv = 1.0f / run_sum[hh];
      float* dst = out + (b * t_len + t) * c + HD * h + 2 * q;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
      }
    }
  }
}

}  // namespace

// cuTensorMapEncodeTiled, reached through the runtime: the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

extern "C" {

// out [batch * t_len, 64 heads] = the gated relative-position attention of qkvg [batch * t_len,
// 3C + 8 heads] (C = 64 heads) with rel [heads, 2 t_len - 1] and gate_const [heads], all float32,
// contiguous, 16-byte aligned. One launch on `stream`; returns the cudaError_t (0 = ok;
// cudaErrorInvalidValue for sizes it does not take: TMA's row coordinate is 32-bit). Does not
// synchronise and allocates nothing.
int wavlm_attention_launch(const float* qkvg, const float* rel, const float* gate_const,
                           float* out, int batch, int t_len, int heads, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || (long long)batch * t_len > INT_MAX / 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int q_tiles = (t_len + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * heads * batch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const int e = (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                               &found);
    if (e || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return e ? e : (int)cudaErrorSymbolNotFound;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const long long ld = 3LL * heads * HD + GATE * heads;
  CUtensorMap tq;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)batch * t_len};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {HD, BK}, unit[2] = {1, 1};
  const CUresult res = encode(&tq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(qkvg),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(wavlm_attention_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  wavlm_attention_kernel<<<(unsigned)blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, qkvg, rel, gate_const, out, t_len, heads, q_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
