// GroupNorm(1, C) forward as a pair of hand-written CUDA kernels for Hopper
// (sm_90a): the norm after each of the 18 convolutions of the 48 kHz Encodec,
// with the passes around it folded in.
//
// Replaces no Pallas kernel: the JAX package leaves this op to XLA
// (frechet_audio_distance_exported_tpu/models/common.py:100,
// group_norm_full: a one-pass (sum x, sum x^2) that XLA fuses into one read).
// The port ran it on ATen's nn.GroupNorm, whose moments kernel reduces each
// of the B rows with one block: at B = 64, 64 blocks on 132 SMs, each walking
// up to 15.4 M elements alone.
//
// Function, for a conv's output y [B, C, T] without its bias beta'_c, and
// each row b (one clip, N = C*T elements):
//   x        = y + beta'_c                   (rounded to x's type, as ATen's
//                                             add_ of the bias rounds it;
//                                             no beta': x = y)
//   K        = x[b, 0, 0]                    (a shift, so that the float32
//                                             sums do not hold mean^2)
//   s1, s2   = sum (x - K), sum (x - K)^2    (float32 within a thread,
//                                             float64 from there on)
//   mean     = K + s1/N,  var = max(s2/N - (s1/N)^2, 0),  rstd = 1/sqrt(var + eps)
//   a_c, b_c = gamma_c * rstd,  beta_c - mean * a_c   (float64, rounded once
//                                                      to float32)
//   g        = x * a_c + b_c                  (one float32 fma, rounded to x's type)
// ops/group_norm.py's group_norm_reference computes the norm in float64.
//
// The apply writes g in the form its consumer reads (FORM), so that between
// two convolutions a tensor is read by the moments, read and written by the
// apply, and touched by nothing else:
//   PLAIN     g                                    (the LSTM's input, the output)
//   ELU       pad(elu(g), l, r)                    (conv1's norm: conv2 reads it)
//   SPLIT     g and pad(elu(g), l, r)              (a stage's input: the shortcut
//                                                   reads g, conv1 the padded ELU)
//   RESIDUAL  pad(elu(g + g2), l, r)               (conv2's norm and the shortcut's,
//                                                   two rows with their own moments
//                                                   and affines: the strided conv
//                                                   reads it)
// where pad reflects l and r elements into a contiguous [B, C, l + T + r] and
// elu(v) = v > 0 ? v : expm1f(v). Each step is rounded to x's type where
// ATen's composition (conv with bias, this norm, +, F.elu, F.pad) rounds it,
// so in float32 the result is that composition's to the bit. The 24 kHz
// Encodec has no norm, so no pass to fold its bias adds, ELUs, adds and pads
// into: it keeps ATen's chain (models/encodec.py).
//
// What bounds it on the H100: bytes. The 18 normalised tensors of a 64-clip
// chunk hold 37.4 GB (float32). The moments read them once, the apply reads
// and writes them: 112 GB, 33.5 ms at 3.35 TB/s, with the bias add, ELU, the
// residual add and the reflect pad in the same passes (ATen's four passes
// over the same tensors moved about 203 GB more). A handful of flops an
// element (expm1f where the sum is negative). The 14 applies and 18 moments
// of a chunk take 43-44 ms on an H100, 76-78 % of that bound.
//
// What the design does about it:
// - group_norm_moments_kernel splits every row over gridDim.x blocks
//   (the wrapper picks the splits from B, N and this kernel's occupancy: a
//   few full waves on every SM at every shape). A block reads its contiguous
//   slice with 16-byte loads, four in flight a thread, adds the conv's bias
//   from a table of its channels in shared memory, sums in float32 a thread
//   and in float64 across the block, and writes one float64 (s1, s2) to
//   partial[b, split]. No atomics: the order of every sum is fixed, so a
//   result is the same bits from run to run.
// - group_norm_apply_kernel runs on a grid of its own, picked the same way
//   from the occupancy of the form it runs (the forms hold more registers
//   than the moments), so no form's registers change how the moments
//   split a row, and with it their sums. Each block first reduces its
//   row's partials in a fixed order (one warp a norm), so no third launch
//   turns them into mean and rstd; it builds (a_c, b_c, beta'_c) for
//   the channels its slice spans in shared memory, then reads with 16-byte
//   loads. g and an unpadded ELU go out as 16-byte stores. A padded row
//   starts l elements into each channel, so its 16-byte vectors do not line
//   up with the input's: each warp passes its 32 vectors through shared
//   memory and writes them as 32 consecutive elements a store, and the
//   thread that writes element j of a channel also writes its reflections
//   (j in 1..l to the left edge, j in T-1-r..T-2 to the right one).
// - Channels are found by a multiply and a shift (Divisor), not a division.
// - A slice's ragged ends (where C*T is no multiple of the vector) are read
//   element by element; the wrapper checks that y starts on 16 bytes.
// - float and bf16 instances: the sums and coefficients are the same, bf16
//   is unpacked to float on load and rounded to nearest even where ATen's
//   bf16 ops round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread

// The apply's forms (ops/group_norm.py's FORMS, in order), and the moments
// kernel where group_norm_blocks_per_sm names a kernel.
constexpr int PLAIN = 0, ELU = 1, SPLIT = 2, RESIDUAL = 3, MOMENTS = -1;

// 16 bytes of T as V floats.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[V]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[V]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float to_float(float v) { return v; }
  __device__ __forceinline__ static float from_float(float v) { return v; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ __forceinline__ static float2 pair(unsigned int w) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned int*>(&h) = w;
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static unsigned int word(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned int*>(&h);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&v)[V]) {
    const float2 a = pair(r.x), b = pair(r.y), c = pair(r.z), d = pair(r.w);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[V]) {
    return make_uint4(word(v[0], v[1]), word(v[2], v[3]), word(v[4], v[5]), word(v[6], v[7]));
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  // v rounded to bf16 and back: where ATen's bf16 op would store its result.
  __device__ __forceinline__ static float round(float v) { return to_float(from_float(v)); }
};

// e / t for 0 <= e < 2^31 as (e * mul) >> shift, with shift = 31 + ceil(log2 t)
// and mul = ceil(2^shift / t) < 2^32 (ops/group_norm.py's divisor(), where
// a test holds it to e // t).
struct Divisor {
  unsigned int mul;
  int shift;
  __device__ __forceinline__ unsigned int operator()(unsigned int e) const {
    return static_cast<unsigned int>((static_cast<unsigned long long>(e) * mul) >> shift);
  }
};

// Block (blockIdx.x, blockIdx.y) of a row of n elements: row elements
// [lo, hi), of which [lo, lo + head) and [vend, hi) are read one by one and
// the nvec vectors from lo + head on, 16 bytes each. Global element g is
// 16-byte aligned where g % V == 0, y itself being aligned.
struct Slice {
  long long lo, hi, vend, nvec;
  int head;
};

template <int V>
__device__ __forceinline__ Slice slice_of(long long n, long long chunk) {
  Slice s;
  s.lo = blockIdx.x * chunk;
  s.hi = min(n, s.lo + chunk);
  const long long g0 = static_cast<long long>(blockIdx.y) * n + s.lo;
  s.head = static_cast<int>(min(static_cast<long long>((V - g0 % V) % V), s.hi - s.lo));
  s.nvec = (s.hi - s.lo - s.head) / V;
  s.vend = s.lo + s.head + s.nvec * V;
  return s;
}

// x[b, 0, 0] of a row: its first element plus the conv's bias of channel 0.
template <typename T>
__device__ __forceinline__ float first_of(const T* row, const T* conv_bias) {
  using P = Pack<T>;
  const float y = P::to_float(row[0]);
  return conv_bias ? P::round(y + P::to_float(conv_bias[0])) : y;
}

// The conv's bias added to the V elements from row element e on (channel
// c = e / t or later), from bias, the table of the slice's channels from c0.
template <typename T>
__device__ __forceinline__ void add_bias(float (&v)[Pack<T>::V], unsigned int e, unsigned int t,
                                         Divisor channel, const float* bias) {
  using P = Pack<T>;
  constexpr int V = P::V;
  const unsigned int c = channel(e);
  if (e - c * t + V <= t) {  // the whole vector in channel c
    const float b = bias[c];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = P::round(v[j] + b);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = P::round(v[j] + bias[channel(e + j)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_moments_kernel(const T* __restrict__ x, const T* __restrict__ conv_bias, long long n,
                          int t, Divisor channel, long long chunk, int splits,
                          double* __restrict__ partial) {
  using P = Pack<T>;
  constexpr int V = P::V;
  extern __shared__ float4 bias_table[];
  const T* row = x + static_cast<long long>(blockIdx.y) * n;
  const Slice s = slice_of<V>(n, chunk);
  const int tid = threadIdx.x;
  const unsigned int ut = static_cast<unsigned int>(t);
  const unsigned int c0 = static_cast<unsigned int>(s.lo) / ut;

  // The conv's bias of the channels this slice spans (bias[c] for c from c0).
  float* table = reinterpret_cast<float*>(bias_table);
  const float* bias = table - c0;
  if (conv_bias) {
    const unsigned int c1 = static_cast<unsigned int>(s.hi - 1) / ut;
    for (unsigned int c = c0 + tid; c <= c1; c += THREADS) {
      table[c - c0] = P::to_float(conv_bias[c]);
    }
    __syncthreads();
  }
  const float shift = first_of(row, conv_bias);
  auto value = [&](long long e) {
    const float y = P::to_float(row[e]);
    return conv_bias ? P::round(y + bias[channel(static_cast<unsigned int>(e))]) : y;
  };

  // One (s1, s2) pair per unrolled load, so four chains of float32 adds.
  float s1[UNROLL] = {}, s2[UNROLL] = {};
  if (tid < s.head) {
    const float d = value(s.lo + tid) - shift;
    s1[0] += d;
    s2[0] += d * d;
  }
  if (tid < s.hi - s.vend) {
    const float d = value(s.vend + tid) - shift;
    s1[1] += d;
    s2[1] += d * d;
  }
  const long long first = s.lo + s.head;
  const typename P::Raw* vec = reinterpret_cast<const typename P::Raw*>(row + first);
  auto load = [&](long long i, const typename P::Raw& raw, float (&v)[V]) {
    P::unpack(raw, v);
    if (conv_bias) add_bias<T>(v, static_cast<unsigned int>(first + i * V), ut, channel, bias);
  };
  long long i = tid;
  for (; i + (UNROLL - 1) * THREADS < s.nvec; i += UNROLL * THREADS) {
    typename P::Raw raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(vec + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[V];
      load(i + u * THREADS, raw[u], v);
      float a = 0.f, q = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - shift;
        a += d;
        q = fmaf(d, d, q);
      }
      s1[u] += a;
      s2[u] += q;
    }
  }
  for (; i < s.nvec; i += THREADS) {
    float v[V];
    load(i, __ldg(vec + i), v);
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - shift;
      a += d;
      q = fmaf(d, d, q);
    }
    s1[0] += a;
    s2[0] += q;
  }

  // The block's sums in float64, in a fixed order: the warps' shuffle
  // trees, then warp by warp.
  double t1 = (static_cast<double>(s1[0]) + s1[1]) + (static_cast<double>(s1[2]) + s1[3]);
  double t2 = (static_cast<double>(s2[0]) + s2[1]) + (static_cast<double>(s2[2]) + s2[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t1 += __shfl_down_sync(0xffffffffu, t1, off);
    t2 += __shfl_down_sync(0xffffffffu, t2, off);
  }
  __shared__ double red[2][WARPS];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red[0][warp] = t1;
    red[1][warp] = t2;
  }
  __syncthreads();
  if (tid == 0) {
    double a = 0.0, q = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += red[0][w];
      q += red[1][w];
    }
    double* out = partial + 2 * (static_cast<long long>(blockIdx.y) * splits + blockIdx.x);
    out[0] = a;
    out[1] = q;
  }
}

// One norm the apply reads: the conv's output (without its bias where
// conv_bias is set), that bias, the norm's affine, its moments' partials
// [B, splits, 2] and eps.
template <typename T>
struct NormIn {
  const T* y;
  const T* conv_bias;
  const T* gamma;
  const T* beta;
  const double* partial;
  double eps;
};

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

template <typename T, int FORM>
__global__ void __launch_bounds__(THREADS)
group_norm_apply_kernel(NormIn<T> in0, NormIn<T> in1, T* __restrict__ raw, T* __restrict__ act,
                        int left, int right, long long n, int t, Divisor channel, long long chunk,
                        int width, int parts) {
  using P = Pack<T>;
  using Raw = typename P::Raw;
  constexpr int V = P::V;
  constexpr int NORMS = FORM == RESIDUAL ? 2 : 1;
  constexpr bool RAW = FORM == PLAIN || FORM == SPLIT;
  constexpr bool ACT = FORM != PLAIN;
  // (a_c, b_c, beta'_c) of the slice's channels, norm by norm, width apart.
  extern __shared__ float4 table[];
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const Slice s = slice_of<V>(n, chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned int ut = static_cast<unsigned int>(t);

  // 1. Each row's mean and rstd from the moments' parts partials, in a
  //    fixed order (warp k for norm k), whatever the apply's own grid.
  __shared__ double stats[2][2];
  if (warp < NORMS) {
    const double* p =
        (warp ? in1.partial : in0.partial) + 2 * static_cast<long long>(blockIdx.y) * parts;
    double a = 0.0, q = 0.0;
    for (int k = lane; k < parts; k += 32) {
      a += p[2 * k];
      q += p[2 * k + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      const float shift = warp ? first_of(in1.y + base, in1.conv_bias)
                               : first_of(in0.y + base, in0.conv_bias);
      const double m1 = a / static_cast<double>(n);
      const double var = fmax(q / static_cast<double>(n) - m1 * m1, 0.0);
      stats[warp][0] = static_cast<double>(shift) + m1;
      stats[warp][1] = 1.0 / sqrt(var + (warp ? in1.eps : in0.eps));
    }
  }
  __syncthreads();

  // 2. (a_c, b_c, beta'_c) of the channels this slice spans.
  const unsigned int c0 = static_cast<unsigned int>(s.lo) / ut;
  const unsigned int c1 = static_cast<unsigned int>(s.hi - 1) / ut;
#pragma unroll
  for (int k = 0; k < NORMS; ++k) {
    const NormIn<T>& nk = k ? in1 : in0;
    for (unsigned int c = c0 + tid; c <= c1; c += THREADS) {
      const double a = static_cast<double>(P::to_float(nk.gamma[c])) * stats[k][1];
      const double b = static_cast<double>(P::to_float(nk.beta[c])) - stats[k][0] * a;
      const float cb = nk.conv_bias ? P::to_float(nk.conv_bias[c]) : 0.f;
      table[k * width + c - c0] =
          make_float4(static_cast<float>(a), static_cast<float>(b), cb, 0.f);
    }
  }
  __syncthreads();

  // 3. g = x * a_c + b_c with x = y + beta'_c, of norm k at row element e
  //    (one_norm) or the V elements from e on (norm_vec).
  auto one_norm = [&](const NormIn<T>& nk, int k, float v, unsigned int e) {
    const float4 ab = table[k * width + channel(e) - c0];
    if (nk.conv_bias) v = P::round(v + ab.z);
    return P::round(fmaf(v, ab.x, ab.y));
  };
  auto norm_vec = [&](const NormIn<T>& nk, int k, float (&v)[V], unsigned int e) {
    const float4* tab = table + k * width - c0;
    const bool biased = nk.conv_bias != nullptr;
    const unsigned int c = channel(e);
    if (e - c * ut + V <= ut) {  // the whole vector in channel c
      const float4 ab = tab[c];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = biased ? P::round(v[j] + ab.z) : v[j];
        v[j] = P::round(fmaf(x, ab.x, ab.y));
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 ab = tab[channel(e + j)];
        const float x = biased ? P::round(v[j] + ab.z) : v[j];
        v[j] = P::round(fmaf(x, ab.x, ab.y));
      }
    }
  };

  // The act row [C, left + t + right]: row element e, in channel c at j,
  // goes to c's left + j, and to its reflections where it has them.
  const long long tp = static_cast<long long>(t) + left + right;
  T* act_row = ACT ? act + static_cast<long long>(blockIdx.y) * (n / t) * tp : nullptr;
  auto emit = [&](unsigned int e, float v) {
    const unsigned int c = channel(e);
    const int j = static_cast<int>(e - c * ut);
    T* ch = act_row + static_cast<long long>(c) * tp + left;
    const T h = P::from_float(v);
    ch[j] = h;
    if (j >= 1 && j <= left) ch[-j] = h;
    if (j <= t - 2 && j >= t - 1 - right) ch[2 * (t - 1) - j] = h;
  };
  const bool padded = left != 0 || right != 0;

  // Ragged ends, one element a thread.
  auto one = [&](long long e) {
    const unsigned int ue = static_cast<unsigned int>(e);
    float g = one_norm(in0, 0, P::to_float(in0.y[base + e]), ue);
    if constexpr (FORM == RESIDUAL) {
      g = P::round(g + one_norm(in1, 1, P::to_float(in1.y[base + e]), ue));
    }
    if constexpr (RAW) raw[base + e] = P::from_float(g);
    if constexpr (ACT) emit(ue, P::round(elu(g)));
  };
  if (tid < s.head) one(s.lo + tid);
  if (tid < s.hi - s.vend) one(s.vend + tid);

  // The vectors: warp w takes 32 neighbouring vectors at a time, so that a
  // padded row can be written through the warp's staging buffer.
  __shared__ float4 staging[ACT ? WARPS : 1][8 * V];  // 32 * V floats a warp
  const long long first = s.lo + s.head;
  const Raw* vin0 = reinterpret_cast<const Raw*>(in0.y + base + first);
  const Raw* vin1 = reinterpret_cast<const Raw*>(in1.y + base + first);
  // Vectors w + lane, for the lanes below `valid` (the others, past the
  // slice, look up no channel); x0 and x1 as loaded.
  auto vectors = [&](long long w, int valid, const Raw& x0, const Raw& x1) {
    const long long i = w + lane;
    const unsigned int e = static_cast<unsigned int>(first + i * V);
    float v[V];
    P::unpack(x0, v);
    if (lane < valid) {
      norm_vec(in0, 0, v, e);
      if constexpr (FORM == RESIDUAL) {
        float v1[V];
        P::unpack(x1, v1);
        norm_vec(in1, 1, v1, e);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = P::round(v[j] + v1[j]);
      }
    }
    if constexpr (RAW) {
      if (lane < valid) reinterpret_cast<Raw*>(raw + base + first)[i] = P::pack(v);
    }
    if constexpr (ACT) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = P::round(elu(v[j]));
      if (!padded) {
        if (lane < valid) reinterpret_cast<Raw*>(act_row + first)[i] = P::pack(v);
        return;
      }
      float4* mine = staging[warp] + lane * (V / 4);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        mine[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      __syncwarp();
      const float* buf = reinterpret_cast<const float*>(staging[warp]);
      const unsigned int e0 = static_cast<unsigned int>(first + w * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = j * 32 + lane;
        if (k < valid * V) emit(e0 + k, buf[k]);
      }
      __syncwarp();
    }
  };
  long long w = warp * 32;
  for (; w + (UNROLL - 1) * THREADS + 32 <= s.nvec; w += UNROLL * THREADS) {
    Raw x0[UNROLL], x1[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x0[u] = __ldg(vin0 + w + lane + u * THREADS);
      if constexpr (FORM == RESIDUAL) x1[u] = __ldg(vin1 + w + lane + u * THREADS);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) vectors(w + u * THREADS, 32, x0[u], x1[u]);
  }
  for (; w < s.nvec; w += THREADS) {
    const int valid = static_cast<int>(min(32LL, s.nvec - w));
    Raw x0 = {}, x1 = {};
    if (lane < valid) {
      x0 = __ldg(vin0 + w + lane);
      if constexpr (FORM == RESIDUAL) x1 = __ldg(vin1 + w + lane);
    }
    vectors(w, valid, x0, x1);
  }
}

Divisor divisor(unsigned int mul, int shift) {
  Divisor d;
  d.mul = mul;
  d.shift = shift;
  return d;
}

template <typename T>
int launch_moments(const void* y, const void* conv_bias, void* partial, int batch, long long n,
                   int t, unsigned int mul, int shift, long long chunk, int splits, int width,
                   cudaStream_t stream) {
  const dim3 grid(splits, batch);
  const size_t smem = conv_bias ? width * sizeof(float) : 0;
  group_norm_moments_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(conv_bias), n, t, divisor(mul, shift),
      chunk, splits, static_cast<double*>(partial));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
NormIn<T> norm_in(const void* y, const void* conv_bias, const void* gamma, const void* beta,
                  const void* partial, double eps) {
  NormIn<T> in;
  in.y = static_cast<const T*>(y);
  in.conv_bias = static_cast<const T*>(conv_bias);
  in.gamma = static_cast<const T*>(gamma);
  in.beta = static_cast<const T*>(beta);
  in.partial = static_cast<const double*>(partial);
  in.eps = eps;
  return in;
}

template <typename T, int FORM>
int launch_apply(const NormIn<T>& in0, const NormIn<T>& in1, void* raw, void* act, int left,
                 int right, int batch, long long n, int t, unsigned int mul, int shift,
                 long long chunk, int splits, int width, int parts, cudaStream_t stream) {
  const dim3 grid(splits, batch);
  const size_t smem = (FORM == RESIDUAL ? 2 : 1) * width * sizeof(float4);
  group_norm_apply_kernel<T, FORM><<<grid, THREADS, smem, stream>>>(
      in0, in1, static_cast<T*>(raw), static_cast<T*>(act), left, right, n, t,
      divisor(mul, shift), chunk, width, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(int form, const NormIn<T>& in0, const NormIn<T>& in1, void* raw, void* act, int left,
          int right, int batch, long long n, int t, unsigned int mul, int shift, long long chunk,
          int splits, int width, int parts, cudaStream_t stream) {
  switch (form) {
    case PLAIN:
      return launch_apply<T, PLAIN>(in0, in1, raw, act, left, right, batch, n, t, mul, shift,
                                    chunk, splits, width, parts, stream);
    case ELU:
      return launch_apply<T, ELU>(in0, in1, raw, act, left, right, batch, n, t, mul, shift,
                                  chunk, splits, width, parts, stream);
    case SPLIT:
      return launch_apply<T, SPLIT>(in0, in1, raw, act, left, right, batch, n, t, mul, shift,
                                    chunk, splits, width, parts, stream);
    case RESIDUAL:
      return launch_apply<T, RESIDUAL>(in0, in1, raw, act, left, right, batch, n, t, mul, shift,
                                       chunk, splits, width, parts, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks an SM holds of a kernel of THREADS threads with no dynamic
// shared memory, or minus the cudaError_t.
template <typename K>
int occupancy(K kernel) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0) != cudaSuccess) {
    return -static_cast<int>(cudaGetLastError());
  }
  return blocks;
}

template <typename T>
int blocks_per_sm(int kernel) {
  switch (kernel) {
    case MOMENTS: return occupancy(group_norm_moments_kernel<T>);
    case PLAIN: return occupancy(group_norm_apply_kernel<T, PLAIN>);
    case ELU: return occupancy(group_norm_apply_kernel<T, ELU>);
    case SPLIT: return occupancy(group_norm_apply_kernel<T, SPLIT>);
    case RESIDUAL: return occupancy(group_norm_apply_kernel<T, RESIDUAL>);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// y [batch, n / t, t] contiguous, 16-byte aligned; conv_bias [n / t] of y's
// type or null; partial [batch, splits, 2] float64 scratch; every block
// (split, b) reads row elements [split * chunk, min(n, (split + 1) * chunk)),
// non-empty and spanning at most width channels; (mul, shift) divide by t
// (Divisor). Returns the cudaError_t of the launch.
extern "C" int group_norm_moments_launch(const void* y, const void* conv_bias, void* partial,
                                         int batch, long long n, int t, unsigned int mul,
                                         int shift, long long chunk, int splits, int width,
                                         int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_moments<__nv_bfloat16>(y, conv_bias, partial, batch, n, t, mul, shift, chunk,
                                         splits, width, s);
  }
  return launch_moments<float>(y, conv_bias, partial, batch, n, t, mul, shift, chunk, splits,
                               width, s);
}

// The apply in form 0-3 (PLAIN, ELU, SPLIT, RESIDUAL) of the norm whose
// moments filled partial [batch, parts, 2] (and partial2: RESIDUAL's second
// norm, whose y2 has y's shape, on the same parts; ignored by the other
// forms), on a grid of its own: chunk, splits and width as the moments'
// are, chosen from this form's occupancy. raw [batch, n / t, t] (PLAIN,
// SPLIT) and act [batch, n / t, left + t + right] (ELU, SPLIT, RESIDUAL),
// contiguous, each written where the form has it; left and right below t.
// Returns the cudaError_t of the launch.
extern "C" int group_norm_apply_launch(
    int form, const void* y, const void* conv_bias, const void* gamma, const void* beta,
    const void* partial, double eps, const void* y2, const void* conv_bias2, const void* gamma2,
    const void* beta2, const void* partial2, double eps2, void* raw, void* act, int left,
    int right, int batch, long long n, int t, unsigned int mul, int shift, long long chunk,
    int splits, int width, int parts, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return apply<T>(form, norm_in<T>(y, conv_bias, gamma, beta, partial, eps),
                    norm_in<T>(y2, conv_bias2, gamma2, beta2, partial2, eps2), raw, act, left,
                    right, batch, n, t, mul, shift, chunk, splits, width, parts, s);
  }
  return apply<float>(form, norm_in<float>(y, conv_bias, gamma, beta, partial, eps),
                      norm_in<float>(y2, conv_bias2, gamma2, beta2, partial2, eps2), raw, act,
                      left, right, batch, n, t, mul, shift, chunk, splits, width, parts, s);
}

// The blocks of THREADS threads an SM holds of one kernel (MOMENTS, -1, or
// the apply's form 0-3) on the current device; minus the cudaError_t on
// failure.
extern "C" int group_norm_blocks_per_sm(int bf16, int kernel) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(kernel) : blocks_per_sm<float>(kernel);
}
