// GroupNorm(1, C) forward as a pair of hand-written CUDA kernels for Hopper
// (sm_90a): the norm after each of the 18 convolutions of the 48 kHz Encodec.
//
// Replaces no Pallas kernel: the JAX package leaves this op to XLA
// (frechet_audio_distance_exported_tpu/models/common.py:100,
// group_norm_full: a one-pass (sum x, sum x^2) that XLA fuses into one read).
// The port ran it on ATen's nn.GroupNorm, whose moments kernel reduces each
// of the B rows with one block: at B = 64, 64 blocks on 132 SMs, each walking
// up to 15.4 M elements alone.
//
// Function, for x [B, C, T] and each row b (one clip, N = C*T elements):
//   K        = x[b, 0, 0]                    (a shift, so that the float32
//                                             sums do not hold mean^2)
//   s1, s2   = sum (x - K), sum (x - K)^2    (float32 within a thread,
//                                             float64 from there on)
//   mean     = K + s1/N,  var = max(s2/N - (s1/N)^2, 0),  rstd = 1/sqrt(var + eps)
//   a_c, b_c = gamma_c * rstd,  beta_c - mean * a_c   (float64, rounded once
//                                                      to float32)
//   y        = x * a_c + b_c                  (one float32 fma, rounded to x's type)
// ops/group_norm.py's group_norm_reference computes the same in float64.
//
// What bounds it on the H100: bytes. The 18 normalised tensors of a 64-clip
// chunk hold 37.4 GB (float32). The moments read them once, the apply reads
// and writes them: 112 GB, 33.5 ms at 3.35 TB/s. There are 3 flops an element.
//
// What the design does about it:
// - group_norm_moments_kernel splits every row over gridDim.x blocks
//   (the wrapper picks the splits from B, N and the SMs' occupancy: a few
//   full waves on every SM at every shape). A block reads its contiguous
//   slice with 16-byte loads, four in flight a thread, sums in float32 a
//   thread and in float64 across the block, and writes one float64
//   (s1, s2) to partial[b, split]. No atomics: the order of every sum is
//   fixed, so a result is the same bits from run to run.
// - group_norm_apply_kernel runs on the same grid. Each block first reduces
//   its row's partials in a fixed order (warp 0), so no third launch turns
//   them into mean and rstd; it builds a_c, b_c for the channels its slice
//   spans in shared memory, then writes y with 16-byte loads and stores.
// - A slice's ragged ends (where C*T is no multiple of the vector) are read
//   element by element; the wrapper checks that x starts on 16 bytes.
// - float and bf16 instances: the sums and coefficients are the same, bf16
//   is unpacked to float on load and rounded to nearest even on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte loads in flight a thread
// Channels one apply block may span: the wrapper keeps every slice inside it.
constexpr int MAX_TABLE = 1024;

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
};

// Block (blockIdx.x, blockIdx.y) of a row of n elements: row elements
// [lo, hi), of which [lo, lo + head) and [vend, hi) are read one by one and
// the nvec vectors from lo + head on, 16 bytes each. Global element g is
// 16-byte aligned where g % V == 0, x itself being aligned.
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_moments_kernel(const T* __restrict__ x, long long n, long long chunk, int splits,
                          double* __restrict__ partial) {
  using P = Pack<T>;
  constexpr int V = P::V;
  const T* row = x + static_cast<long long>(blockIdx.y) * n;
  const Slice s = slice_of<V>(n, chunk);
  const float shift = P::to_float(row[0]);

  // One (s1, s2) pair per unrolled load, so four chains of float32 adds.
  float s1[UNROLL] = {}, s2[UNROLL] = {};
  const int tid = threadIdx.x;
  if (tid < s.head) {
    const float d = P::to_float(row[s.lo + tid]) - shift;
    s1[0] += d;
    s2[0] += d * d;
  }
  if (tid < s.hi - s.vend) {
    const float d = P::to_float(row[s.vend + tid]) - shift;
    s1[1] += d;
    s2[1] += d * d;
  }
  const typename P::Raw* vec = reinterpret_cast<const typename P::Raw*>(row + s.lo + s.head);
  long long i = tid;
  for (; i + (UNROLL - 1) * THREADS < s.nvec; i += UNROLL * THREADS) {
    typename P::Raw raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(vec + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[V];
      P::unpack(raw[u], v);
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
    P::unpack(__ldg(vec + i), v);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ beta, const double* __restrict__ partial,
                        long long n, int t, long long chunk, int splits, double eps,
                        T* __restrict__ y) {
  using P = Pack<T>;
  constexpr int V = P::V;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const T* row = x + base;
  T* out = y + base;
  const Slice s = slice_of<V>(n, chunk);
  const int tid = threadIdx.x;

  // 1. The row's mean and rstd from its partials, in a fixed order.
  __shared__ double stats[2];
  if (tid < 32) {
    const double* p = partial + 2 * static_cast<long long>(blockIdx.y) * splits;
    double a = 0.0, q = 0.0;
    for (int k = tid; k < splits; k += 32) {
      a += p[2 * k];
      q += p[2 * k + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      q += __shfl_down_sync(0xffffffffu, q, off);
    }
    if (tid == 0) {
      const double m1 = a / static_cast<double>(n);
      const double var = fmax(q / static_cast<double>(n) - m1 * m1, 0.0);
      stats[0] = static_cast<double>(P::to_float(row[0])) + m1;
      stats[1] = 1.0 / sqrt(var + eps);
    }
  }
  __syncthreads();

  // 2. (a_c, b_c) of the channels this slice spans.
  __shared__ float2 table[MAX_TABLE];
  const unsigned int ut = static_cast<unsigned int>(t);
  const unsigned int c0 = static_cast<unsigned int>(s.lo) / ut;
  const unsigned int c1 = static_cast<unsigned int>(s.hi - 1) / ut;
  for (unsigned int c = c0 + tid; c <= c1; c += THREADS) {
    const double a = static_cast<double>(P::to_float(gamma[c])) * stats[1];
    const double b = static_cast<double>(P::to_float(beta[c])) - stats[0] * a;
    table[c - c0] = make_float2(static_cast<float>(a), static_cast<float>(b));
  }
  __syncthreads();

  // 3. y = x * a_c + b_c.
  auto one = [&](long long e) {
    const float2 ab = table[static_cast<unsigned int>(e) / ut - c0];
    out[e] = P::from_float(fmaf(P::to_float(row[e]), ab.x, ab.y));
  };
  if (tid < s.head) one(s.lo + tid);
  if (tid < s.hi - s.vend) one(s.vend + tid);
  const long long first = s.lo + s.head;
  const typename P::Raw* vin = reinterpret_cast<const typename P::Raw*>(row + first);
  typename P::Raw* vout = reinterpret_cast<typename P::Raw*>(out + first);
  auto scale = [&](long long k, const typename P::Raw& raw) {
    float v[V];
    P::unpack(raw, v);
    const unsigned int e = static_cast<unsigned int>(first + k * V);
    const unsigned int c = e / ut;
    if (e - c * ut + V <= ut) {  // the whole vector in channel c
      const float2 ab = table[c - c0];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = fmaf(v[j], ab.x, ab.y);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float2 ab = table[(e + j) / ut - c0];
        v[j] = fmaf(v[j], ab.x, ab.y);
      }
    }
    vout[k] = P::pack(v);
  };
  long long i = tid;
  for (; i + (UNROLL - 1) * THREADS < s.nvec; i += UNROLL * THREADS) {
    typename P::Raw raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(vin + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) scale(i + u * THREADS, raw[u]);
  }
  for (; i < s.nvec; i += THREADS) scale(i, __ldg(vin + i));
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* partial, void* y, int batch,
           long long n, int t, long long chunk, int splits, double eps, cudaStream_t stream) {
  const dim3 grid(splits, batch);
  group_norm_moments_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, chunk, splits, static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_norm_apply_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const double*>(partial), n, t, chunk, splits, eps, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm() {
  int moments = 0, apply = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&moments, group_norm_moments_kernel<T>,
                                                    THREADS, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&apply, group_norm_apply_kernel<T>,
                                                    THREADS, 0) != cudaSuccess) {
    return -static_cast<int>(cudaGetLastError());
  }
  return moments < apply ? moments : apply;
}

}  // namespace

// x, y [batch, n / t, t] contiguous, 16-byte aligned; gamma, beta [n / t] of
// x's type; partial [batch, splits, 2] float64 scratch; every block
// (split, b) reads row elements [split * chunk, min(n, (split + 1) * chunk)),
// non-empty and spanning at most MAX_TABLE channels. Returns the cudaError_t
// of the launches.
extern "C" int group_norm_launch(const void* x, const void* gamma, const void* beta,
                                 void* partial, void* y, int batch, long long n, int t,
                                 long long chunk, int splits, double eps, int bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(x, gamma, beta, partial, y, batch, n, t, chunk, splits, eps, s);
  }
  return launch<float>(x, gamma, beta, partial, y, batch, n, t, chunk, splits, eps, s);
}

// The blocks of THREADS threads an SM holds of both kernels at once (the
// smaller of the two) on the current device; minus the cudaError_t on failure.
extern "C" int group_norm_blocks_per_sm(int bf16) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>() : blocks_per_sm<float>();
}
