// Real FFT of a tile of windowed frames in shared memory, for the log-mel kernels (sm_90a).
//
// A block holds FRAMES frames of n_fft = N = 2M real samples each as M complex values
// z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1] (x the frame's samples, w the window), one row of
// M + 1 float2 per frame. The extra float2 makes the row stride odd: the FFT stages put
// FRAMES = 16 neighbouring threads on 16 frames at the same index, and those hit 16
// distinct bank pairs, whatever the index pattern of the stage.
// - load_frames: the window product, samples past the signal or the window reading 0;
// - fft: Z = FFT_M(z) in place, a Stockham FFT of radix-4 stages and, when log2 M is odd,
//   one last radix-2 stage. Each stage reads all its butterflies' inputs into registers,
//   synchronises, and writes their outputs, so one buffer serves both sides;
// - split_spectrum: the real spectrum X[k] = E[k] + W_N^k O[k], k = 0 .. M, with
//   E[k] = (Z[k] + conj Z[M-k]) / 2 and O[k] = (Z[k] - conj Z[M-k]) / 2i the spectra of the
//   even and odd samples, and X[M-k] = conj(E[k] - W_N^k O[k]). It writes |X[k]|^2 (or
//   |X[k]|) into the .x of slot k (slot M is the row's padding); read it with bin().
// Twiddles come from a table tw[m] = exp(-2 pi i m / N), m < N, that the host builds in
// float64 and rounds once to float32 (no __sinf / __cosf at run time). The stage of radix R
// over sub-transforms of length NS multiplies input r of butterfly j by
// W_{NS R}^{(j mod NS) r} = tw[2 (j mod NS) r M / (NS R)].
// tests/test_torch_pann_frontend.py holds a numpy model of this algorithm (same window,
// table, radix order and split step) to the plain log-mel.
#pragma once

#include <cuda_runtime.h>

namespace rfft {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void radix2(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[1] = make_float2(a.x - b.x, a.y - b.y);
}

// The forward radix-4 butterfly (W_4 = -i).
__device__ __forceinline__ void radix4(float2 (&v)[4]) {
  const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 b = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 c = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 d = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
  v[0] = make_float2(a.x + c.x, a.y + c.y);
  v[1] = make_float2(b.x + d.y, b.y - d.x);  // b - i d
  v[2] = make_float2(a.x - c.x, a.y - c.y);
  v[3] = make_float2(b.x - d.y, b.y + d.x);  // b + i d
}

// z[f][n] for n < M of FRAMES frames: frame f's sample s is row[base + f*hop + s], read as 0
// at or past num_samples and at s >= window_length (a window shorter than n_fft is
// zero-padded). window is [window_length] floats (shared memory).
template <int M, int FRAMES, int THREADS>
__device__ __forceinline__ void load_frames(float2* buf, int stride, const float* __restrict__ row,
                                            long long num_samples, long long base, int hop,
                                            const float* window, int window_length) {
  for (int i = threadIdx.x; i < FRAMES * M; i += THREADS) {
    const int f = i / M, n = i % M;
    const long long g = base + (long long)f * hop + 2 * n;
    const float x0 = (2 * n < window_length && g < num_samples) ? row[g] * window[2 * n] : 0.0f;
    const float x1 =
        (2 * n + 1 < window_length && g + 1 < num_samples) ? row[g + 1] * window[2 * n + 1] : 0.0f;
    buf[f * stride + n] = make_float2(x0, x1);
  }
}

template <int M, int R, int NS, int FRAMES, int THREADS>
__device__ __forceinline__ void stockham_stage(float2* buf, int stride, const float2* tw) {
  constexpr int LANES = THREADS / FRAMES;
  constexpr int PER = M / R / LANES;  // butterflies per thread
  static_assert(PER * LANES * R == M, "the threads of a frame cover its butterflies");
  const int f = threadIdx.x % FRAMES, lane = threadIdx.x / FRAMES;
  float2* z = buf + f * stride;
  float2 v[PER][R];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + i * LANES;
    const int k = j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[i][r] = z[j + r * (M / R)];
      if (NS > 1 && r > 0) v[i][r] = cmul(v[i][r], tw[2 * k * r * (M / (NS * R))]);
    }
    if constexpr (R == 4) {
      radix4(v[i]);
    } else {
      radix2(v[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = lane + i * LANES;
    const int k = j % NS;
    const int d = (j / NS) * NS * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) z[d + r * NS] = v[i][r];
  }
  __syncthreads();
}

template <int M, int NS, int FRAMES, int THREADS>
__device__ __forceinline__ void stockham_from(float2* buf, int stride, const float2* tw) {
  if constexpr (NS * 4 <= M) {
    stockham_stage<M, 4, NS, FRAMES, THREADS>(buf, stride, tw);
    stockham_from<M, NS * 4, FRAMES, THREADS>(buf, stride, tw);
  } else if constexpr (NS * 2 <= M) {
    stockham_stage<M, 2, NS, FRAMES, THREADS>(buf, stride, tw);
  }
}

// Z = FFT_M(z) in place for FRAMES rows (natural order in and out). The caller synchronises
// after load_frames; fft ends synchronised.
template <int M, int FRAMES, int THREADS>
__device__ __forceinline__ void fft(float2* buf, int stride, const float2* tw) {
  static_assert((M & (M - 1)) == 0 && M >= 8, "M is a power of two");
  stockham_from<M, 1, FRAMES, THREADS>(buf, stride, tw);
}

// |X[k]|^2 (POWER) or |X[k]| for k = 0 .. M into the .x of slot k; ends synchronised.
template <int M, int FRAMES, int THREADS, bool POWER>
__device__ __forceinline__ void split_spectrum(float2* buf, int stride, const float2* tw) {
  auto out = [](float re, float im) {
    const float p = re * re + im * im;
    return POWER ? p : sqrtf(p);
  };
  const int f = threadIdx.x % FRAMES, lane = threadIdx.x / FRAMES;
  float2* z = buf + f * stride;
  for (int k = lane; k <= M / 2; k += THREADS / FRAMES) {
    if (k == 0) {
      const float2 z0 = z[0];
      z[0].x = out(z0.x + z0.y, 0.0f);
      z[M].x = out(z0.x - z0.y, 0.0f);
    } else {
      const float2 a = z[k], c = z[M - k];
      const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
      const float2 wo = cmul(tw[k], o);
      z[k].x = out(e.x + wo.x, e.y + wo.y);
      if (M - k != k) z[M - k].x = out(e.x - wo.x, e.y - wo.y);
    }
  }
  __syncthreads();
}

// Bin k of frame f after split_spectrum.
__device__ __forceinline__ float bin(const float2* buf, int stride, int f, int k) {
  return buf[f * stride + k].x;
}

}  // namespace rfft
