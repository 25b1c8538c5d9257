// PANN / CLAP log-mel frontend as one hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_pann_logmel
// (frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:185, pallas_call
// at L246). Same function, in float32, for a reflect-padded wave:
//   frame t      = wave[b, t*hop : t*hop + n_fft]   (samples past L read 0)
//   X[t, k]      = sum_n frame[n] * hann[n] * exp(-2 pi i n k / n_fft),  k <= n_fft/2
//   power        = |X|^2
//   mel[t, j]    = sum_k power[t, k] * slaney_mel[k, j]
//   out[b, t, j] = 10 * log10(max(mel[t, j], 1e-10))   if t < n_valid[b]
//                = 0                                  otherwise (exactly)
// The zero rows are the reference's zero pad of the log-mel onto the PANN
// time grid; they reach the embedding through bn0 and global pooling.
// (n_fft, hop) is (256, 80), (512, 160), (1024, 320) for pann-8k/16k/32k and
// (1024, 480) for CLAP at 48 kHz. n_fft is a template parameter; hop is a
// runtime argument.
//
// What bounds it on the H100: an FFT-based log-mel does about 2.5 n log2 n
// flops a frame for the real FFT (26 kFLOP at n_fft 1024) and a few hundred
// for the window, the power and the mel's nonzero taps, about 1.7 GFLOP for
// 64 x 1032 frames: 0.03 ms at 67 TFLOP/s. It moves the samples the valid
// frames read and the log-mel written, 0.01-0.04 ms at 3.35 TB/s. So the
// bound is bytes, and what the kernel has to avoid is the work of a direct
// DFT (n_fft x (n_fft + 2) FMAs a frame, 24-74x the FFT's) and passes over
// shared memory beyond the FFT's own stages.
//
// What the design does about it:
// - One block takes (file b, FRAMES = 16 consecutive frames). The frames are
//   read from device memory (the overlapping samples of neighbouring frames
//   come from L1), windowed with the periodic Hann window (the float32 values
//   of the plain version's windowed DFT matrix) and packed as n_fft/2
//   complex values a frame in shared memory, one padded row each (rfft.cuh).
// - The real FFT is a complex FFT of n_fft/2 points plus the split step
//   (csrc/rfft.cuh): a radix-4 Stockham FFT in place, with one radix-2 stage
//   when log2(n_fft/2) is odd (n_fft 256 and 1024). Twiddles come from a table
//   the host builds in float64 and rounds once to float32, staged in shared
//   memory with the window. The power |X|^2 of the n_fft/2 + 1 bins is
//   written in place.
// - The Slaney mel is a sparse product: each of the 64 bands has a contiguous
//   range of nonzero taps (247 / 495 / 866 / 577 in all at 8 / 16 / 32 /
//   48 kHz). The host packs (start, count, offset) per band and the taps;
//   thread (frame, band) sums its taps from the power in shared memory, then
//   takes the dB and applies the mask. The [16, 64] tile goes out through a
//   padded shared-memory tile, so the stores to device memory are coalesced.
// - A tile whose first frame is at or past n_valid[b] writes zeros and skips
//   the FFT: the batch's padding rows (n_valid 0) and the tail of a short
//   file on a long grid cost no arithmetic.
// - Shared memory: up to 82 KB (n_fft 1024), above the 48 KB default, so the
//   launch raises the block's dynamic shared-memory limit first.
// - Frames go on gridDim.x (up to 2^31 - 1 tiles; a file may have 2^18
//   frames) and files on gridDim.y (the wrapper checks 65535).
// The sums run in another order than the plain version's chunk-sum DFT, so
// the two differ by float32 rounding: the FFT's error grows with log2 n_fft.

#include <cuda_runtime.h>

#include "rfft.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NMEL = 64;
constexpr int FRAMES = 16;          // frames a block
constexpr int MEL_LD = NMEL + 1;    // padded row of the output tile

template <int N_FFT>
constexpr size_t smem_bytes() {
  return N_FFT * sizeof(float2)                           // twiddles
         + size_t(FRAMES) * (N_FFT / 2 + 1) * sizeof(float2)  // frames, then spectra
         + N_FFT * sizeof(float)                          // window
         + size_t(FRAMES) * MEL_LD * sizeof(float);       // log-mel tile
}

// wave [B, L] f32; n_valid [B] int32; window [N_FFT] f32; twiddle [N_FFT] (cos, -sin) pairs;
// bands [NMEL, 3] int32 (start bin, count, offset into taps); taps f32; out [B, T, NMEL] f32.
// Grid (ceil(T / FRAMES), B); dynamic shared memory smem_bytes<N_FFT>().
template <int N_FFT>
__global__ void __launch_bounds__(THREADS)
pann_logmel_kernel(const float* __restrict__ wave, const int* __restrict__ n_valid,
                   const float* __restrict__ window, const float2* __restrict__ twiddle,
                   const int* __restrict__ bands, const float* __restrict__ taps,
                   float* __restrict__ out, long long num_samples, int num_frames, int hop) {
  constexpr int M = N_FFT / 2;
  constexpr int STRIDE = M + 1;
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);         // [N_FFT]
  float2* buf = tw + N_FFT;                              // [FRAMES][STRIDE]
  float* win = reinterpret_cast<float*>(buf + FRAMES * STRIDE);  // [N_FFT]
  float* mel_s = win + N_FFT;                            // [FRAMES][MEL_LD]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FRAMES;
  const int nv = n_valid[b];
  float* orow = out + (long long)b * num_frames * NMEL;

  if (t0 >= nv) {  // the whole tile is masked: exact zeros, no FFT
    for (int j = threadIdx.x; j < FRAMES * NMEL; j += THREADS) {
      const int t = t0 + j / NMEL;
      if (t < num_frames) orow[(long long)t * NMEL + j % NMEL] = 0.0f;
    }
    return;
  }

  for (int i = threadIdx.x; i < N_FFT; i += THREADS) {
    tw[i] = twiddle[i];
    win[i] = window[i];
  }
  __syncthreads();
  rfft::load_frames<M, FRAMES, THREADS>(buf, STRIDE, wave + (long long)b * num_samples,
                                        num_samples, (long long)t0 * hop, hop, win, N_FFT);
  __syncthreads();
  rfft::fft<M, FRAMES, THREADS>(buf, STRIDE, tw);
  rfft::split_spectrum<M, FRAMES, THREADS, true>(buf, STRIDE, tw);

  // Mel bands, dB and mask: thread (frame f, band lane) takes bands lane, lane + 16, ...
  const int f = threadIdx.x % FRAMES;
  const int t = t0 + f;
  for (int m = threadIdx.x / FRAMES; m < NMEL; m += THREADS / FRAMES) {
    const int start = __ldg(bands + 3 * m), count = __ldg(bands + 3 * m + 1);
    const float* w = taps + __ldg(bands + 3 * m + 2);
    float acc = 0.0f;
    for (int i = 0; i < count; ++i) {
      acc = fmaf(rfft::bin(buf, STRIDE, f, start + i), __ldg(w + i), acc);
    }
    mel_s[f * MEL_LD + m] = t < nv ? 10.0f * log10f(fmaxf(acc, 1e-10f)) : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < FRAMES * NMEL; j += THREADS) {
    const int tt = t0 + j / NMEL;
    if (tt < num_frames) {
      orow[(long long)tt * NMEL + j % NMEL] = mel_s[(j / NMEL) * MEL_LD + j % NMEL];
    }
  }
}

template <int N_FFT>
int launch(const float* wave, const int* n_valid, const float* window, const float* twiddle,
           const int* bands, const float* taps, float* out, int batch, long long num_samples,
           int num_frames, int hop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N_FFT>();
  cudaError_t err = cudaFuncSetAttribute(
      pann_logmel_kernel<N_FFT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + FRAMES - 1) / FRAMES, batch);
  pann_logmel_kernel<N_FFT><<<grid, THREADS, smem, stream>>>(
      wave, n_valid, window, reinterpret_cast<const float2*>(twiddle), bands, taps, out,
      num_samples, num_frames, hop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok;
// cudaErrorInvalidValue for an n_fft without an instantiation or a hop
// outside (0, n_fft]). Does not synchronise and allocates nothing.
int pann_logmel_launch(const float* wave, const int* n_valid, const float* window,
                       const float* twiddle, const int* bands, const float* taps, float* out,
                       int batch, long long num_samples, int num_frames, int n_fft, int hop,
                       void* stream) {
  if (batch <= 0 || num_frames <= 0) return 0;
  if (hop <= 0 || hop > n_fft) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256:
      return launch<256>(wave, n_valid, window, twiddle, bands, taps, out, batch, num_samples,
                         num_frames, hop, s);
    case 512:
      return launch<512>(wave, n_valid, window, twiddle, bands, taps, out, batch, num_samples,
                         num_frames, hop, s);
    case 1024:
      return launch<1024>(wave, n_valid, window, twiddle, bands, taps, out, batch, num_samples,
                          num_frames, hop, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
