// VGGish log-mel frontend as one hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_vggish_logmel
// (frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83, pallas_call
// at L145). Same function, in float32:
//   frame t      = wave[b, t*160 : t*160 + 400]   (uncentered; samples past S read 0)
//   X[t, k]      = sum_n frame[n] * hann[n] * exp(-2 pi i n k / 512),  k <= 256
//                  (the 400-sample periodic Hann window, zero-padded to 512)
//   mag          = |X|
//   mel[t, j]    = sum_k mag[t, k] * htk_mel[k, j]    (DC row of htk_mel is zero)
//   out[b, t, j] = log(mel[t, j] + 0.01)
// There is no mask: VGGish callers drop whole patches by per-file counts.
//
// What bounds it on the H100: an FFT-based log-mel does about 14 kFLOP a
// frame (the window, 2.5 n log2 n for the real FFT of 512 points, the
// magnitude, 2 per nonzero HTK tap, the log): 0.86 GFLOP for 64 x 960
// frames, 0.013 ms at 67 TFLOP/s. It must move the samples the frames read
// and the log-mel written, 55.1 MB, 0.0165 ms at 3.35 TB/s. So it is bound
// by bytes, and what the kernel has to avoid is the work of a direct DFT
// (400 x 514 FMAs a frame, some 30x the FFT's) and passes over shared
// memory beyond the FFT's own stages.
//
// What the design does about it (the PANN kernel's design, csrc/pann_logmel.cu,
// at one geometry):
// - One block takes (file b, FRAMES = 16 consecutive frames). The frames are
//   read from device memory (the overlap of neighbouring frames, 240 of 400
//   samples, comes from L1), windowed, zero-padded from 400 to 512 samples
//   and packed as 256 complex values a frame in shared memory, one padded
//   row each (csrc/rfft.cuh load_frames with window_length 400).
// - The real FFT is a complex FFT of 256 points (four radix-4 Stockham stages
//   in place) plus the split step, which writes the magnitude |X| of the 257
//   bins in place (rfft.cuh). Twiddles come from a table the host builds in
//   float64 and rounds once to float32, staged in shared memory with the
//   window.
// - The HTK mel is a sparse product: each of the 64 bands has a contiguous
//   range of nonzero taps (461 in all; the DC row is zero, the narrowest band
//   has 1 tap). The host packs (start, count, offset) per band and the taps;
//   thread (frame, band) sums its taps from the magnitudes in shared memory
//   and takes the log. The [16, 64] tile goes out through a padded
//   shared-memory tile, so the stores to device memory are coalesced.
// - Shared memory: 42 KB a block. Frames go on gridDim.x, files on gridDim.y
//   (the wrapper checks 65535).
// The sums run in another order than the plain version's chunk-sum DFT, so
// the two differ by float32 rounding.

#include <cuda_runtime.h>

#include "rfft.cuh"

namespace {

constexpr int N_FFT = 512;
constexpr int M = N_FFT / 2;       // complex points of the FFT
constexpr int STRIDE = M + 1;      // padded row of a frame (rfft.cuh)
constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int THREADS = 256;
constexpr int NMEL = 64;
constexpr int FRAMES = 16;         // frames a block
constexpr int MEL_LD = NMEL + 1;   // padded row of the output tile
constexpr size_t SMEM_BYTES = N_FFT * sizeof(float2)                     // twiddles
                              + size_t(FRAMES) * STRIDE * sizeof(float2)  // frames, then spectra
                              + WIN * sizeof(float)                       // window
                              + size_t(FRAMES) * MEL_LD * sizeof(float);  // log-mel tile

// wave [B, S] f32; window [WIN] f32; twiddle [N_FFT] (cos, -sin) pairs; bands [NMEL, 3]
// int32 (start bin, count, offset into taps); taps f32; out [B, T, NMEL] f32.
// Grid (ceil(T / FRAMES), B); dynamic shared memory SMEM_BYTES.
__global__ void __launch_bounds__(THREADS)
vggish_logmel_kernel(const float* __restrict__ wave, const float* __restrict__ window,
                     const float2* __restrict__ twiddle, const int* __restrict__ bands,
                     const float* __restrict__ taps, float* __restrict__ out,
                     long long num_samples, int num_frames) {
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);                  // [N_FFT]
  float2* buf = tw + N_FFT;                                       // [FRAMES][STRIDE]
  float* win = reinterpret_cast<float*>(buf + FRAMES * STRIDE);  // [WIN]
  float* mel_s = win + WIN;                                       // [FRAMES][MEL_LD]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FRAMES;
  for (int i = threadIdx.x; i < N_FFT; i += THREADS) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < WIN; i += THREADS) win[i] = window[i];
  __syncthreads();
  rfft::load_frames<M, FRAMES, THREADS>(buf, STRIDE, wave + (long long)b * num_samples,
                                        num_samples, (long long)t0 * HOP, HOP, win, WIN);
  __syncthreads();
  rfft::fft<M, FRAMES, THREADS>(buf, STRIDE, tw);
  rfft::split_spectrum<M, FRAMES, THREADS, false>(buf, STRIDE, tw);

  // Mel bands and log: thread (frame f, band lane) takes bands lane, lane + 16, ...
  const int f = threadIdx.x % FRAMES;
  for (int m = threadIdx.x / FRAMES; m < NMEL; m += THREADS / FRAMES) {
    const int start = __ldg(bands + 3 * m), count = __ldg(bands + 3 * m + 1);
    const float* w = taps + __ldg(bands + 3 * m + 2);
    float acc = 0.0f;
    for (int i = 0; i < count; ++i) {
      acc = fmaf(rfft::bin(buf, STRIDE, f, start + i), __ldg(w + i), acc);
    }
    mel_s[f * MEL_LD + m] = logf(acc + 0.01f);
  }
  __syncthreads();
  float* orow = out + (long long)b * num_frames * NMEL;
  for (int j = threadIdx.x; j < FRAMES * NMEL; j += THREADS) {
    const int t = t0 + j / NMEL;
    if (t < num_frames) {
      orow[(long long)t * NMEL + j % NMEL] = mel_s[(j / NMEL) * MEL_LD + j % NMEL];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// Does not synchronise and allocates nothing.
int vggish_logmel_launch(const float* wave, const float* window, const float* twiddle,
                         const int* bands, const float* taps, float* out, int batch,
                         long long num_samples, int num_frames, void* stream) {
  if (batch <= 0 || num_frames <= 0) return 0;
  const dim3 grid((num_frames + FRAMES - 1) / FRAMES, batch);
  vggish_logmel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      wave, window, reinterpret_cast<const float2*>(twiddle), bands, taps, out, num_samples,
      num_frames);
  return (int)cudaGetLastError();
}

}  // extern "C"
