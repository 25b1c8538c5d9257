// VGGish log-mel frontend as one hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_vggish_logmel
// (frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:83, pallas_call
// at L145). Same function, in exact float32:
//   frame t      = wave[b, t*160 : t*160 + 400]   (uncentered; samples past S read 0)
//   re|im[t, k]  = sum_n frame[n] * (hann[n] * cos|-sin(2 pi n k / 512)),  k < 257
//   mag          = sqrt(re^2 + im^2)
//   mel[t, j]    = sum_k mag[t, k] * htk_mel[k, j]    (DC row of htk_mel is zero)
//   out[b, t, j] = log(mel[t, j] + 0.01)
//
// What bounds it on the H100: the windowed DFT is 400 x 514 multiply-adds
// per frame (about 0.41 MFLOP, plus 0.03 MFLOP for the mel product), while a
// frame moves only about 0.9 KB of device memory (160 new samples in, 64
// floats out). So it is compute-bound on fp32 SIMT (no tensor cores: the
// operands stay float32, no TF32).
//
// What the design does about it:
// - The TPU kept the whole [480, 514] DFT matrix in VMEM. Here it is about
//   0.9 MB and cannot sit in a block's 227 KB of shared memory, so every
//   block streams it row by row through L1 from L2, where it stays resident
//   (it is shared by all blocks). The 80 zero rows of the chunked TPU matrix
//   are dropped: K is 400, not 480.
// - One block takes (file b, TILE_T consecutive frames). It stages the
//   (TILE_T - 1) * 160 + 400 samples it needs in shared memory, so the
//   overlapping frames are read from device memory once and no frame matrix
//   is built.
// - Each thread keeps a 4-frame x 9-bin register tile of re and im (bins
//   tx, tx + 32, ...), so one DFT row load from L1 feeds 72 FMAs. re and im
//   of a bin stay in the same thread (the matrix is stored as (cos, sin)
//   pairs), so the magnitude needs no exchange.
// - The [TILE_T, 257] magnitudes go to shared memory; the [257, 64] mel
//   product and the log run from there, and only [TILE_T, 64] is written.
// The sum over n runs in one accumulator per output, n = 0..399 in order
// (the TPU and the plain torch version sum three 160-row chunks), so the
// two differ only by float32 rounding.
// Tensor-core MMA, TMA staging and tuning are later work: a lower-precision
// operand has to be earned by an FAD-delta measurement first.

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 160;
constexpr int WIN = 400;
constexpr int NBIN = 257;
constexpr int NMEL = 64;
constexpr int THREADS = 256;
constexpr int BIN_LANES = 32;                        // threads across bins
constexpr int FRAME_LANES = THREADS / BIN_LANES;     // 8 threads across frames
constexpr int BINS_PER_THREAD = 9;                   // 9 * 32 = 288 >= 257
constexpr int NBIN_PAD = BIN_LANES * BINS_PER_THREAD;  // row length of the DFT operand
constexpr int FRAMES_PER_THREAD = 4;
constexpr int TILE_T = FRAME_LANES * FRAMES_PER_THREAD;  // 32 frames per block
constexpr int SPAN = (TILE_T - 1) * HOP + WIN;       // 5360 samples per block
constexpr int MEL_FRAMES_PER_THREAD = TILE_T * NMEL / THREADS;  // 8
constexpr size_t SMEM_BYTES = (size_t(SPAN) + size_t(TILE_T) * NBIN) * sizeof(float);

static_assert(THREADS % NMEL == 0, "mel stage maps threads onto mel bins");
static_assert(MEL_FRAMES_PER_THREAD * (THREADS / NMEL) == TILE_T, "mel stage covers the tile");

// wave [B, S] f32; dft [WIN, NBIN_PAD] (cos, sin) pairs, zero past bin 256;
// mel [NBIN, NMEL] f32; out [B, T, NMEL] f32. Grid (ceil(T / TILE_T), B).
__global__ void __launch_bounds__(THREADS)
vggish_logmel_kernel(const float* __restrict__ wave, const float2* __restrict__ dft,
                     const float* __restrict__ mel, float* __restrict__ out,
                     long long num_samples, int num_frames) {
  extern __shared__ float smem[];
  float* xs = smem;         // [SPAN] samples of this tile
  float* mag = smem + SPAN;  // [TILE_T, NBIN] magnitudes

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const float* row = wave + (long long)b * num_samples;
  const long long base = (long long)t0 * HOP;
  for (int j = threadIdx.x; j < SPAN; j += THREADS) {
    const long long g = base + j;
    xs[j] = g < num_samples ? row[g] : 0.0f;
  }
  __syncthreads();

  // Windowed DFT: thread (tx, ty) owns frames ty + 8i and bins tx + 32j.
  const int tx = threadIdx.x % BIN_LANES;
  const int ty = threadIdx.x / BIN_LANES;
  float re[FRAMES_PER_THREAD][BINS_PER_THREAD];
  float im[FRAMES_PER_THREAD][BINS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < FRAMES_PER_THREAD; ++i) {
#pragma unroll
    for (int j = 0; j < BINS_PER_THREAD; ++j) {
      re[i][j] = 0.0f;
      im[i][j] = 0.0f;
    }
  }
  const float2* wcol = dft + tx;
#pragma unroll 2
  for (int n = 0; n < WIN; ++n) {
    float x[FRAMES_PER_THREAD];
#pragma unroll
    for (int i = 0; i < FRAMES_PER_THREAD; ++i) x[i] = xs[(ty + FRAME_LANES * i) * HOP + n];
    const float2* wrow = wcol + n * NBIN_PAD;
#pragma unroll
    for (int j = 0; j < BINS_PER_THREAD; ++j) {
      const float2 w = __ldg(wrow + BIN_LANES * j);
#pragma unroll
      for (int i = 0; i < FRAMES_PER_THREAD; ++i) {
        re[i][j] = fmaf(x[i], w.x, re[i][j]);
        im[i][j] = fmaf(x[i], w.y, im[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < FRAMES_PER_THREAD; ++i) {
#pragma unroll
    for (int j = 0; j < BINS_PER_THREAD; ++j) {
      const int k = tx + BIN_LANES * j;
      if (k < NBIN) {
        mag[(ty + FRAME_LANES * i) * NBIN + k] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      }
    }
  }
  __syncthreads();

  // Mel product and log: thread owns mel bin m for 8 consecutive frames.
  const int m = threadIdx.x % NMEL;
  const int f0 = (threadIdx.x / NMEL) * MEL_FRAMES_PER_THREAD;
  float acc[MEL_FRAMES_PER_THREAD];
#pragma unroll
  for (int i = 0; i < MEL_FRAMES_PER_THREAD; ++i) acc[i] = 0.0f;
  for (int k = 0; k < NBIN; ++k) {
    const float w = __ldg(mel + k * NMEL + m);
#pragma unroll
    for (int i = 0; i < MEL_FRAMES_PER_THREAD; ++i) {
      acc[i] = fmaf(mag[(f0 + i) * NBIN + k], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_FRAMES_PER_THREAD; ++i) {
    const int t = t0 + f0 + i;
    if (t < num_frames) {
      out[((long long)b * num_frames + t) * NMEL + m] = logf(acc[i] + 0.01f);
    }
  }
}

}  // namespace

extern "C" {

// Geometry the host builds the operands for; checked by the wrapper.
int vggish_logmel_nbin_pad() { return NBIN_PAD; }

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// Does not synchronise and allocates nothing.
int vggish_logmel_launch(const float* wave, const float* dft, const float* mel, float* out,
                         int batch, long long num_samples, int num_frames, void* stream) {
  if (batch <= 0 || num_frames <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      vggish_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + TILE_T - 1) / TILE_T, batch);
  vggish_logmel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      wave, reinterpret_cast<const float2*>(dft), mel, out, num_samples, num_frames);
  return (int)cudaGetLastError();
}

}  // extern "C"
