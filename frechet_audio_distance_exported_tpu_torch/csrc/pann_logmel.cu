// PANN / CLAP log-mel frontend as one hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_pann_logmel
// (frechet_audio_distance_exported_tpu/ops/pallas_frontend.py:185, pallas_call
// at L246). Same function, in exact float32, for a reflect-padded wave:
//   frame t      = wave[b, t*hop : t*hop + n_fft]   (samples past L read 0)
//   re|im[t, k]  = sum_n frame[n] * (hann[n] * cos|-sin(2 pi n k / n_fft)),  k <= n_fft/2
//   power        = re^2 + im^2
//   mel[t, j]    = sum_k power[t, k] * slaney_mel[k, j]
//   out[b, t, j] = 10 * log10(max(mel[t, j], 1e-10))   if t < n_valid[b]
//                = 0                                  otherwise (exactly)
// The zero rows are the reference's zero pad of the log-mel onto the PANN
// time grid; they reach the embedding through bn0 and global pooling.
// (n_fft, hop) is (256, 80), (512, 160), (1024, 320) for pann-8k/16k/32k and
// (1024, 480) for CLAP at 48 kHz. n_fft is a template parameter (it fixes
// the register tile); hop is a runtime argument.
//
// What bounds it on the H100: the windowed DFT is n_fft x (n_fft + 2)
// multiply-adds per frame (2.1 MFLOP at n_fft 1024, 0.53 at 512, 0.13 at
// 256), plus 0.07 MFLOP or less for the mel product, while a frame moves
// only hop + 64 floats of device memory. So it is compute-bound on fp32
// SIMT (no tensor cores: the operands stay float32, no TF32).
//
// What the design does about it:
// - The TPU kept the chunked [m*hop, 2F] DFT matrix in VMEM. Here the zero
//   rows of the chunked matrix are dropped (K is n_fft: 512, not 640, at
//   16 kHz; 1024, not 1280, at 32 kHz). The rest is up to 4.7 MB at n_fft
//   1024, far beyond a block's 227 KB of shared memory, so every block
//   streams it row by row through L1 from L2, where it stays resident (all
//   blocks share it).
// - One block takes (file b, TILE_T consecutive frames). It stages the
//   (TILE_T - 1) * hop + n_fft samples it needs in shared memory, so the
//   overlapping frames are read from device memory once and no frame matrix
//   is built; samples past L read as zero, so the host needs no pad copy.
// - Each thread keeps a FRAMES_PER_THREAD x BINS_PER_THREAD register tile of
//   re and im (4 x 5, 4 x 9 and 4 x 9 at n_fft 256, 512 and 1024), so one
//   DFT row load from L1 feeds up to 72 FMAs. At n_fft 1024 the 513 bins
//   are spread over 64 bin lanes rather than 32, which keeps the tile at 9
//   bins (about the VGGish kernel's 108 registers, no spills) and halves
//   TILE_T to 16. re and im of a bin stay in the same thread (the matrix is
//   stored as (cos, sin) pairs), so the power needs no exchange.
// - The [TILE_T, NBIN] power tile goes to shared memory; the [NBIN, 64] mel
//   product, the dB conversion and the mask run from there, and only
//   [TILE_T, 64] is written. Staged samples plus the power tile take up to
//   66 KB (n_fft 1024, hop 480), above the 48 KB default, so the launch
//   raises the block's dynamic shared-memory limit first.
// - A tile whose first frame is at or past n_valid[b] writes zeros and
//   skips the DFT: the batch's padding rows (n_valid 0) and the tail of a
//   short file on a long grid cost no arithmetic.
// - Frames go on gridDim.x (up to 2^31 - 1 tiles; a file may have 2^18
//   frames) and files on gridDim.y (the wrapper checks 65535).
// The sum over n runs in one accumulator per output, n = 0..n_fft-1 in
// order (the TPU and the plain torch version sum hop-row chunks), so the
// two differ only by float32 rounding.
// Tensor-core MMA, TMA staging and tuning are later work: a lower-precision
// operand has to be earned by an FAD-delta measurement first.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NMEL = 64;

template <int N_FFT, int BIN_LANES, int BINS_PER_THREAD, int FRAMES_PER_THREAD>
struct Geometry {
  static constexpr int NFFT = N_FFT;
  static constexpr int NBIN = N_FFT / 2 + 1;
  static constexpr int LANES = BIN_LANES;            // threads across bins
  static constexpr int BPT = BINS_PER_THREAD;
  static constexpr int FPT = FRAMES_PER_THREAD;
  static constexpr int FRAME_LANES = THREADS / BIN_LANES;  // threads across frames
  static constexpr int NBIN_PAD = BIN_LANES * BINS_PER_THREAD;  // row length of the DFT operand
  static constexpr int TILE_T = FRAME_LANES * FRAMES_PER_THREAD;
  static constexpr int MEL_FRAMES_PER_THREAD = TILE_T * NMEL / THREADS;
  static_assert(THREADS % BIN_LANES == 0, "bin lanes divide the block");
  static_assert(NBIN_PAD >= NBIN, "the register tile covers every bin");
  static_assert(NBIN_PAD - BIN_LANES < NBIN, "no thread holds only padding bins");
  static_assert(MEL_FRAMES_PER_THREAD * (THREADS / NMEL) == TILE_T, "mel stage covers the tile");
};

using G256 = Geometry<256, 32, 5, 4>;    // 129 bins in 160, 32 frames a tile
using G512 = Geometry<512, 32, 9, 4>;    // 257 bins in 288, 32 frames a tile
using G1024 = Geometry<1024, 64, 9, 4>;  // 513 bins in 576, 16 frames a tile

template <class G>
size_t smem_bytes(int hop) {
  const size_t span = size_t(G::TILE_T - 1) * hop + G::NFFT;
  return (span + size_t(G::TILE_T) * G::NBIN) * sizeof(float);
}

// wave [B, L] f32; n_valid [B] int32; dft [N_FFT, NBIN_PAD] (cos, sin) pairs,
// zero past bin N_FFT/2; mel [NBIN, NMEL] f32; out [B, T, NMEL] f32.
// Grid (ceil(T / TILE_T), B); dynamic shared memory smem_bytes<G>(hop).
template <class G>
__global__ void __launch_bounds__(THREADS)
pann_logmel_kernel(const float* __restrict__ wave, const int* __restrict__ n_valid,
                   const float2* __restrict__ dft, const float* __restrict__ mel,
                   float* __restrict__ out, long long num_samples, int num_frames, int hop) {
  extern __shared__ float smem[];
  const int span = (G::TILE_T - 1) * hop + G::NFFT;
  float* xs = smem;            // [span] samples of this tile
  float* power = smem + span;  // [TILE_T, NBIN] power spectra

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TILE_T;
  const int nv = n_valid[b];
  float* orow = out + (long long)b * num_frames * NMEL;

  if (t0 >= nv) {  // the whole tile is masked: exact zeros, no DFT
    for (int j = threadIdx.x; j < G::TILE_T * NMEL; j += THREADS) {
      const int t = t0 + j / NMEL;
      if (t < num_frames) orow[(long long)t * NMEL + j % NMEL] = 0.0f;
    }
    return;
  }

  const float* row = wave + (long long)b * num_samples;
  const long long base = (long long)t0 * hop;
  for (int j = threadIdx.x; j < span; j += THREADS) {
    const long long g = base + j;
    xs[j] = g < num_samples ? row[g] : 0.0f;
  }
  __syncthreads();

  // Windowed DFT: thread (tx, ty) owns frames ty + FRAME_LANES*i and bins tx + LANES*j.
  const int tx = threadIdx.x % G::LANES;
  const int ty = threadIdx.x / G::LANES;
  float re[G::FPT][G::BPT];
  float im[G::FPT][G::BPT];
#pragma unroll
  for (int i = 0; i < G::FPT; ++i) {
#pragma unroll
    for (int j = 0; j < G::BPT; ++j) {
      re[i][j] = 0.0f;
      im[i][j] = 0.0f;
    }
  }
  int xoff[G::FPT];  // offsets of this thread's frames in xs
#pragma unroll
  for (int i = 0; i < G::FPT; ++i) xoff[i] = (ty + G::FRAME_LANES * i) * hop;
  const float2* wcol = dft + tx;
#pragma unroll 2
  for (int n = 0; n < G::NFFT; ++n) {
    float x[G::FPT];
#pragma unroll
    for (int i = 0; i < G::FPT; ++i) x[i] = xs[xoff[i] + n];
    const float2* wrow = wcol + n * G::NBIN_PAD;
#pragma unroll
    for (int j = 0; j < G::BPT; ++j) {
      const float2 w = __ldg(wrow + G::LANES * j);
#pragma unroll
      for (int i = 0; i < G::FPT; ++i) {
        re[i][j] = fmaf(x[i], w.x, re[i][j]);
        im[i][j] = fmaf(x[i], w.y, im[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G::FPT; ++i) {
#pragma unroll
    for (int j = 0; j < G::BPT; ++j) {
      const int k = tx + G::LANES * j;
      if (k < G::NBIN) {
        power[(ty + G::FRAME_LANES * i) * G::NBIN + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
  __syncthreads();

  // Mel product, dB and mask: thread owns mel bin m for MEL_FRAMES_PER_THREAD consecutive frames.
  const int m = threadIdx.x % NMEL;
  const int f0 = (threadIdx.x / NMEL) * G::MEL_FRAMES_PER_THREAD;
  float acc[G::MEL_FRAMES_PER_THREAD];
#pragma unroll
  for (int i = 0; i < G::MEL_FRAMES_PER_THREAD; ++i) acc[i] = 0.0f;
  for (int k = 0; k < G::NBIN; ++k) {
    const float w = __ldg(mel + k * NMEL + m);
#pragma unroll
    for (int i = 0; i < G::MEL_FRAMES_PER_THREAD; ++i) {
      acc[i] = fmaf(power[(f0 + i) * G::NBIN + k], w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < G::MEL_FRAMES_PER_THREAD; ++i) {
    const int t = t0 + f0 + i;
    if (t < num_frames) {
      orow[(long long)t * NMEL + m] = t < nv ? 10.0f * log10f(fmaxf(acc[i], 1e-10f)) : 0.0f;
    }
  }
}

template <class G>
int launch(const float* wave, const int* n_valid, const float* dft, const float* mel, float* out,
           int batch, long long num_samples, int num_frames, int hop, cudaStream_t stream) {
  const size_t smem = smem_bytes<G>(hop);
  cudaError_t err = cudaFuncSetAttribute(
      pann_logmel_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + G::TILE_T - 1) / G::TILE_T, batch);
  pann_logmel_kernel<G><<<grid, THREADS, smem, stream>>>(
      wave, n_valid, reinterpret_cast<const float2*>(dft), mel, out, num_samples, num_frames, hop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row length of the DFT operand the host builds for this n_fft; 0 if the
// kernel has no instantiation for it.
int pann_logmel_nbin_pad(int n_fft) {
  switch (n_fft) {
    case 256: return G256::NBIN_PAD;
    case 512: return G512::NBIN_PAD;
    case 1024: return G1024::NBIN_PAD;
    default: return 0;
  }
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok;
// cudaErrorInvalidValue for an n_fft without an instantiation or a hop
// outside (0, n_fft]). Does not synchronise and allocates nothing.
int pann_logmel_launch(const float* wave, const int* n_valid, const float* dft, const float* mel,
                       float* out, int batch, long long num_samples, int num_frames, int n_fft,
                       int hop, void* stream) {
  if (batch <= 0 || num_frames <= 0) return 0;
  if (hop <= 0 || hop > n_fft) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 256: return launch<G256>(wave, n_valid, dft, mel, out, batch, num_samples, num_frames, hop, s);
    case 512: return launch<G512>(wave, n_valid, dft, mel, out, batch, num_samples, num_frames, hop, s);
    case 1024: return launch<G1024>(wave, n_valid, dft, mel, out, batch, num_samples, num_frames, hop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
