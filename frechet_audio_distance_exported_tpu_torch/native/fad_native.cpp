// Native host runtime for the TPU FAD framework.
//
// The reference leans on C internals of soundfile/resampy/numba for its host
// data path (SURVEY.md §2); this library is the equivalent for this
// framework: the Kaiser-sinc polyphase resampler inner loop (the exact
// table-interpolation algorithm of ops/resample.py) and PCM decode + channel
// mixdown, both OpenMP-parallel. Loaded via ctypes (native/__init__.py);
// everything has a NumPy fallback, so this is a pure acceleration layer.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC fad_native.cpp -o fad_native.so

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// Kaiser-windowed sinc resampling: for each output sample t, accumulate both
// filter wings through the linearly-interpolated half-filter table.
// Mirrors ops/resample.py::_resample_1d (itself resampy-parity).
void resample_kaiser(const double* x, int64_t n_in, int64_t n_out,
                     double sample_ratio, const double* win,
                     const double* delta, int64_t nwin, int64_t num_table,
                     double* y) {
    const double scale = sample_ratio < 1.0 ? sample_ratio : 1.0;
    const int64_t index_step = (int64_t)(scale * (double)num_table);
    const double time_increment = 1.0 / sample_ratio;

#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < n_out; ++t) {
        const double time_register = (double)t * time_increment;
        const int64_t n = (int64_t)time_register;
        double acc = 0.0;

        // Left wing.
        double frac = scale * (time_register - (double)n);
        double index_frac = frac * (double)num_table;
        int64_t offset = (int64_t)index_frac;
        double eta = index_frac - (double)offset;
        int64_t i_max = n + 1;
        const int64_t left_cap = (nwin - offset) / index_step;
        if (left_cap < i_max) i_max = left_cap;
        for (int64_t i = 0; i < i_max; ++i) {
            const int64_t idx = offset + i * index_step;
            const double weight = win[idx] + eta * delta[idx];
            acc += weight * x[n - i];
        }

        // Right wing.
        frac = scale - frac;
        index_frac = frac * (double)num_table;
        offset = (int64_t)index_frac;
        eta = index_frac - (double)offset;
        int64_t k_max = n_in - n - 1;
        const int64_t right_cap = (nwin - offset) / index_step;
        if (right_cap < k_max) k_max = right_cap;
        for (int64_t k = 0; k < k_max; ++k) {
            const int64_t idx = offset + k * index_step;
            const double weight = win[idx] + eta * delta[idx];
            acc += weight * x[n + k + 1];
        }

        y[t] = acc;
    }
}

// Interleaved int16 PCM -> float32 in [-1, 1), optional channel mean-mix.
// channels == 1 output when mixdown != 0, else interleaved passthrough shape.
void pcm16_to_f32(const int16_t* in, int64_t frames, int32_t channels,
                  int32_t mixdown, float* out) {
    const float inv = 1.0f / 32768.0f;
    if (channels == 1 || !mixdown) {
        const int64_t n = frames * channels;
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) out[i] = (float)in[i] * inv;
    } else {
        const float chinv = 1.0f / (float)channels;
#pragma omp parallel for schedule(static)
        for (int64_t f = 0; f < frames; ++f) {
            float acc = 0.0f;
            for (int32_t c = 0; c < channels; ++c)
                acc += (float)in[f * channels + c];
            out[f] = acc * inv * chinv;
        }
    }
}

// Interleaved int32 / 24-bit-in-32 PCM -> float32.
void pcm32_to_f32(const int32_t* in, int64_t frames, int32_t channels,
                  int32_t mixdown, float* out) {
    const double inv = 1.0 / 2147483648.0;
    if (channels == 1 || !mixdown) {
        const int64_t n = frames * channels;
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) out[i] = (float)((double)in[i] * inv);
    } else {
        const double chinv = 1.0 / (double)channels;
#pragma omp parallel for schedule(static)
        for (int64_t f = 0; f < frames; ++f) {
            double acc = 0.0;
            for (int32_t c = 0; c < channels; ++c)
                acc += (double)in[f * channels + c];
            out[f] = (float)(acc * inv * chinv);
        }
    }
}

int32_t fad_native_abi_version() { return 1; }

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC hot loops (utils/flac.py keeps the pure-Python fallback): MSB-first
// bit reader, partitioned-Rice residual decode, and FIXED/LPC reconstruction.
// Per-sample work in Python costs ~1 us/op; these loops run at memory speed.
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t bitpos;  // absolute bit index from the start of `data`

    inline int64_t bits_left() const { return nbytes * 8 - bitpos; }

    inline uint64_t read_uint(int n) {  // n <= 57
        uint64_t v = 0;
        int64_t byte = bitpos >> 3;
        int off = (int)(bitpos & 7);
        bitpos += n;
        int take = n;
        // Load up to 8 bytes starting at `byte` (big-endian), shift out `off`.
        uint64_t acc = 0;
        int avail = 0;
        while (avail < off + take && byte < nbytes && avail < 64) {
            acc = (acc << 8) | data[byte++];
            avail += 8;
        }
        // acc holds `avail` bits; we want bits [off, off+take).
        v = (acc >> (avail - off - take)) & ((take == 64) ? ~0ULL : ((1ULL << take) - 1));
        return v;
    }

    inline int64_t read_unary() {
        int64_t count = 0;
        while (bitpos < nbytes * 8) {
            int64_t byte = bitpos >> 3;
            int off = (int)(bitpos & 7);
            uint8_t rest = (uint8_t)(data[byte] << off);
            if (rest == 0) {
                count += 8 - off;
                bitpos += 8 - off;
            } else {
                int lead = __builtin_clz((uint32_t)rest) - 24;  // zeros before the 1
                count += lead;
                bitpos += lead + 1;  // consume zeros + terminator
                return count;
            }
        }
        return -1;  // truncated stream
    }
};

extern "C" {

// Decode one subframe's partitioned-Rice residuals (zigzag undone) starting
// at `bit_pos`. Returns the new bit position, or -1 on error/truncation.
int64_t flac_rice_residuals(const uint8_t* data, int64_t nbytes, int64_t bit_pos,
                            int32_t block_size, int32_t order, int64_t* out) {
    BitReader br{data, nbytes, bit_pos};
    if (br.bits_left() < 6) return -1;
    int method = (int)br.read_uint(2);
    if (method > 1) return -1;
    int param_bits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0xF : 0x1F;
    int part_order = (int)br.read_uint(4);
    int64_t n_parts = 1LL << part_order;
    if (block_size % n_parts) return -1;
    int64_t part_len = block_size >> part_order;
    if (part_len <= order && part_order > 0) return -1;
    int64_t idx = 0;
    for (int64_t p = 0; p < n_parts; ++p) {
        int64_t n = part_len - (p == 0 ? order : 0);
        if (br.bits_left() < param_bits) return -1;
        int param = (int)br.read_uint(param_bits);
        if (param == escape) {
            if (br.bits_left() < 5) return -1;
            int raw_bits = (int)br.read_uint(5);
            for (int64_t i = 0; i < n; ++i) {
                if (br.bits_left() < raw_bits) return -1;
                if (raw_bits == 0) { out[idx++] = 0; continue; }
                uint64_t v = br.read_uint(raw_bits);
                int64_t s = (int64_t)v;
                if (v >= (1ULL << (raw_bits - 1))) s -= (1LL << raw_bits);
                out[idx++] = s;
            }
        } else {
            for (int64_t i = 0; i < n; ++i) {
                int64_t q = br.read_unary();
                if (q < 0 || br.bits_left() < param) return -1;
                uint64_t v = ((uint64_t)q << param) | (param ? br.read_uint(param) : 0);
                out[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
            }
        }
    }
    return br.bitpos;
}

// In-place FIXED-predictor reconstruction: x[0:order] are warmup samples,
// x[order:n] hold residuals on entry and samples on exit.
void flac_reconstruct_fixed(int64_t* x, int64_t n, int32_t order) {
    switch (order) {
        case 0: break;
        case 1:
            for (int64_t i = 1; i < n; ++i) x[i] += x[i - 1];
            break;
        case 2:
            for (int64_t i = 2; i < n; ++i) x[i] += 2 * x[i - 1] - x[i - 2];
            break;
        case 3:
            for (int64_t i = 3; i < n; ++i)
                x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
            break;
        case 4:
            for (int64_t i = 4; i < n; ++i)
                x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
            break;
    }
}

// In-place LPC reconstruction with quantized coefficients.
void flac_reconstruct_lpc(int64_t* x, int64_t n, int32_t order,
                          const int32_t* coefs, int32_t shift) {
    for (int64_t i = order; i < n; ++i) {
        int64_t acc = 0;
        for (int32_t j = 0; j < order; ++j) acc += (int64_t)coefs[j] * x[i - 1 - j];
        x[i] += acc >> shift;
    }
}

}  // extern "C" (FLAC section)
