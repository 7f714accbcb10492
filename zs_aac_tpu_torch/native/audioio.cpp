// Native WAV decode + resample for the embedding pipeline's host-side data
// loading (the reference uses librosa, i.e. C accelerated decode under
// Python, in the reference's data_handing/embeddings_generator.py).
//
// Exports a single C ABI entry point used via ctypes:
//   long decode_wav_resample(const char* path, int target_sr,
//                            float* out, long capacity);
// Returns the number of mono float32 samples written at target_sr, or -1.
//
// Resampling: 32-tap Kaiser-windowed sinc polyphase, matching librosa's
// 'polyphase' quality class. Mono mix: channel average.
//
// Build: zs_aac_tpu_torch/native/build.sh  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <map>
#include <mutex>
#include <numeric>
#include <vector>

namespace {

struct Wav {
    int sr = 0;
    int channels = 0;
    std::vector<float> samples;  // interleaved
};

bool read_wav(const char* path, Wav& w) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    char riff[4], wave[4];
    uint32_t riff_size;
    if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
        fread(&riff_size, 4, 1, f) != 1 ||
        fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4)) {
        fclose(f);
        return false;
    }
    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t sr = 0;
    bool got_fmt = false;
    while (true) {
        char id[4];
        uint32_t size;
        if (fread(id, 1, 4, f) != 4 || fread(&size, 4, 1, f) != 1) break;
        if (!memcmp(id, "fmt ", 4)) {
            uint8_t buf[40];
            uint32_t n = size < sizeof(buf) ? size : (uint32_t)sizeof(buf);
            if (fread(buf, 1, n, f) != n) break;
            if (size > n) fseek(f, size - n, SEEK_CUR);
            fmt = buf[0] | (buf[1] << 8);
            channels = buf[2] | (buf[3] << 8);
            sr = buf[4] | (buf[5] << 8) | (buf[6] << 16) | ((uint32_t)buf[7] << 24);
            bits = buf[14] | (buf[15] << 8);
            if (fmt == 0xFFFE && size >= 40) fmt = buf[24] | (buf[25] << 8);
            got_fmt = true;
        } else if (!memcmp(id, "data", 4)) {
            if (!got_fmt) break;
            std::vector<uint8_t> raw(size);
            if (fread(raw.data(), 1, size, f) != size) break;
            size_t bytes_per = bits / 8;
            size_t n = size / bytes_per;
            w.samples.resize(n);
            const uint8_t* p = raw.data();
            if (fmt == 1 && bits == 16) {
                for (size_t i = 0; i < n; i++)
                    w.samples[i] = (float)((int16_t)(p[2 * i] | (p[2 * i + 1] << 8))) / 32768.0f;
            } else if (fmt == 1 && bits == 24) {
                for (size_t i = 0; i < n; i++) {
                    int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
                    if (v >= (1 << 23)) v -= (1 << 24);
                    w.samples[i] = (float)v / 8388608.0f;
                }
            } else if (fmt == 1 && bits == 32) {
                for (size_t i = 0; i < n; i++) {
                    int32_t v;
                    memcpy(&v, p + 4 * i, 4);
                    w.samples[i] = (float)v / 2147483648.0f;
                }
            } else if (fmt == 3 && bits == 32) {
                for (size_t i = 0; i < n; i++)
                    memcpy(&w.samples[i], p + 4 * i, 4);
            } else if (fmt == 1 && bits == 8) {
                for (size_t i = 0; i < n; i++)
                    w.samples[i] = ((float)p[i] - 128.0f) / 128.0f;
            } else {
                fclose(f);
                return false;
            }
            w.sr = (int)sr;
            w.channels = channels;
            fclose(f);
            return true;
        } else {
            fseek(f, (long)size + (size & 1), SEEK_CUR);
        }
    }
    fclose(f);
    return false;
}

double bessel_i0(double x) {
    double s = 1.0, t = 1.0;
    for (int k = 1; k < 32; k++) {
        t *= (x / (2.0 * k)) * (x / (2.0 * k));
        s += t;
        if (t < 1e-12 * s) break;
    }
    return s;
}

constexpr int HALF = 16;
constexpr double BETA = 8.6;
constexpr int TAPS = 2 * HALF;  // k in [-HALF+1, HALF]

double tap_weight(double d, double cutoff, double denom) {
    double t = d / HALF;
    if (t < -1.0 || t > 1.0) return 0.0;
    double sinc = d == 0.0 ? 1.0 : sin(M_PI * cutoff * d) / (M_PI * cutoff * d);
    double win = bessel_i0(BETA * sqrt(1.0 - t * t)) / denom;
    return cutoff * sinc * win;
}

// Precomputed polyphase weights: for a rational ratio sr_in/sr_out = M/L
// (after gcd), output o reads from src = o*M/L, whose fractional part
// cycles through exactly L phases — the Kaiser-sinc weights depend only on
// that phase. The first implementation evaluated sin + sqrt + a full
// Bessel-I0 series per tap per OUTPUT SAMPLE (~0.5 s for 10 s of 44.1k
// audio on one host core — the whole bank-build pipeline was host-bound on
// it); the table turns the hot loop into a 32-tap dot product.
struct PolyTable {
    std::vector<double> w;     // [L][TAPS], tap k-(-HALF+1) at phase p
    std::vector<double> wsum;  // [L]
};

std::mutex g_table_mu;
std::map<std::pair<int, int>, PolyTable> g_tables;

const PolyTable* poly_table(long L, double cutoff, int sr_in, int sr_out) {
    if (L > (1L << 16)) return nullptr;  // degenerate ratio: fall back
    std::lock_guard<std::mutex> lock(g_table_mu);
    auto key = std::make_pair(sr_in, sr_out);
    auto it = g_tables.find(key);
    if (it != g_tables.end()) return &it->second;
    const double denom = bessel_i0(BETA);
    PolyTable t;
    t.w.resize((size_t)L * TAPS);
    t.wsum.resize((size_t)L);
    for (long p = 0; p < L; p++) {
        double frac = (double)p / (double)L;   // src - base
        double sum = 0.0;
        for (int k = -HALF + 1; k <= HALF; k++) {
            double wgt = tap_weight(frac - (double)k, cutoff, denom);
            t.w[(size_t)p * TAPS + (k + HALF - 1)] = wgt;
            sum += wgt;
        }
        t.wsum[(size_t)p] = sum;
    }
    return &g_tables.emplace(key, std::move(t)).first->second;
}

// Kaiser-windowed sinc resampler (beta=8.6, 32 taps per phase).
std::vector<float> resample_sinc(const std::vector<float>& x, int sr_in, int sr_out) {
    if (sr_in == sr_out) return x;
    const double cutoff = sr_out < sr_in ? (double)sr_out / sr_in : 1.0;
    const double denom = bessel_i0(BETA);
    long n_out = (long)((double)x.size() * sr_out / sr_in);
    std::vector<float> y((size_t)n_out);
    long g = std::gcd((long)sr_in, (long)sr_out);
    long L = sr_out / g, M = sr_in / g;
    const PolyTable* tab = poly_table(L, cutoff, sr_in, sr_out);
    const long n = (long)x.size();
    for (long o = 0; o < n_out; o++) {
        long num = o * M;
        long base = num / L;
        long phase = num - base * L;
        double acc = 0.0, wsum = 0.0;
        if (tab && base >= HALF && base + HALF < n) {
            // interior fast path: pure 32-tap dot against the phase row
            const double* w = &tab->w[(size_t)phase * TAPS];
            const float* xs = &x[(size_t)(base - HALF + 1)];
            for (int k = 0; k < TAPS; k++) acc += w[k] * xs[k];
            wsum = tab->wsum[(size_t)phase];
        } else {
            double src = (double)num / (double)L;
            for (int k = -HALF + 1; k <= HALF; k++) {
                long idx = base + k;
                if (idx < 0 || idx >= n) continue;
                double wgt = tap_weight(src - (double)idx, cutoff, denom);
                acc += wgt * x[(size_t)idx];
                wsum += wgt;
            }
        }
        y[(size_t)o] = wsum > 0 ? (float)(acc / wsum * cutoff) : 0.0f;
    }
    // normalize the passband gain: the weight normalization above already
    // keeps DC at unity; remove the extra cutoff factor applied twice.
    if (cutoff != 1.0) {
        for (auto& v : y) v = v / (float)cutoff;
    }
    return y;
}

}  // namespace

extern "C" long decode_wav_resample(const char* path, int target_sr,
                                    float* out, long capacity) {
    Wav w;
    if (!read_wav(path, w) || w.channels <= 0 || w.sr <= 0) return -1;
    // mono mix
    std::vector<float> mono;
    if (w.channels == 1) {
        mono = std::move(w.samples);
    } else {
        size_t frames = w.samples.size() / w.channels;
        mono.resize(frames);
        for (size_t i = 0; i < frames; i++) {
            float acc = 0.0f;
            for (int c = 0; c < w.channels; c++) acc += w.samples[i * w.channels + c];
            mono[i] = acc / (float)w.channels;
        }
    }
    std::vector<float> res = resample_sinc(mono, w.sr, target_sr);
    if ((long)res.size() > capacity) return -1;
    memcpy(out, res.data(), res.size() * sizeof(float));
    return (long)res.size();
}
