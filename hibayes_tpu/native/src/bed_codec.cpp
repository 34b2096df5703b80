// Native PLINK .bed codec + genotype column kernels.
//
// Host-bound data-path counterpart of the reference's Rcpp/OpenMP loader
// (reference: src/read_bed.cpp:97-232) and column statistics
// (src/tXXmat.cpp:43-98), rebuilt as a dependency-free shared library driven
// from Python via ctypes.  Decodes straight into the int8 layout the device
// ingestion path wants (individuals x SNPs, row-major), OpenMP across SNPs.
//
// Coding contract (matches R/read_plink.r:20): additive A1A1=2, A1A2=1,
// A2A2=0, missing=-9 (imputed to the per-SNP major genotype on request);
// dominant mode maps {A1A1,A2A2}->0, A1A2->1.

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline void setup_threads(int threads) {
#ifdef _OPENMP
    if (threads > 0) omp_set_num_threads(threads);
#else
    (void)threads;
#endif
}

// 2-bit code -> genotype, additive / dominant (read_bed.cpp:116-127)
const int8_t CODE_A[4] = {2, -9, 1, 0};
const int8_t CODE_D[4] = {0, -9, 1, 0};

}  // namespace

extern "C" {

// payload: m * ceil(n/4) bytes (SNP-major, no magic); out: (n, m) row-major.
void bed_decode(const uint8_t* payload, int64_t n, int64_t m, int8_t* out,
                int dominant, int threads) {
    setup_threads(threads);
    const int64_t bpsnp = (n + 3) / 4;
    const int8_t* code = dominant ? CODE_D : CODE_A;

    // expand the LUT to 256 x 4 once
    int8_t lut[256][4];
    for (int b = 0; b < 256; ++b)
        for (int x = 0; x < 4; ++x) lut[b][x] = code[(b >> (2 * x)) & 0x3];

#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) {
        const uint8_t* col = payload + j * bpsnp;
        int64_t i = 0;
        for (int64_t byte = 0; byte < bpsnp; ++byte) {
            const int8_t* g4 = lut[col[byte]];
            for (int x = 0; x < 4 && i < n; ++x, ++i) {
                out[i * m + j] = g4[x];
            }
        }
    }
}

// geno: (n, m) row-major int8; encode additive back to 2-bit SNP-major.
void bed_encode(const int8_t* geno, int64_t n, int64_t m, uint8_t* payload,
                int threads) {
    setup_threads(threads);
    const int64_t bpsnp = (n + 3) / 4;
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) {
        uint8_t* col = payload + j * bpsnp;
        std::memset(col, 0, bpsnp);
        for (int64_t i = 0; i < n; ++i) {
            int8_t g = geno[i * m + j];
            uint8_t c;
            switch (g) {
                case 2: c = 0b00; break;
                case -9: c = 0b01; break;
                case 1: c = 0b10; break;
                default: c = 0b11; break;  // 0
            }
            col[i / 4] |= c << (2 * (i % 4));
        }
    }
}

// In-place per-SNP major-genotype imputation (read_bed.cpp:182-230).
void impute_major(int8_t* geno, int64_t n, int64_t m, int threads) {
    setup_threads(threads);
#pragma omp parallel for schedule(dynamic)
    for (int64_t j = 0; j < m; ++j) {
        int64_t counts[3] = {0, 0, 0};
        bool any_missing = false;
        for (int64_t i = 0; i < n; ++i) {
            int8_t g = geno[i * m + j];
            if (g >= 0 && g <= 2) {
                counts[g]++;
            } else {
                any_missing = true;
            }
        }
        if (!any_missing) continue;
        int64_t best = 0;
        int8_t major = 0;
        for (int v = 0; v < 3; ++v) {
            if (counts[v] > best) {
                best = counts[v];
                major = static_cast<int8_t>(v);
            }
        }
        for (int64_t i = 0; i < n; ++i) {
            if (geno[i * m + j] < 0) geno[i * m + j] = major;
        }
    }
}

// Per-SNP mean / sum / sqrt(SSD) — BigStat (tXXmat.cpp:43-98).
void col_stats(const int8_t* geno, int64_t n, int64_t m, double* mean,
               double* sum, double* sqrt_ssd, int threads) {
    setup_threads(threads);
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) {
        int64_t s = 0;
        int64_t s2 = 0;
        for (int64_t i = 0; i < n; ++i) {
            int64_t g = geno[i * m + j];
            s += g;
            s2 += g * g;
        }
        double mu = static_cast<double>(s) / n;
        sum[j] = static_cast<double>(s);
        mean[j] = mu;
        double ssd = static_cast<double>(s2) - n * mu * mu;
        sqrt_ssd[j] = ssd > 0 ? __builtin_sqrt(ssd) : 0.0;
    }
}

}  // extern "C"
