// Native table engine: associated-Legendre and Wigner-d recurrences.
//
// The framework's counterpart of the reference's Cython hot-loop module
// (reference: variance_expension.pyx, built by setup.py) — here the hot
// host-side work is the fp64 operator-table precompute that feeds the
// device Legendre tensors (SURVEY.md 2.2 item 1/5).  Same recurrences as
// gibbssampler/sht/legendre.py (the numpy reference implementation and
// fallback); OpenMP over m.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC tables.cpp -o libgibbstables.so
// Exposed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// lambda_lm(x): orthonormal spherical-harmonic latitude functions.
// out layout: [m, l, r] with shape (lmax+1, lmax+1, nr); l < m entries 0.
void gs_legendre_table(int lmax, int nr, const double* x, double* out) {
    const int L = lmax + 1;
    const double inv4pi = 1.0 / (4.0 * M_PI);
    std::memset(out, 0, sizeof(double) * (size_t)L * L * nr);

    // prefix log of the lambda_mm iteration coefficients:
    // lambda_mm = sqrt(1/4pi) * (-1)^m * sx^m * prod_{mm<m} sqrt((2mm+3)/(2mm+2))
    std::vector<double> logpre(L, 0.0);
    for (int mm = 0; mm + 1 < L; ++mm)
        logpre[mm + 1] = logpre[mm]
            + 0.5 * std::log((2.0 * mm + 3.0) / (2.0 * mm + 2.0));
    std::vector<double> logsx(nr);
    for (int r = 0; r < nr; ++r) {
        const double sx = std::sqrt(std::fmax(0.0, 1.0 - x[r] * x[r]));
        logsx[r] = sx > 0.0 ? std::log(sx) : -1e30;
    }

#pragma omp parallel for schedule(dynamic, 1)
    for (int m = 0; m < L; ++m) {
        double* blk = out + ((size_t)m * L) * nr;   // [l][r] rows, contiguous in r
        double* lmm = blk + (size_t)m * nr;
        const double sgn = (m % 2 == 0) ? 1.0 : -1.0;
        const double base = 0.5 * std::log(inv4pi) + logpre[m];
        for (int r = 0; r < nr; ++r)
            lmm[r] = sgn * std::exp(base + m * logsx[r]);
        if (m + 1 < L) {
            double* l1 = blk + (size_t)(m + 1) * nr;
            const double c = std::sqrt(2.0 * m + 3.0);
            for (int r = 0; r < nr; ++r) l1[r] = x[r] * c * lmm[r];
            for (int l = m + 2; l < L; ++l) {
                const double a = std::sqrt((4.0 * l * l - 1.0)
                                           / ((double)l * l - (double)m * m));
                const double b = std::sqrt((((l - 1.0) * (l - 1.0)) - (double)m * m)
                                           / (4.0 * (l - 1.0) * (l - 1.0) - 1.0));
                const double* p1 = blk + (size_t)(l - 1) * nr;
                const double* p2 = blk + (size_t)(l - 2) * nr;
                double* pl = blk + (size_t)l * nr;
                for (int r = 0; r < nr; ++r)
                    pl[r] = a * (x[r] * p1[r] - b * p2[r]);
            }
        }
    }
}

static double d_top_row(int j, int mp, double beta) {
    // d^j_{j, mp}(beta) via log-space magnitudes (underflow -> 0 is benign)
    const double c = std::cos(beta / 2.0);
    const double s = std::sin(beta / 2.0);
    const double lognorm = 0.5 * (std::lgamma(2.0 * j + 1.0)
                                  - std::lgamma((double)j + mp + 1.0)
                                  - std::lgamma((double)j - mp + 1.0));
    double logmag = lognorm;
    if (j + mp > 0) {
        if (c <= 0.0) return 0.0;
        logmag += (j + mp) * std::log(c);
    }
    if (j - mp > 0) {
        if (s <= 0.0) return 0.0;
        logmag += (j - mp) * std::log(s);
    }
    const double sign = ((j - mp) % 2 == 0) ? 1.0 : -1.0;
    return sign * std::exp(logmag);
}

// d^l_{m, s}(beta) for m = 0..lmax; out layout [m, l, r], (lmax+1, lmax+1, nr)
void gs_wigner_d_table(int lmax, int s, int nr, const double* beta,
                       double* out) {
    const int L = lmax + 1;
    const int sa = s < 0 ? -s : s;
    std::memset(out, 0, sizeof(double) * (size_t)L * L * nr);
    std::vector<double> xv(nr);
    for (int r = 0; r < nr; ++r) xv[r] = std::cos(beta[r]);
    const double* xr_ = xv.data();

#pragma omp parallel for schedule(dynamic, 1)
    for (int m = 0; m < L; ++m) {
        const int l0 = m > sa ? m : sa;
        if (l0 > lmax) continue;
        double* blk = out + ((size_t)m * L) * nr;
        double* seed_row = blk + (size_t)l0 * nr;
        for (int r = 0; r < nr; ++r) {
            const double b = beta[r];
            if (m >= sa) {
                seed_row[r] = d_top_row(m, s, b);
            } else if (s >= 0) {
                const double sign = ((m - s) % 2 == 0) ? 1.0 : -1.0;
                seed_row[r] = sign * d_top_row(s, m, b);
            } else {
                seed_row[r] = d_top_row(sa, -m, b);
            }
        }
        // upward recurrence, vectorized over r (prev row l0-1 is zero)
        for (int l = l0; l < lmax; ++l) {
            const double* pl = blk + (size_t)l * nr;
            const double* pm1 = (l > l0) ? blk + (size_t)(l - 1) * nr : nullptr;
            double* pn = blk + (size_t)(l + 1) * nr;
            if (l == 0) {
                for (int r = 0; r < nr; ++r) pn[r] = xr_[r] * pl[r];
                continue;
            }
            const double lm2 = std::fmax((double)l * l - (double)m * m, 0.0);
            const double ls2 = std::fmax((double)l * l - (double)s * s, 0.0);
            const double cprev = (l + 1.0) * std::sqrt(lm2 * ls2);
            const double den = l * std::sqrt(
                (((double)l + 1.0) * (l + 1.0) - (double)m * m)
                * (((double)l + 1.0) * (l + 1.0) - (double)s * s));
            const double c1 = (2.0 * l + 1.0) * (double)l * (l + 1.0) / den;
            const double c2 = (2.0 * l + 1.0) * (double)m * s / den;
            const double c3 = cprev / den;
            if (pm1) {
                for (int r = 0; r < nr; ++r)
                    pn[r] = (c1 * xr_[r] - c2) * pl[r] - c3 * pm1[r];
            } else {
                for (int r = 0; r < nr; ++r)
                    pn[r] = (c1 * xr_[r] - c2) * pl[r];
            }
        }
    }
}

}  // extern "C"
