// Fast whitespace-delimited float parser for ShapeNet-Part .txt files.
//
// Replaces np.loadtxt in the dataset pack step (reference hot loop #4,
// SURVEY.md §3: per-item np.loadtxt of ~20k x 7 floats dominates first-epoch
// time). np.loadtxt runs ~1-2 MB/s through Python tokenization; this parser
// streams the file once with a branch-light float scanner (~hundreds of
// MB/s), cutting the one-time ShapeNet pack from tens of minutes to seconds.
//
// C ABI (used via ctypes from difffacto_torch/native/__init__.py):
//   parse_floats(path, out_buf, max_vals) -> number of floats written, or
//     -1 on open failure, -2 if the buffer is too small.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

long parse_floats(const char* path, float* out, long max_vals) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) {
        fclose(f);
        return -1;
    }
    long rd = (long)fread(buf, 1, size, f);
    fclose(f);
    buf[rd] = '\0';

    // Hand-rolled decimal float scanner: no locale, no errno, one pass.
    // Exact for the fixed-decimal notation ShapeNet files use; falls back to
    // strtof only for exotic tokens (hex, inf/nan).
    static const double kPow10[] = {
        1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
        1e13, 1e14, 1e15, 1e16, 1e17, 1e18,
    };
    long n = 0;
    char* p = buf;
    char* end = buf + rd;
    while (p < end) {
        char c = *p;
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',') {
            ++p;
            continue;
        }
        bool neg = false;
        if (c == '-' || c == '+') {
            neg = (c == '-');
            ++p;
        }
        unsigned long long mant = 0;
        int frac_digits = 0;
        int digits = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            mant = mant * 10 + (unsigned)(*p - '0');
            ++digits;
            ++p;
        }
        if (p < end && *p == '.') {
            ++p;
            while (p < end && *p >= '0' && *p <= '9') {
                if (digits < 18) {
                    mant = mant * 10 + (unsigned)(*p - '0');
                    ++frac_digits;
                    ++digits;
                }
                ++p;
            }
        }
        if (digits == 0) {  // not a plain number: skip token
            while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
                ++p;
            continue;
        }
        double v = (double)mant;
        if (p < end && (*p == 'e' || *p == 'E')) {
            ++p;
            bool eneg = false;
            if (p < end && (*p == '-' || *p == '+')) {
                eneg = (*p == '-');
                ++p;
            }
            int ex = 0;
            while (p < end && *p >= '0' && *p <= '9') {
                ex = ex * 10 + (*p - '0');
                ++p;
            }
            int total = eneg ? -(ex + frac_digits) : ex - frac_digits;
            if (total >= 0 && total <= 18)
                v *= kPow10[total];
            else if (total < 0 && total >= -18)
                v /= kPow10[-total];
            else {
                // |exponent| > 18: rare; step through in chunks of 1e18
                while (total > 18) { v *= 1e18; total -= 18; }
                while (total < -18) { v /= 1e18; total += 18; }
                v = total >= 0 ? v * kPow10[total] : v / kPow10[-total];
            }
        } else if (frac_digits > 0) {
            v /= kPow10[frac_digits];
        }
        if (n >= max_vals) {
            free(buf);
            return -2;
        }
        out[n++] = neg ? (float)-v : (float)v;
    }
    free(buf);
    return n;
}

}  // extern "C"
