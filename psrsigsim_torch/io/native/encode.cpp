// Native IO fast paths for the PSRFITS / pdv exit pipes.
//
// The reference's FITS encode runs through cfitsio (C); here the two
// host-side hot loops of the save paths (reference: io/psrfits.py:305-424,
// io/txtfile.py:39-92) get C++ equivalents:
//
//   pss_encode_subints_i2be  float32 (Nchan, nsamp) -> big-endian int16
//                            (nsub, npol=1, Nchan, nbin) with numpy
//                            .astype('>i2') cast semantics.
//   pss_format_pdv_block     pdv text lines "isub ichan ibin value \n" for
//                            one (subint, channel) block, byte-identical to
//                            CPython's "%s" formatting of np.float32.
//
// Built on demand by build.py (g++ -O3 -shared); loaded via ctypes — no
// pybind11 dependency.  Python fallbacks remain in io/psrfits.py and
// io/txtfile.py; tests assert byte parity between the two paths.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }

// numpy float32 -> int16 cast semantics on x86: cvttss2si to int32
// (out-of-range / NaN => INT32_MIN), then truncate to the low 16 bits.
inline int16_t cast_i16(float v) {
    int32_t t;
    if (std::isnan(v) || v >= 2147483648.0f || v < -2147483648.0f) {
        t = INT32_MIN;
    } else {
        t = static_cast<int32_t>(v);
    }
    return static_cast<int16_t>(static_cast<uint16_t>(t & 0xFFFF));
}

// Format one float32 exactly as CPython renders str(np.float32(v)):
// shortest round-trip digits (dragon4/ryu agree); positional when
// v == 0 or 1e-4 <= |v| < 1e16 (numpy's scalartypes rule — the comparison
// is on the promoted value, so float32(1e-4) = 9.9999997e-05 goes
// scientific), with a trailing ".0" for integral positional values;
// otherwise "d[.ddd]e±XX".  Returns bytes written.
int fmt_f32(float v, char* out) {
    char* p = out;
    if (std::isnan(v)) {
        std::memcpy(p, "nan", 3);
        return 3;
    }
    if (std::isinf(v)) {
        if (v < 0) { *p++ = '-'; }
        std::memcpy(p, "inf", 3);
        return static_cast<int>(p - out) + 3;
    }
    if (std::signbit(v)) {
        *p++ = '-';
        v = -v;
    }
    // shortest scientific form: "d[.ddd]e±XX"
    char sci[48];
    auto res = std::to_chars(sci, sci + sizeof(sci), v,
                             std::chars_format::scientific);
    // parse digits + exponent
    char digits[40];
    int ndig = 0;
    int exp10 = 0;
    {
        char* q = sci;
        for (; q < res.ptr && *q != 'e'; ++q) {
            if (*q != '.') digits[ndig++] = *q;
        }
        ++q;  // 'e'
        bool neg = (*q == '-');
        ++q;  // sign
        for (; q < res.ptr; ++q) exp10 = exp10 * 10 + (*q - '0');
        if (neg) exp10 = -exp10;
    }
    // strip trailing zeros (to_chars never emits them, but be safe)
    while (ndig > 1 && digits[ndig - 1] == '0') --ndig;

    double a = static_cast<double>(v);
    if (v == 0.0f || (a >= 1e-4 && a < 1e16)) {
        // positional
        if (exp10 >= 0) {
            int ipart = exp10 + 1;  // digits before the point
            for (int i = 0; i < ipart; ++i)
                *p++ = (i < ndig) ? digits[i] : '0';
            *p++ = '.';
            if (ndig > ipart) {
                for (int i = ipart; i < ndig; ++i) *p++ = digits[i];
            } else {
                *p++ = '0';
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -exp10 - 1; ++i) *p++ = '0';
            for (int i = 0; i < ndig; ++i) *p++ = digits[i];
        }
    } else {
        // scientific: "d[.ddd]e±XX" (exponent >= 2 digits, always signed)
        *p++ = digits[0];
        if (ndig > 1) {
            *p++ = '.';
            for (int i = 1; i < ndig; ++i) *p++ = digits[i];
        }
        *p++ = 'e';
        int e = exp10;
        *p++ = (e < 0) ? '-' : '+';
        if (e < 0) e = -e;
        char eb[8];
        int ne = 0;
        do { eb[ne++] = static_cast<char>('0' + e % 10); e /= 10; } while (e);
        while (ne < 2) eb[ne++] = '0';
        for (int i = ne - 1; i >= 0; --i) *p++ = eb[i];
    }
    return static_cast<int>(p - out);
}

inline char* put_i64(int64_t v, char* p) {
    if (v == 0) { *p++ = '0'; return p; }
    if (v < 0) { *p++ = '-'; v = -v; }
    char b[24];
    int n = 0;
    while (v) { b[n++] = static_cast<char>('0' + v % 10); v /= 10; }
    for (int i = n - 1; i >= 0; --i) *p++ = b[i];
    return p;
}

}  // namespace

extern "C" {

// float32 (Nchan, in_stride) -> '>i2' (nsub, 1, Nchan, nbin).
// Reads in[chan * in_stride + isub*nbin + bin]; matches
// data[:, :nsub*nbin].astype('>i2') reshaped per subint
// (reference layout: io/psrfits.py:352-361).
void pss_encode_subints_i2be(const float* in, int64_t nchan, int64_t nsub,
                             int64_t nbin, int64_t in_stride, int16_t* out) {
    for (int64_t s = 0; s < nsub; ++s) {
        for (int64_t c = 0; c < nchan; ++c) {
            const float* src = in + c * in_stride + s * nbin;
            int16_t* dst = out + (s * nchan + c) * nbin;
            for (int64_t b = 0; b < nbin; ++b) {
                dst[b] = static_cast<int16_t>(
                    bswap16(static_cast<uint16_t>(cast_i16(src[b]))));
            }
        }
    }
}

// pdv text lines for one (subint, channel) block:
//   "isub ichan ibin value \n"  for ibin in [0, nbin)
// Byte-identical to the Python fallback (io/txtfile.py).  Returns bytes
// written, or -1 if outcap would be exceeded (caller sizes generously).
int64_t pss_format_pdv_block(const float* row, int64_t nbin, int64_t isub,
                             int64_t ichan, char* out, int64_t outcap) {
    char* p = out;
    char* end = out + outcap;
    for (int64_t b = 0; b < nbin; ++b) {
        if (end - p < 96) return -1;
        p = put_i64(isub, p);
        *p++ = ' ';
        p = put_i64(ichan, p);
        *p++ = ' ';
        p = put_i64(b, p);
        *p++ = ' ';
        p += fmt_f32(row[b], p);
        *p++ = ' ';
        *p++ = '\n';
    }
    return p - out;
}

// Self-description for the ctypes loader's version check.
int pss_abi_version() { return 1; }

}  // extern "C"
