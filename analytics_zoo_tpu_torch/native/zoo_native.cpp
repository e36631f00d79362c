// Native data-path kernels for the host-side runtime (a copy of
// analytics_zoo_tpu/native/zoo_native.cpp).
//
// What stays host-bound in the serving and input paths is record IO:
// CRC32C over every byte of a TFRecord frame, a durable stream log's
// frame or a metrics-history sample, and text->tensor parsing.  These
// are the C++ versions, exported with a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, at first use, by
// analytics_zoo_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slicing-by-8: ~8 bytes per table step vs the
// byte-at-a-time Python fallback.
// ---------------------------------------------------------------------------

static uint32_t kTable[8][256];
static bool kInit = false;

static void init_tables() {
    if (kInit) return;
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
        kTable[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = kTable[0][i];
        for (int t = 1; t < 8; ++t) {
            c = kTable[0][c & 0xFF] ^ (c >> 8);
            kTable[t][i] = c;
        }
    }
    kInit = true;
}

uint32_t zoo_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
    init_tables();
    crc ^= 0xFFFFFFFFu;
    while (n >= 8) {
        crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
               ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
        uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                      ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
        crc = kTable[7][crc & 0xFF] ^ kTable[6][(crc >> 8) & 0xFF] ^
              kTable[5][(crc >> 16) & 0xFF] ^ kTable[4][crc >> 24] ^
              kTable[3][hi & 0xFF] ^ kTable[2][(hi >> 8) & 0xFF] ^
              kTable[1][(hi >> 16) & 0xFF] ^ kTable[0][hi >> 24];
        data += 8;
        n -= 8;
    }
    while (n--) {
        crc = kTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    }
    return crc ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* data, uint64_t n) {
    uint32_t c = zoo_crc32c(data, n, 0);
    return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// TFRecord scan: walk the framing of a whole file buffer, validate both
// CRCs per record, and emit (offset, length) pairs for zero-copy
// slicing on the Python side.
//
// Returns the record count, or -1 on corruption (err_off set to the
// offending byte offset).  offsets/lengths must hold max_records
// entries.
// ---------------------------------------------------------------------------

int64_t zoo_tfrecord_scan(const uint8_t* buf, uint64_t n,
                          uint64_t* offsets, uint64_t* lengths,
                          int64_t max_records, uint64_t* err_off) {
    uint64_t pos = 0;
    int64_t count = 0;
    while (pos < n) {
        if (n - pos < 12) { *err_off = pos; return -1; }
        uint64_t len;
        std::memcpy(&len, buf + pos, 8);
        uint32_t hcrc;
        std::memcpy(&hcrc, buf + pos + 8, 4);
        if (masked_crc(buf + pos, 8) != hcrc) { *err_off = pos; return -1; }
        // overflow-safe: a crafted len near 2^64 must not wrap past the
        // check and drive an out-of-bounds read
        uint64_t remaining = n - pos - 12;
        if (remaining < 4 || len > remaining - 4) {
            *err_off = pos;
            return -1;
        }
        uint32_t dcrc;
        std::memcpy(&dcrc, buf + pos + 12 + len, 4);
        if (masked_crc(buf + pos + 12, len) != dcrc) {
            *err_off = pos + 12;
            return -1;
        }
        if (count < max_records) {
            offsets[count] = pos + 12;
            lengths[count] = len;
        }
        ++count;
        pos += 12 + len + 4;
    }
    return count;
}

// ---------------------------------------------------------------------------
// Numeric CSV -> float32 row-major matrix.  Parses `rows x cols` floats
// separated by `sep`/newlines directly into the caller's buffer; one
// strtof pass, no intermediate Python objects.  Returns parsed row
// count, or -1 on malformed input (err_off set).
// ---------------------------------------------------------------------------

int64_t zoo_csv_to_f32(const char* buf, uint64_t n, char sep,
                       float* out, int64_t max_rows, int64_t cols,
                       uint64_t* err_off) {
    const char* p = buf;
    const char* end = buf + n;
    int64_t row = 0;
    while (p < end && row < max_rows) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        for (int64_t c = 0; c < cols; ++c) {
            // strtof would skip '\n' and silently merge rows: reject a
            // field that starts at end-of-line (trailing separator)
            while (p < end && *p == ' ') ++p;
            if (p >= end || *p == '\n' || *p == '\r') {
                *err_off = (uint64_t)(p - buf);
                return -1;
            }
            char* next = nullptr;
            float v = strtof(p, &next);
            if (next == p) { *err_off = (uint64_t)(p - buf); return -1; }
            out[row * cols + c] = v;
            p = next;
            if (c + 1 < cols) {
                if (p < end && *p == sep) ++p;
                else { *err_off = (uint64_t)(p - buf); return -1; }
            }
        }
        // consume to end of line
        while (p < end && *p != '\n') {
            if (*p != '\r' && *p != ' ') {
                *err_off = (uint64_t)(p - buf);
                return -1;
            }
            ++p;
        }
        ++row;
    }
    return row;
}

}  // extern "C"
