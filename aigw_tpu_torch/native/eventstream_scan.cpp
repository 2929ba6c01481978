// AWS event-stream (vnd.amazon.eventstream) frame boundary scanner with
// CRC validation — the Bedrock streaming hot loop's native half (the SSE
// scanner in sse_scan.cpp is the other). Byte-exact with the Python
// framing logic in aigw_tpu_torch/translate/eventstream.py.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <zlib.h>

extern "C" {

// Scan complete frames. For each frame writes (offset, total_len,
// headers_len) into `out` (flattened triples). Returns the frame count;
// `*tail` = offset of the first incomplete frame. Returns -1 on CRC or
// framing error (caller falls back / raises).
int aigw_es_scan(const uint8_t* buf, size_t len, int32_t* out,
                 int max_frames, size_t* tail) {
    int n = 0;
    size_t pos = 0;
    while (pos + 16 <= len && n < max_frames) {
        const uint8_t* p = buf + pos;
        uint32_t total_len = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
                           | ((uint32_t)p[2] << 8) | (uint32_t)p[3];
        uint32_t headers_len = ((uint32_t)p[4] << 24) | ((uint32_t)p[5] << 16)
                             | ((uint32_t)p[6] << 8) | (uint32_t)p[7];
        uint32_t prelude_crc = ((uint32_t)p[8] << 24) | ((uint32_t)p[9] << 16)
                             | ((uint32_t)p[10] << 8) | (uint32_t)p[11];
        if (total_len < 16 || headers_len > total_len - 16) {
            *tail = pos;
            return -1;
        }
        if (pos + total_len > len) break;  // incomplete frame
        if ((uint32_t)crc32(0, p, 8) != prelude_crc) {
            *tail = pos;
            return -1;
        }
        uint32_t msg_crc = ((uint32_t)p[total_len - 4] << 24)
                         | ((uint32_t)p[total_len - 3] << 16)
                         | ((uint32_t)p[total_len - 2] << 8)
                         | (uint32_t)p[total_len - 1];
        if ((uint32_t)crc32(0, p, total_len - 4) != msg_crc) {
            *tail = pos;
            return -1;
        }
        out[3 * n] = (int32_t)pos;
        out[3 * n + 1] = (int32_t)total_len;
        out[3 * n + 2] = (int32_t)headers_len;
        ++n;
        pos += total_len;
    }
    *tail = pos;
    return n;
}

}  // extern "C"
