// Native hot-loop helpers for the aigw-tpu data plane.
//
// The reference's data-plane hot path lives in C++ (the Envoy binary,
// SURVEY.md §2.8); the port's gateway is Python on the standard library
// with the byte-level inner loops implemented here: SSE event-boundary
// scanning over streamed chunks. Exposed with a plain C ABI for ctypes
// (aigw_tpu_torch/utils/native.py; built by aigw_tpu_torch/native/).
//
// Semantics are byte-exact with the Python loop of
// aigw_tpu_torch/translate/sse.py::SSEParser.feed:
// an event ends at the EARLIER of "\n\n" (2-byte sep) or "\r\n\r\n"
// (4-byte sep), searched from the current position.

#define _GNU_SOURCE 1
#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// Scan `buf[0..len)` for SSE event boundaries. Writes up to `max_events`
// (end_offset, sep_len) pairs into `out` (flattened). Returns the number
// of events found; `*tail` receives the offset where the unterminated
// remainder begins.
int aigw_sse_scan(const uint8_t* buf, size_t len, int32_t* out,
                  int max_events, size_t* tail) {
    static const uint8_t LFLF[] = {'\n', '\n'};
    static const uint8_t CRLF2[] = {'\r', '\n', '\r', '\n'};
    int n = 0;
    size_t pos = 0;
    while (pos < len && n < max_events) {
        const uint8_t* p = buf + pos;
        size_t rem = len - pos;
        const uint8_t* a = (const uint8_t*)memmem(p, rem, LFLF, 2);
        const uint8_t* b = (const uint8_t*)memmem(p, rem, CRLF2, 4);
        const uint8_t* hit;
        int sep;
        if (a == nullptr && b == nullptr) break;
        if (b == nullptr || (a != nullptr && a < b)) {
            hit = a; sep = 2;
        } else {
            hit = b; sep = 4;
        }
        size_t end = (size_t)(hit - buf);
        out[2 * n] = (int32_t)end;
        out[2 * n + 1] = sep;
        ++n;
        pos = end + (size_t)sep;
    }
    *tail = pos;
    return n;
}

}  // extern "C"
