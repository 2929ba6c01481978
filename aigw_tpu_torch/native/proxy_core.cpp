// aigw-core: native data-plane proxy for the aigw-tpu gateway.
//
// Plays the reference's Envoy role (SURVEY.md §2.8): the accept / parse /
// route / forward loop runs in C++, with the Python gateway as the
// "external processor" escape hatch. The config compiler
// (aigw_tpu_torch/config/nativecore.py) decides PER ROUTE RULE whether the
// native fast path is allowed:
//
//   - fast path: same-schema (passthrough) backends over plain HTTP with
//     static header auth — the core matches the model, picks a backend
//     (weighted, priority tiers), injects headers, forwards, and relays
//     the response bytes verbatim (unary, SSE, anything) with
//     retry/failover on connect errors and retriable statuses;
//   - everything else (cross-schema translation, token costs, quotas,
//     TLS upstreams, body mutations, MCP, GETs): relayed unchanged to
//     the Python gateway on the loopback fallback address, which stays
//     100% feature-complete. Native routing is an acceleration, never a
//     behavior change.
//
// Concurrency model: thread-per-connection with blocking sockets and
// thread-local upstream keep-alive pools. For the gateway's operating
// point (10^2..10^3 concurrent keep-alive connections, 10^4 rps/node)
// this is within a few percent of an event loop on Linux and is far
// simpler to make correct; horizontal scale mirrors the Python side's
// SO_REUSEPORT --workers story (multiple cores bind the same port).
//
// Secrets: auth header values are read from files (0600, the credential
// rotators' output) and re-read when the file mtime changes, so rotation
// behaves like the Python handlers' hot reload.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Minimal JSON (config files are machine-generated by the compiler; the
// parser also extracts the top-level "model" from request bodies, where
// a scan would be fooled by quoted text inside message content).
// ---------------------------------------------------------------------------

struct JValue {
    enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
    bool b = false;
    double num = 0;
    std::string str;
    std::vector<JValue> arr;
    std::vector<std::pair<std::string, JValue>> obj;

    const JValue* get(const std::string& k) const {
        for (auto& kv : obj)
            if (kv.first == k) return &kv.second;
        return nullptr;
    }
    std::string s(const std::string& k, const std::string& dflt = "") const {
        const JValue* v = get(k);
        return v && v->kind == STR ? v->str : dflt;
    }
    double n(const std::string& k, double dflt = 0) const {
        const JValue* v = get(k);
        return v && v->kind == NUM ? v->num : dflt;
    }
};

struct JParser {
    const char* p;
    const char* end;
    bool ok = true;
    int depth = 0;
    // Bodies are attacker-controlled (up to max_body); unbounded recursion
    // on {"a":[[[[... would overflow the thread stack and kill the listener.
    static constexpr int kMaxDepth = 64;
    struct DepthGuard {
        JParser* jp;
        explicit DepthGuard(JParser* j) : jp(j) {}
        ~DepthGuard() { jp->depth--; }
    };

    explicit JParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    }
    bool lit(const char* s) {
        size_t n = strlen(s);
        if (size_t(end - p) >= n && memcmp(p, s, n) == 0) { p += n; return true; }
        return false;
    }
    JValue parse() {
        ws();
        JValue v;
        if (p >= end || ++depth > kMaxDepth) { ok = false; return v; }
        DepthGuard dg(this);
        char c = *p;
        if (c == '{') {
            v.kind = JValue::OBJ;
            p++;
            ws();
            if (p < end && *p == '}') { p++; return v; }
            while (ok) {
                ws();
                JValue key = parse_string();
                ws();
                if (p >= end || *p != ':') { ok = false; break; }
                p++;
                JValue val = parse();
                v.obj.emplace_back(key.str, std::move(val));
                ws();
                if (p < end && *p == ',') { p++; continue; }
                if (p < end && *p == '}') { p++; break; }
                ok = false;
            }
        } else if (c == '[') {
            v.kind = JValue::ARR;
            p++;
            ws();
            if (p < end && *p == ']') { p++; return v; }
            while (ok) {
                v.arr.push_back(parse());
                ws();
                if (p < end && *p == ',') { p++; continue; }
                if (p < end && *p == ']') { p++; break; }
                ok = false;
            }
        } else if (c == '"') {
            v = parse_string();
        } else if (lit("true")) {
            v.kind = JValue::BOOL; v.b = true;
        } else if (lit("false")) {
            v.kind = JValue::BOOL; v.b = false;
        } else if (lit("null")) {
            v.kind = JValue::NUL;
        } else {
            v.kind = JValue::NUM;
            char* np = nullptr;
            v.num = strtod(p, &np);
            if (np == p) ok = false;
            p = np;
        }
        return v;
    }
    JValue parse_string() {
        JValue v;
        v.kind = JValue::STR;
        if (p >= end || *p != '"') { ok = false; return v; }
        p++;
        while (p < end && *p != '"') {
            if (*p == '\\' && p + 1 < end) {
                p++;
                switch (*p) {
                    case 'n': v.str += '\n'; break;
                    case 't': v.str += '\t'; break;
                    case 'r': v.str += '\r'; break;
                    case 'b': v.str += '\b'; break;
                    case 'f': v.str += '\f'; break;
                    case 'u': {
                        // \uXXXX → UTF-8 (surrogate pairs handled crudely:
                        // model names are ASCII in practice)
                        if (end - p >= 5) {
                            unsigned cp = 0;
                            sscanf(p + 1, "%4x", &cp);
                            p += 4;
                            if (cp < 0x80) {
                                v.str += char(cp);
                            } else if (cp < 0x800) {
                                v.str += char(0xC0 | (cp >> 6));
                                v.str += char(0x80 | (cp & 0x3F));
                            } else {
                                v.str += char(0xE0 | (cp >> 12));
                                v.str += char(0x80 | ((cp >> 6) & 0x3F));
                                v.str += char(0x80 | (cp & 0x3F));
                            }
                        } else { ok = false; }
                        break;
                    }
                    default: v.str += *p;
                }
            } else {
                v.str += *p;
            }
            p++;
        }
        if (p >= end) { ok = false; return v; }
        p++;  // closing quote
        return v;
    }
};

// ---------------------------------------------------------------------------
// Config
// ---------------------------------------------------------------------------

struct AuthHeader {
    std::string name;
    std::string prefix;      // e.g. "Bearer "
    std::string value;       // inline value, or
    std::string value_file;  // file to read (rotator output)
    // cached file read
    mutable std::mutex mu;
    mutable std::string cached;
    mutable time_t mtime = 0;

    std::string resolve() const {
        if (value_file.empty()) return prefix + value;
        struct stat st {};
        std::lock_guard<std::mutex> lock(mu);
        if (stat(value_file.c_str(), &st) == 0 && st.st_mtime != mtime) {
            std::ifstream f(value_file);
            std::string s((std::istreambuf_iterator<char>(f)),
                          std::istreambuf_iterator<char>());
            while (!s.empty() && (s.back() == '\n' || s.back() == '\r'))
                s.pop_back();
            cached = s;
            mtime = st.st_mtime;
        }
        return prefix + cached;
    }
};

namespace tls { static bool available(); }  // defined with the TLS layer

struct Backend {
    std::string host;
    int port = 80;
    int weight = 1;
    int priority = 0;
    std::vector<std::shared_ptr<AuthHeader>> auth_headers;
    std::vector<std::pair<std::string, std::string>> set_headers;
    std::vector<std::string> remove_headers;
    int read_timeout_s = 300;  // stream idle timeout
    std::string name;          // for stats
    // fallback relays keep the client's Host header (the Python gateway
    // scopes routes by hostname)
    bool preserve_host = false;
    bool tls = false;          // https upstream (verified, SNI = sni/host)
    std::string sni;           // override TLS server name (default host)
};

struct Rule {
    std::string model_exact;   // one of exact/prefix set
    std::string model_prefix;
    std::vector<std::string> hostnames;  // empty = any
    std::vector<Backend> backends;
};

struct CoreConfig {
    std::string listen_host = "0.0.0.0";
    int listen_port = 1975;
    std::string fallback_host = "127.0.0.1";
    int fallback_port = 1976;
    std::vector<std::string> endpoints;  // POST paths with model routing
    std::vector<Rule> rules;
    std::vector<int> retriable = {429, 500, 502, 503, 504};
    size_t max_body = 32u << 20;
    int max_retries = 3;
    std::string access_log_path;  // JSON lines for native requests
};

static CoreConfig g_cfg;

static bool load_config(const char* path) {
    std::ifstream f(path);
    if (!f) { fprintf(stderr, "aigw-core: cannot open %s\n", path); return false; }
    std::string text((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
    JParser jp(text);
    JValue root = jp.parse();
    if (!jp.ok || root.kind != JValue::OBJ) {
        fprintf(stderr, "aigw-core: bad config JSON\n");
        return false;
    }
    g_cfg.listen_host = root.s("listen_host", g_cfg.listen_host);
    g_cfg.listen_port = int(root.n("listen_port", g_cfg.listen_port));
    g_cfg.fallback_host = root.s("fallback_host", g_cfg.fallback_host);
    g_cfg.fallback_port = int(root.n("fallback_port", g_cfg.fallback_port));
    g_cfg.max_body = size_t(root.n("max_body", double(g_cfg.max_body)));
    g_cfg.max_retries = int(root.n("max_retries", g_cfg.max_retries));
    g_cfg.access_log_path = root.s("access_log_path", "");
    if (const JValue* v = root.get("retriable_statuses")) {
        g_cfg.retriable.clear();
        for (auto& e : v->arr) g_cfg.retriable.push_back(int(e.num));
    }
    if (const JValue* v = root.get("endpoints"))
        for (auto& e : v->arr) g_cfg.endpoints.push_back(e.str);
    if (const JValue* v = root.get("rules")) {
        for (auto& r : v->arr) {
            Rule rule;
            rule.model_exact = r.s("model_exact");
            rule.model_prefix = r.s("model_prefix");
            if (const JValue* h = r.get("hostnames")) {
                for (auto& e : h->arr) {
                    std::string hn = e.str;
                    for (auto& c : hn) c = char(tolower(c));
                    rule.hostnames.push_back(hn);
                }
            }
            if (const JValue* bs = r.get("backends")) {
                for (auto& b : bs->arr) {
                    Backend be;
                    be.host = b.s("host");
                    be.port = int(b.n("port", 80));
                    be.weight = int(b.n("weight", 1));
                    be.priority = int(b.n("priority", 0));
                    be.read_timeout_s = int(b.n("read_timeout_s", 300));
                    be.name = b.s("name");
                    if (const JValue* t = b.get("tls"))
                        be.tls = t->kind == JValue::BOOL && t->b;
                    be.sni = b.s("sni");
                    if (const JValue* ah = b.get("auth_headers")) {
                        for (auto& a : ah->arr) {
                            auto h = std::make_shared<AuthHeader>();
                            h->name = a.s("name");
                            h->prefix = a.s("prefix");
                            h->value = a.s("value");
                            h->value_file = a.s("value_file");
                            be.auth_headers.push_back(std::move(h));
                        }
                    }
                    if (const JValue* sh = b.get("set_headers"))
                        for (auto& a : sh->arr)
                            be.set_headers.emplace_back(a.s("name"), a.s("value"));
                    if (const JValue* rh = b.get("remove_headers"))
                        for (auto& a : rh->arr)
                            be.remove_headers.push_back(a.str);
                    rule.backends.push_back(std::move(be));
                }
            }
            g_cfg.rules.push_back(std::move(rule));
        }
    }
    // TLS backends need libssl at runtime; without it they are dropped
    // from native rules so their routes stay on the Python fallback path
    // (which fronts TLS via aiohttp) instead of 503ing
    bool any_tls = false;
    for (auto& r : g_cfg.rules)
        for (auto& b : r.backends)
            any_tls = any_tls || b.tls;
    if (any_tls && !tls::available()) {
        fprintf(stderr,
                "aigw-core: libssl.so.3 not loadable — TLS backends stay "
                "on the Python path\n");
        for (auto& r : g_cfg.rules) {
            std::vector<Backend> keep;
            for (auto& b : r.backends)
                if (!b.tls) keep.push_back(std::move(b));
            r.backends = std::move(keep);
        }
        std::vector<Rule> rules;
        for (auto& r : g_cfg.rules)
            if (!r.backends.empty()) rules.push_back(std::move(r));
        g_cfg.rules = std::move(rules);
    }
    return true;
}

// ---------------------------------------------------------------------------
// Stats
// ---------------------------------------------------------------------------

struct Stats {
    std::atomic<uint64_t> accepted{0};
    std::atomic<uint64_t> native_requests{0};
    std::atomic<uint64_t> fallback_requests{0};
    std::atomic<uint64_t> retries{0};
    std::atomic<uint64_t> upstream_errors{0};
    std::atomic<uint64_t> client_errors{0};
    std::atomic<uint64_t> bytes_relayed{0};
    // token accounting on the fast path (mined from the response tail) —
    // native routing must not trade away cost visibility
    std::atomic<uint64_t> prompt_tokens{0};
    std::atomic<uint64_t> completion_tokens{0};
    std::atomic<uint64_t> total_tokens{0};
};
static Stats g_stats;

enum class RelayResult { OK_REUSE, OK_CLOSE_UPSTREAM, OK_CLOSE_CLIENT,
                         RETRIABLE, CLIENT_GONE, UPSTREAM_BROKEN };

// per-backend counters; one lock per completed request, off the relay loop
struct BackendStats {
    uint64_t requests = 0;
    uint64_t status_2xx = 0, status_4xx = 0, status_5xx = 0;
    uint64_t prompt_tokens = 0, completion_tokens = 0, total_tokens = 0;
};
static std::mutex g_bstats_mu;
static std::map<std::string, BackendStats> g_bstats;

// Rolling tail of relayed body bytes: the usage object rides the end of
// the response in both JSON bodies and the final SSE chunk, so the last
// few KB are enough to mine token counts without buffering the stream.
struct UsageScanner {
    static constexpr size_t kTail = 8192;
    std::string tail;

    void feed(const char* d, size_t n) {
        if (n >= kTail) {
            tail.assign(d + n - kTail, kTail);
            return;
        }
        tail.append(d, n);
        if (tail.size() > kTail) tail.erase(0, tail.size() - kTail);
    }

    static long find_last(const std::string& t, const char* key) {
        size_t pos = t.rfind(key);
        if (pos == std::string::npos) return -1;
        pos = t.find(':', pos + strlen(key) - 1);
        if (pos == std::string::npos) return -1;
        pos++;
        while (pos < t.size() && t[pos] == ' ') pos++;
        if (pos >= t.size() || !isdigit(static_cast<unsigned char>(t[pos])))
            return -1;
        return atol(t.c_str() + pos);
    }

    // Last top-level-looking `"usage":{...}` object in the tail, or the
    // empty string. Scoping the key search to the usage object keeps
    // model output that merely *mentions* '"prompt_tokens": N' from
    // overriding the real counters (response content is attacker/model
    // controlled; the usage object is the upstream's own trailer).
    static std::string usage_object(const std::string& t) {
        size_t pos = t.rfind("\"usage\"");
        if (pos == std::string::npos) return "";
        pos = t.find(':', pos + 7);
        if (pos == std::string::npos) return "";
        pos++;
        while (pos < t.size() &&
               isspace(static_cast<unsigned char>(t[pos])))
            pos++;
        if (pos >= t.size() || t[pos] != '{') return "";
        int depth = 0;
        bool in_str = false, esc = false;
        for (size_t i = pos; i < t.size(); i++) {
            char c = t[i];
            if (esc) { esc = false; continue; }
            if (in_str) {
                if (c == '\\') esc = true;
                else if (c == '"') in_str = false;
                continue;
            }
            if (c == '"') in_str = true;
            else if (c == '{') depth++;
            else if (c == '}') {
                if (--depth == 0) return t.substr(pos, i - pos + 1);
            }
        }
        return "";  // torn at the tail boundary — caller falls back
    }

    void mine(long* prompt, long* completion, long* total) const {
        // Prefer counters scoped inside the LAST usage object; for keys
        // that object does not contain, fall back to the whole-tail
        // scan PER KEY. Anthropic streaming needs this: input_tokens
        // rides message_start's usage, the final message_delta's usage
        // has only output_tokens — scoping alone would drop prompt
        // accounting. Keys the scoped object does contain keep the
        // anti-spoofing property (model output cannot override them).
        std::string scope = usage_object(tail);
        const std::string& t = scope.empty() ? tail : scope;
        *prompt = find_last(t, "\"prompt_tokens\"");
        if (*prompt < 0) *prompt = find_last(t, "\"input_tokens\"");
        if (*prompt < 0 && !scope.empty()) {
            *prompt = find_last(tail, "\"prompt_tokens\"");
            if (*prompt < 0)
                *prompt = find_last(tail, "\"input_tokens\"");
        }
        *completion = find_last(t, "\"completion_tokens\"");
        if (*completion < 0)
            *completion = find_last(t, "\"output_tokens\"");
        if (*completion < 0 && !scope.empty()) {
            *completion = find_last(tail, "\"completion_tokens\"");
            if (*completion < 0)
                *completion = find_last(tail, "\"output_tokens\"");
        }
        *total = find_last(t, "\"total_tokens\"");
        if (*total < 0 && !scope.empty())
            *total = find_last(tail, "\"total_tokens\"");
        if (*total < 0 && *prompt >= 0 && *completion >= 0)
            *total = *prompt + *completion;
    }
};

// JSON string escaping for log/stat emission: path and model are
// client-controlled and must not be able to shape the JSON line.
static std::string jesc(const std::string& s) {
    std::string out;
    out.reserve(s.size() + 8);
    for (unsigned char c : s) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out += char(c);
                }
        }
    }
    return out;
}

// JSON-lines access log for natively routed requests (the Python path
// has its own AIGW_ACCESS_LOG pipeline); one O_APPEND write per request
// keeps lines atomic.
static int g_access_log_fd = -1;

// Span identity for one native request: ids ride the access log line to
// the Python exporter (obs/native_spans.py tails it and emits real OTel
// spans — VERDICT r3: "the fastest requests are the least traceable"),
// and the upstream hop gets a child traceparent so distributed traces
// continue through the native path.
struct TraceIds {
    std::string trace_id;   // 32 hex
    std::string span_id;    // 16 hex
    std::string parent_id;  // 16 hex, may be empty
    bool sampled = true;

    std::string traceparent() const {
        return "00-" + trace_id + "-" + span_id +
               (sampled ? "-01" : "-00");
    }
};

static std::string rand_hex(size_t n_bytes) {
    static thread_local std::mt19937_64 rng(
        std::random_device{}() ^
        (uint64_t(reinterpret_cast<uintptr_t>(&rng)) << 1));
    static const char* hexd = "0123456789abcdef";
    std::string out;
    out.reserve(n_bytes * 2);
    for (size_t i = 0; i < n_bytes; i++) {
        unsigned b = unsigned(rng() & 0xff);
        out += hexd[b >> 4];
        out += hexd[b & 0xf];
    }
    return out;
}

static bool is_hex(const std::string& s) {
    for (char c : s)
        if (!isxdigit(static_cast<unsigned char>(c))) return false;
    return !s.empty();
}

// W3C traceparent: 00-<32 hex>-<16 hex>-<2 hex flags>
static TraceIds trace_ids_for(const std::string& tp) {
    TraceIds t;
    if (tp.size() >= 55 && tp.compare(0, 3, "00-") == 0 &&
        tp[35] == '-' && tp[52] == '-') {
        std::string trace = tp.substr(3, 32);
        std::string parent = tp.substr(36, 16);
        if (is_hex(trace) && is_hex(parent)) {
            t.trace_id = trace;
            t.parent_id = parent;
            // sampled = low bit of the flags BYTE (W3C level-2 flags
            // like "09" are sampled; "10" is not)
            int flags = 0;
            if (tp.size() >= 55 && isxdigit((unsigned char)tp[53]) &&
                isxdigit((unsigned char)tp[54]))
                flags = int(strtol(tp.substr(53, 2).c_str(), nullptr, 16));
            t.sampled = (flags & 0x01) != 0;
        }
    }
    if (t.trace_id.empty()) t.trace_id = rand_hex(16);
    t.span_id = rand_hex(8);
    return t;
}

static const char* relay_result_name(RelayResult r);

static void access_log_line(const std::string& path, const std::string& model,
                            const std::string& backend, int status,
                            double duration_ms, long prompt, long completion,
                            long total, RelayResult result,
                            const TraceIds& trace, int64_t start_unix_ns) {
    if (g_access_log_fd < 0) return;
    char ts[32];
    time_t now = time(nullptr);
    struct tm tm_utc;
    gmtime_r(&now, &tm_utc);
    strftime(ts, sizeof ts, "%Y-%m-%dT%H:%M:%SZ", &tm_utc);
    std::ostringstream line;
    line << "{\"ts\":\"" << ts << "\",\"native\":true,\"path\":\""
         << jesc(path) << "\",\"model\":\"" << jesc(model)
         << "\",\"backend\":\"" << jesc(backend)
         << "\",\"status\":" << status << ",\"duration_ms\":"
         << int(duration_ms)
         // truncated relays (client went away / upstream died mid-body)
         // must be distinguishable from completed ones
         << ",\"result\":\"" << relay_result_name(result) << "\""
         << ",\"trace_id\":\"" << trace.trace_id << "\""
         << ",\"span_id\":\"" << trace.span_id << "\""
         << ",\"start_unix_ns\":" << start_unix_ns;
    if (!trace.parent_id.empty())
        line << ",\"parent_span_id\":\"" << trace.parent_id << "\"";
    if (!trace.sampled) line << ",\"sampled\":false";
    if (total >= 0 || prompt >= 0 || completion >= 0) {
        line << ",\"usage\":{";
        bool first = true;
        if (prompt >= 0) {
            line << "\"prompt_tokens\":" << prompt;
            first = false;
        }
        if (completion >= 0) {
            line << (first ? "" : ",") << "\"completion_tokens\":"
                 << completion;
            first = false;
        }
        if (total >= 0)
            line << (first ? "" : ",") << "\"total_tokens\":" << total;
        line << "}";
    }
    line << "}\n";
    std::string s = line.str();
    ssize_t n = write(g_access_log_fd, s.data(), s.size());
    (void)n;
}

// ---------------------------------------------------------------------------
// Socket helpers (blocking, with timeouts)
// ---------------------------------------------------------------------------

static void set_timeout(int fd, int secs) {
    struct timeval tv { secs, 0 };
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

// ---------------------------------------------------------------------------
// TLS upstreams (Envoy's native TLS role). The build image has no OpenSSL
// dev headers but ships libssl.so.3, so the small stable subset of the
// OpenSSL 3 ABI is dlopen'd and declared here. If the library is absent
// at runtime, TLS backends are dropped from native rules at config load
// and those routes stay on the Python fallback path.
// ---------------------------------------------------------------------------

#include <dlfcn.h>

namespace tls {

struct Api {
    void* (*TLS_client_method)() = nullptr;
    void* (*SSL_CTX_new)(void*) = nullptr;
    int (*SSL_CTX_set_default_verify_paths)(void*) = nullptr;
    int (*SSL_CTX_load_verify_locations)(void*, const char*, const char*) =
        nullptr;
    void (*SSL_CTX_set_verify)(void*, int, void*) = nullptr;
    void* (*SSL_new)(void*) = nullptr;
    int (*SSL_set_fd)(void*, int) = nullptr;
    long (*SSL_ctrl)(void*, int, long, void*) = nullptr;
    int (*SSL_set1_host)(void*, const char*) = nullptr;
    int (*SSL_connect)(void*) = nullptr;
    int (*SSL_read)(void*, void*, int) = nullptr;
    int (*SSL_write)(void*, const void*, int) = nullptr;
    int (*SSL_shutdown)(void*) = nullptr;
    void (*SSL_free)(void*) = nullptr;
    int (*SSL_CTX_set_alpn_protos)(void*, const unsigned char*,
                                   unsigned) = nullptr;  // optional
    bool ok = false;
};

static Api& api() {
    static Api a = [] {
        Api x;
        void* h = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
        if (!h) return x;
        auto sym = [&](const char* n) { return dlsym(h, n); };
        x.TLS_client_method =
            reinterpret_cast<void* (*)()>(sym("TLS_client_method"));
        x.SSL_CTX_new =
            reinterpret_cast<void* (*)(void*)>(sym("SSL_CTX_new"));
        x.SSL_CTX_set_default_verify_paths =
            reinterpret_cast<int (*)(void*)>(
                sym("SSL_CTX_set_default_verify_paths"));
        x.SSL_CTX_load_verify_locations =
            reinterpret_cast<int (*)(void*, const char*, const char*)>(
                sym("SSL_CTX_load_verify_locations"));
        x.SSL_CTX_set_verify = reinterpret_cast<void (*)(void*, int, void*)>(
            sym("SSL_CTX_set_verify"));
        x.SSL_new = reinterpret_cast<void* (*)(void*)>(sym("SSL_new"));
        x.SSL_set_fd =
            reinterpret_cast<int (*)(void*, int)>(sym("SSL_set_fd"));
        x.SSL_ctrl = reinterpret_cast<long (*)(void*, int, long, void*)>(
            sym("SSL_ctrl"));
        x.SSL_set1_host =
            reinterpret_cast<int (*)(void*, const char*)>(
                sym("SSL_set1_host"));
        x.SSL_connect = reinterpret_cast<int (*)(void*)>(sym("SSL_connect"));
        x.SSL_read =
            reinterpret_cast<int (*)(void*, void*, int)>(sym("SSL_read"));
        x.SSL_write = reinterpret_cast<int (*)(void*, const void*, int)>(
            sym("SSL_write"));
        x.SSL_shutdown =
            reinterpret_cast<int (*)(void*)>(sym("SSL_shutdown"));
        x.SSL_free = reinterpret_cast<void (*)(void*)>(sym("SSL_free"));
        x.SSL_CTX_set_alpn_protos =
            reinterpret_cast<int (*)(void*, const unsigned char*, unsigned)>(
                sym("SSL_CTX_set_alpn_protos"));
        // SSL_set1_host is REQUIRED: without it the hostname check is
        // silently skipped and any valid cert for any domain would pass
        x.ok = x.TLS_client_method && x.SSL_CTX_new && x.SSL_new &&
               x.SSL_set_fd && x.SSL_ctrl && x.SSL_connect && x.SSL_read &&
               x.SSL_write && x.SSL_free && x.SSL_shutdown &&
               x.SSL_set1_host &&
               x.SSL_CTX_set_default_verify_paths && x.SSL_CTX_set_verify;
        return x;
    }();
    return a;
}

static bool available() { return api().ok; }

// one shared client context; AIGW_CORE_CA_FILE adds a private CA (tests,
// internal upstreams) on top of the system trust store
static void* ctx() {
    static void* c = [&]() -> void* {
        Api& a = api();
        if (!a.ok) return nullptr;
        void* ctx_ = a.SSL_CTX_new(a.TLS_client_method());
        if (!ctx_) return nullptr;
        a.SSL_CTX_set_default_verify_paths(ctx_);
        if (const char* ca = getenv("AIGW_CORE_CA_FILE")) {
            if (a.SSL_CTX_load_verify_locations &&
                !a.SSL_CTX_load_verify_locations(ctx_, ca, nullptr))
                fprintf(stderr, "aigw-core: cannot load CA file %s\n", ca);
        }
        a.SSL_CTX_set_verify(ctx_, 1 /* SSL_VERIFY_PEER */, nullptr);
        // Pin ALPN to http/1.1: the relay speaks HTTP/1.1 framing, and
        // without ALPN a few providers would negotiate h2 and break the
        // stream. Every supported provider (OpenAI, Anthropic, Azure,
        // Bedrock, Vertex) serves HTTP/1.1 over TLS when ALPN asks for
        // it; a genuinely h2-only upstream stays on the Python path
        // (aiohttp), which is the documented de-scope for native h2.
        if (a.SSL_CTX_set_alpn_protos) {
            static const unsigned char kH1[] = "\x08http/1.1";
            a.SSL_CTX_set_alpn_protos(ctx_, kH1, sizeof kH1 - 1);
        }
        return ctx_;
    }();
    return c;
}

// SSL_set_tlsext_host_name is a macro over SSL_ctrl in the real headers
static const int kCtrlSetTlsextHostname = 55;

}  // namespace tls

// Unified plain/TLS upstream connection. Client-facing sockets stay
// plain fds; upstream I/O goes through here so the relay code is
// framing-only (Envoy's transport-socket split).
struct Stream {
    int fd = -1;
    void* ssl = nullptr;

    bool valid() const { return fd >= 0; }

    ssize_t read(void* buf, size_t len) {
        if (ssl != nullptr)
            return tls::api().SSL_read(ssl, buf, int(std::min(
                len, size_t(1) << 30)));
        return recv(fd, buf, len, 0);
    }

    bool write_all(const char* buf, size_t len) {
        while (len > 0) {
            ssize_t n;
            if (ssl != nullptr)
                n = tls::api().SSL_write(ssl, buf,
                                         int(std::min(len, size_t(1) << 30)));
            else
                n = send(fd, buf, len, MSG_NOSIGNAL);
            if (n <= 0) return false;
            buf += n;
            len -= size_t(n);
        }
        return true;
    }

    void close_all() {
        if (ssl != nullptr) {
            tls::api().SSL_shutdown(ssl);
            tls::api().SSL_free(ssl);
            ssl = nullptr;
        }
        if (fd >= 0) {
            close(fd);
            fd = -1;
        }
    }
};

static int dial(const std::string& host, int port, int timeout_s) {
    struct addrinfo hints {};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    char portstr[16];
    snprintf(portstr, sizeof portstr, "%d", port);
    if (getaddrinfo(host.c_str(), portstr, &hints, &res) != 0) return -1;
    int fd = -1;
    for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
        fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        set_timeout(fd, timeout_s);
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
        close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    return fd;
}

// Dial, optionally completing a verified TLS handshake (SNI + hostname
// check against `sni`). Returns an invalid Stream on any failure.
static Stream dial_stream(const std::string& host, int port, int timeout_s,
                          bool use_tls, const std::string& sni) {
    Stream s;
    s.fd = dial(host, port, timeout_s);
    if (s.fd < 0) return s;
    if (!use_tls) return s;
    tls::Api& a = tls::api();
    void* ctx = tls::ctx();
    if (!a.ok || ctx == nullptr) {
        s.close_all();
        return s;
    }
    s.ssl = a.SSL_new(ctx);
    if (s.ssl == nullptr) {
        s.close_all();
        return s;
    }
    a.SSL_set_fd(s.ssl, s.fd);
    const std::string& name = sni.empty() ? host : sni;
    a.SSL_ctrl(s.ssl, tls::kCtrlSetTlsextHostname, 0,
               const_cast<char*>(name.c_str()));
    a.SSL_set1_host(s.ssl, name.c_str());  // required symbol (api().ok)
    if (a.SSL_connect(s.ssl) != 1) {
        s.close_all();
        return s;
    }
    return s;
}

static bool write_all(int fd, const char* buf, size_t len) {
    while (len > 0) {
        ssize_t n = send(fd, buf, len, MSG_NOSIGNAL);
        if (n <= 0) return false;
        buf += n;
        len -= size_t(n);
    }
    return true;
}

// ---------------------------------------------------------------------------
// HTTP parsing
// ---------------------------------------------------------------------------

struct Request {
    std::string method, path, version;
    // ordered headers with original names; keys() lookups are
    // case-insensitive
    std::vector<std::pair<std::string, std::string>> headers;
    std::string body;
    bool keep_alive = true;

    std::string header(const std::string& name) const {
        for (auto& kv : headers) {
            if (kv.first.size() == name.size() &&
                strcasecmp(kv.first.c_str(), name.c_str()) == 0)
                return kv.second;
        }
        return "";
    }
};

// Reads until the full head is buffered; excess bytes stay in `buf`.
static bool read_head(Stream& s, std::string& buf, std::string& head) {
    size_t scanned = 0;
    while (true) {
        size_t pos = buf.find("\r\n\r\n", scanned > 3 ? scanned - 3 : 0);
        if (pos != std::string::npos) {
            head = buf.substr(0, pos + 4);
            buf.erase(0, pos + 4);
            return true;
        }
        scanned = buf.size();
        if (buf.size() > 64 * 1024) return false;  // header bomb
        char tmp[8192];
        ssize_t n = s.read(tmp, sizeof tmp);
        if (n <= 0) return false;
        buf.append(tmp, size_t(n));
    }
}

static bool parse_head(const std::string& head, Request& req) {
    size_t line_end = head.find("\r\n");
    if (line_end == std::string::npos) return false;
    std::istringstream rl(head.substr(0, line_end));
    if (!(rl >> req.method >> req.path >> req.version)) return false;
    size_t pos = line_end + 2;
    while (pos < head.size()) {
        size_t eol = head.find("\r\n", pos);
        if (eol == std::string::npos || eol == pos) break;
        size_t colon = head.find(':', pos);
        if (colon == std::string::npos || colon > eol) return false;
        std::string name = head.substr(pos, colon - pos);
        size_t vstart = colon + 1;
        while (vstart < eol && head[vstart] == ' ') vstart++;
        req.headers.emplace_back(name, head.substr(vstart, eol - vstart));
        pos = eol + 2;
    }
    std::string conn = req.header("connection");
    for (auto& c : conn) c = char(tolower(c));
    req.keep_alive = req.version == "HTTP/1.1" ? conn != "close"
                                               : conn == "keep-alive";
    return true;
}

// ---------------------------------------------------------------------------
// Routing
// ---------------------------------------------------------------------------

// The routed model comes from the BODY, matching the Python gateway's
// precedence: the gateway stamps x-aigw-model itself from the parsed
// body, and a client-supplied value is overwritten (never trusted) —
// trusting the header here would let clients steer requests onto
// backends/credentials the Python path would never pick.
static std::string extract_model(const Request& req) {
    if (req.body.empty() || req.body[0] != '{') return "";
    JParser jp(req.body);
    JValue root = jp.parse();
    if (!jp.ok || root.kind != JValue::OBJ) return "";
    return root.s("model");
}

static const Rule* match_rule(const std::string& model, const std::string& host) {
    std::string bare_host = host.substr(0, host.find(':'));
    for (auto& c : bare_host) c = char(tolower(c));  // hostnames are
    // matched case-insensitively (config hostnames lowercased at load)
    for (auto& r : g_cfg.rules) {
        if (!r.hostnames.empty()) {
            bool ok = false;
            for (auto& h : r.hostnames)
                if (h == bare_host) { ok = true; break; }
            if (!ok) continue;
        }
        if (!r.model_exact.empty()) {
            if (model == r.model_exact) return &r;
        } else if (!r.model_prefix.empty()) {
            if (model.rfind(r.model_prefix, 0) == 0) return &r;
        }
    }
    return nullptr;
}

// Priority-tiered weighted ordering: tier 0 backends first (weighted
// shuffle), then tier 1, ... — the retry loop walks this order, which is
// the Python gateway's `_attempt_loop` semantics.
static std::vector<const Backend*> pick_order(const Rule& rule) {
    thread_local std::mt19937 rng(std::random_device{}());
    std::map<int, std::vector<const Backend*>> tiers;
    // weight 0 = drained: receives no traffic (router.py semantics)
    for (auto& b : rule.backends)
        if (b.weight > 0) tiers[b.priority].push_back(&b);
    std::vector<const Backend*> order;
    for (auto& [prio, group] : tiers) {
        std::vector<const Backend*> g = group;
        while (!g.empty()) {
            long total = 0;
            for (auto* b : g) total += b->weight;
            long pick = std::uniform_int_distribution<long>(0, total - 1)(rng);
            for (size_t i = 0; i < g.size(); i++) {
                pick -= g[i]->weight;
                if (pick < 0) {
                    order.push_back(g[i]);
                    g.erase(g.begin() + long(i));
                    break;
                }
            }
        }
    }
    return order;
}

// ---------------------------------------------------------------------------
// Upstream forwarding
// ---------------------------------------------------------------------------

// Thread-local upstream keep-alive pool: one cached connection per
// (host, port, tls). Shared-nothing across threads — no locks on the
// hot path.
struct UpstreamPool {
    std::map<std::string, Stream> conns;

    static std::string key(const Backend& be) {
        return be.host + ":" + std::to_string(be.port) +
               (be.tls ? ":tls" : "");
    }

    Stream get(const Backend& be, bool* reused) {
        auto it = conns.find(key(be));
        if (it != conns.end()) {
            Stream s = it->second;
            conns.erase(it);
            *reused = true;
            return s;
        }
        *reused = false;
        return dial_stream(be.host, be.port, be.read_timeout_s, be.tls,
                           be.sni);
    }
    void put(const Backend& be, Stream s) {
        auto it = conns.find(key(be));
        if (it != conns.end()) it->second.close_all();
        conns[key(be)] = s;
    }
    ~UpstreamPool() {
        for (auto& kv : conns) kv.second.close_all();
    }
};
static thread_local UpstreamPool t_pool;

static std::string build_upstream_head(const Request& req, const Backend& be,
                                       const std::string& traceparent = "") {
    std::ostringstream out;
    out << req.method << ' ' << req.path << " HTTP/1.1\r\n";
    std::string host = be.preserve_host ? req.header("host") : "";
    if (host.empty()) host = be.host + ':' + std::to_string(be.port);
    out << "host: " << host << "\r\n";
    for (auto& kv : req.headers) {
        std::string lower = kv.first;
        for (auto& c : lower) c = char(tolower(c));
        if (lower == "host" || lower == "connection" ||
            lower == "keep-alive" || lower == "content-length" ||
            lower == "transfer-encoding" || lower == "expect")
            continue;
        // our span becomes the upstream's parent (trace continuity
        // through the native path)
        if (!traceparent.empty() && lower == "traceparent") continue;
        bool removed = false;
        for (auto& r : be.remove_headers)
            if (strcasecmp(r.c_str(), kv.first.c_str()) == 0) removed = true;
        for (auto& s : be.set_headers)
            if (strcasecmp(s.first.c_str(), kv.first.c_str()) == 0)
                removed = true;  // replaced below
        for (auto& a : be.auth_headers)
            if (strcasecmp(a->name.c_str(), kv.first.c_str()) == 0)
                removed = true;
        if (!removed) out << kv.first << ": " << kv.second << "\r\n";
    }
    for (auto& s : be.set_headers) out << s.first << ": " << s.second << "\r\n";
    for (auto& a : be.auth_headers)
        out << a->name << ": " << a->resolve() << "\r\n";
    if (!traceparent.empty())
        out << "traceparent: " << traceparent << "\r\n";
    out << "content-length: " << req.body.size() << "\r\n";
    out << "connection: keep-alive\r\n\r\n";
    return out.str();
}

static const char* relay_result_name(RelayResult r) {
    switch (r) {
        case RelayResult::OK_REUSE:
        case RelayResult::OK_CLOSE_UPSTREAM:
        case RelayResult::OK_CLOSE_CLIENT:
            return "complete";
        case RelayResult::CLIENT_GONE:
            return "client_gone";
        case RelayResult::UPSTREAM_BROKEN:
            return "upstream_broken";
        case RelayResult::RETRIABLE:
            return "retriable";
    }
    return "unknown";
}

// Parse the upstream response head; relay (possibly rewritten) head +
// body to the client, honoring content-length / chunked / close framing.
//
// `failover_on_status`: when true, a retriable status (429/5xx) is not
// relayed — the (bounded) error response is captured into `last_error`
// so the caller can fail over and, if every candidate fails, still hand
// the client the REAL last upstream error instead of a synthesized 503
// (the Python `_attempt_loop` behavior). The fallback relay passes
// false: the Python gateway's 429/5xx are authoritative responses.
static RelayResult relay_response(Stream& up, int client, const Request& req,
                                  bool* client_keep_alive, int* status_out,
                                  bool failover_on_status,
                                  std::string* last_error,
                                  UsageScanner* scan) {
    std::string buf;
    std::string head;
    if (!read_head(up, buf, head)) return RelayResult::RETRIABLE;
    // status line
    int status = 0;
    {
        size_t sp = head.find(' ');
        if (sp == std::string::npos) return RelayResult::UPSTREAM_BROKEN;
        status = atoi(head.c_str() + sp + 1);
    }
    *status_out = status;
    // headers of interest
    Request resp;  // reuse the parser for headers
    if (!parse_head(head, resp)) return RelayResult::UPSTREAM_BROKEN;
    // NOTE: parse_head parses "HTTP/1.1 200 OK" as method/path/version —
    // only .headers matter here.
    long content_length = -1;
    bool chunked = false;
    bool upstream_close = false;
    {
        std::string cl = resp.header("content-length");
        if (!cl.empty()) content_length = atol(cl.c_str());
        std::string te = resp.header("transfer-encoding");
        for (auto& c : te) c = char(tolower(c));
        chunked = te.find("chunked") != std::string::npos;
        std::string conn = resp.header("connection");
        for (auto& c : conn) c = char(tolower(c));
        upstream_close = conn == "close";
        if (content_length < 0 && !chunked) upstream_close = true;
    }
    // responses without a body regardless of framing headers
    bool bodiless = req.method == "HEAD" || status == 204 ||
                    status == 304 || (status >= 100 && status < 200);
    if (bodiless) {
        content_length = 0;
        chunked = false;
    }
    // retriable status with no bytes sent → let the caller fail over
    // (the caller owns `up` and closes it; the next attempt dials fresh)
    if (failover_on_status) {
        for (int rs : g_cfg.retriable) {
            if (status != rs) continue;
            // capture small, well-framed error responses so an
            // all-backends-failed request still returns the real error
            if (last_error != nullptr && content_length >= 0 &&
                content_length <= (64 << 10)) {
                std::string body = buf;
                char tmp[8192];
                while (long(body.size()) < content_length) {
                    ssize_t n = up.read(tmp, sizeof tmp);
                    if (n <= 0) { body.clear(); break; }
                    body.append(tmp, size_t(n));
                }
                if (long(body.size()) == content_length) {
                    size_t line_end = head.find("\r\n");
                    std::ostringstream cap;
                    cap << head.substr(0, line_end) << "\r\n";
                    size_t pos = line_end + 2;
                    while (pos < head.size()) {
                        size_t eol = head.find("\r\n", pos);
                        if (eol == std::string::npos || eol == pos) break;
                        std::string line = head.substr(pos, eol - pos);
                        std::string lower = line.substr(0, line.find(':'));
                        for (auto& c : lower) c = char(tolower(c));
                        if (lower != "connection" && lower != "keep-alive")
                            cap << line << "\r\n";
                        pos = eol + 2;
                    }
                    cap << "connection: close\r\n\r\n" << body;
                    *last_error = cap.str();
                }
            }
            return RelayResult::RETRIABLE;
        }
    }

    // rewrite head for the client: drop hop-by-hop headers, set our own
    // connection disposition (client keep-alive unless upstream framing
    // forces close)
    bool close_client_after = upstream_close && content_length < 0 && !chunked;
    std::ostringstream out;
    size_t line_end = head.find("\r\n");
    out << head.substr(0, line_end) << "\r\n";
    {
        size_t pos = line_end + 2;
        while (pos < head.size()) {
            size_t eol = head.find("\r\n", pos);
            if (eol == std::string::npos || eol == pos) break;
            std::string line = head.substr(pos, eol - pos);
            std::string lower = line.substr(0, line.find(':'));
            for (auto& c : lower) c = char(tolower(c));
            if (lower != "connection" && lower != "keep-alive")
                out << line << "\r\n";
            pos = eol + 2;
        }
    }
    bool ka = req.keep_alive && !close_client_after;
    out << "connection: " << (ka ? "keep-alive" : "close") << "\r\n\r\n";
    *client_keep_alive = ka;
    std::string client_head = out.str();
    if (!write_all(client, client_head.data(), client_head.size()))
        return RelayResult::CLIENT_GONE;
    if (bodiless)
        return upstream_close ? RelayResult::OK_CLOSE_UPSTREAM
                              : RelayResult::OK_REUSE;

    // relay body; buf already holds leading body bytes. The usage
    // scanner is fed PAYLOAD bytes only (never chunk framing), from the
    // explicit feed calls below.
    auto push = [&](const char* data, size_t len) -> bool {
        g_stats.bytes_relayed += len;
        return write_all(client, data, len);
    };
    if (content_length >= 0) {
        size_t remaining = size_t(content_length);
        size_t have = std::min(buf.size(), remaining);
        if (have && !push(buf.data(), have)) return RelayResult::CLIENT_GONE;
        if (scan != nullptr && have) scan->feed(buf.data(), have);
        remaining -= have;
        char tmp[16384];
        while (remaining > 0) {
            ssize_t n = up.read(tmp, std::min(remaining, sizeof tmp));
            if (n <= 0) return RelayResult::UPSTREAM_BROKEN;
            if (!push(tmp, size_t(n))) return RelayResult::CLIENT_GONE;
            if (scan != nullptr) scan->feed(tmp, size_t(n));
            remaining -= size_t(n);
        }
        return upstream_close ? RelayResult::OK_CLOSE_UPSTREAM
                              : RelayResult::OK_REUSE;
    }
    if (chunked) {
        // relay chunks verbatim while tracking framing to find the end
        std::string acc = std::move(buf);
        size_t scan_pos = 0;  // start of the next chunk-size line in acc
        auto read_more = [&]() -> bool {
            char tmp[16384];
            ssize_t n = up.read(tmp, sizeof tmp);
            if (n <= 0) return false;
            acc.append(tmp, size_t(n));
            return true;
        };
        while (true) {
            size_t eol = acc.find("\r\n", scan_pos);
            while (eol == std::string::npos) {
                if (!read_more()) return RelayResult::UPSTREAM_BROKEN;
                eol = acc.find("\r\n", scan_pos);
            }
            errno = 0;
            long sz = strtol(acc.c_str() + scan_pos, nullptr, 16);
            // chunk payload is streamed below (never accumulated), so only
            // corrupt headers need rejecting: negative or strtol-saturated
            if (sz < 0 || (sz == LONG_MAX && errno == ERANGE))
                return RelayResult::UPSTREAM_BROKEN;
            size_t chunk_end = eol + 2 + size_t(sz) + 2;  // data + CRLF
            if (sz == 0) {
                // trailing headers until blank line
                size_t fin = acc.find("\r\n\r\n", scan_pos);
                while (fin == std::string::npos) {
                    if (!read_more()) return RelayResult::UPSTREAM_BROKEN;
                    fin = acc.find("\r\n\r\n", scan_pos);
                }
                size_t upto = fin + 4;
                if (!push(acc.data(), upto)) return RelayResult::CLIENT_GONE;
                acc.erase(0, upto);
                return upstream_close ? RelayResult::OK_CLOSE_UPSTREAM
                                      : RelayResult::OK_REUSE;
            }
            // flush the size line plus whatever payload is buffered, then
            // stream the rest of the chunk without accumulating it (for SSE
            // every event is typically one chunk → immediate delivery)
            size_t have = std::min(acc.size(), chunk_end);
            if (!push(acc.data(), have)) return RelayResult::CLIENT_GONE;
            if (scan != nullptr) {
                // payload spans [eol+2, eol+2+sz) — framing bytes around
                // it must not reach the scanner (a chunk boundary could
                // otherwise splice digits into a token count)
                size_t pstart = eol + 2;
                size_t pend = std::min(have, eol + 2 + size_t(sz));
                if (pend > pstart)
                    scan->feed(acc.data() + pstart, pend - pstart);
            }
            acc.erase(0, have);
            size_t rem = chunk_end - have;
            // remaining payload before the chunk's trailing CRLF
            long prem = long(chunk_end - 2) - long(have);
            char tmp[16384];
            while (rem > 0) {
                ssize_t n = up.read(tmp, std::min(rem, sizeof tmp));
                if (n <= 0) return RelayResult::UPSTREAM_BROKEN;
                if (!push(tmp, size_t(n))) return RelayResult::CLIENT_GONE;
                if (scan != nullptr && prem > 0) {
                    size_t f = std::min(size_t(prem), size_t(n));
                    scan->feed(tmp, f);
                    prem -= long(f);
                }
                rem -= size_t(n);
            }
            scan_pos = 0;
        }
    }
    // read-until-close framing
    if (!buf.empty()) {
        if (!push(buf.data(), buf.size())) return RelayResult::CLIENT_GONE;
        if (scan != nullptr) scan->feed(buf.data(), buf.size());
    }
    char tmp[16384];
    while (true) {
        ssize_t n = up.read(tmp, sizeof tmp);
        if (n == 0) break;
        if (n < 0) return RelayResult::UPSTREAM_BROKEN;
        if (!push(tmp, size_t(n))) return RelayResult::CLIENT_GONE;
        if (scan != nullptr) scan->feed(tmp, size_t(n));
    }
    return RelayResult::OK_CLOSE_CLIENT;
}

static bool respond_simple(int client, int status, const std::string& text,
                           bool keep_alive) {
    std::ostringstream out;
    const char* reason = status == 503 ? "Service Unavailable"
                        : status == 413 ? "Payload Too Large"
                        : status == 400 ? "Bad Request" : "OK";
    std::string body = "{\"error\":{\"message\":\"" + text + "\"}}";
    if (status == 200) body = text;
    out << "HTTP/1.1 " << status << ' ' << reason << "\r\n"
        << "content-type: application/json\r\n"
        << "content-length: " << body.size() << "\r\n"
        << "connection: " << (keep_alive ? "keep-alive" : "close")
        << "\r\n\r\n"
        << body;
    std::string s = out.str();
    return write_all(client, s.data(), s.size());
}

// Forward to one backend; returns the relay result (RETRIABLE means the
// caller may try the next candidate).
static RelayResult try_backend(const Backend& be, const Request& req,
                               int client, bool* client_ka, int* status,
                               bool failover_on_status,
                               std::string* last_error,
                               UsageScanner* scan,
                               const std::string& traceparent = "") {
    bool reused = false;
    Stream up = t_pool.get(be, &reused);
    if (!up.valid()) return RelayResult::RETRIABLE;
    std::string head = build_upstream_head(req, be, traceparent);
    bool sent = up.write_all(head.data(), head.size()) &&
                (req.body.empty() ||
                 up.write_all(req.body.data(), req.body.size()));
    if (!sent) {
        up.close_all();
        if (reused) {
            // stale keep-alive connection — retry once with a fresh dial
            up = t_pool.get(be, &reused);
            if (!up.valid()) return RelayResult::RETRIABLE;
            if (!up.write_all(head.data(), head.size()) ||
                (!req.body.empty() &&
                 !up.write_all(req.body.data(), req.body.size()))) {
                up.close_all();
                return RelayResult::RETRIABLE;
            }
        } else {
            return RelayResult::RETRIABLE;
        }
    }
    RelayResult r = relay_response(up, client, req, client_ka, status,
                                   failover_on_status, last_error, scan);
    if (r == RelayResult::OK_REUSE)
        t_pool.put(be, up);
    else
        up.close_all();
    return r;
}

// ---------------------------------------------------------------------------
// Per-connection loop
// ---------------------------------------------------------------------------

static void handle_connection(int client) {
    set_timeout(client, 120);
    int one = 1;
    setsockopt(client, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    Stream cs{client, nullptr};  // client side is always plain
    std::string buf;  // bytes past the current head
    while (true) {
        std::string head;
        if (!read_head(cs, buf, head)) break;
        Request req;
        if (!parse_head(head, req)) {
            respond_simple(client, 400, "malformed request", false);
            break;
        }
        // body (content-length only; chunked request bodies → fallback
        // can't help since we need the body to forward — reject)
        std::string te = req.header("transfer-encoding");
        if (!te.empty()) {
            respond_simple(client, 400, "chunked request bodies unsupported",
                           false);
            break;
        }
        long cl = atol(req.header("content-length").c_str());
        if (cl < 0 || size_t(cl) > g_cfg.max_body) {
            respond_simple(client, 413, "body too large", false);
            break;
        }
        {
            // RFC 7231 §5.1.1: clients sending Expect: 100-continue
            // withhold the body until we say go (curl does after ~1s;
            // strict clients wait indefinitely)
            std::string expect = req.header("expect");
            for (auto& c : expect) c = char(tolower(c));
            if (expect.find("100-continue") != std::string::npos &&
                cl > 0 && buf.size() < size_t(cl)) {
                const char cont[] = "HTTP/1.1 100 Continue\r\n\r\n";
                if (!write_all(client, cont, sizeof cont - 1)) break;
            }
        }
        while (buf.size() < size_t(cl)) {
            char tmp[16384];
            ssize_t n = recv(client, tmp, sizeof tmp, 0);
            if (n <= 0) { close(client); return; }
            buf.append(tmp, size_t(n));
        }
        req.body = buf.substr(0, size_t(cl));
        buf.erase(0, size_t(cl));

        // core admin endpoint
        if (req.path == "/aigw-core/stats") {
            std::ostringstream s;
            s << "{\"accepted\":" << g_stats.accepted.load()
              << ",\"native_requests\":" << g_stats.native_requests.load()
              << ",\"fallback_requests\":" << g_stats.fallback_requests.load()
              << ",\"retries\":" << g_stats.retries.load()
              << ",\"upstream_errors\":" << g_stats.upstream_errors.load()
              << ",\"bytes_relayed\":" << g_stats.bytes_relayed.load()
              << ",\"tls_available\":" << (tls::available() ? "true" : "false")
              << ",\"usage\":{\"prompt_tokens\":"
              << g_stats.prompt_tokens.load()
              << ",\"completion_tokens\":" << g_stats.completion_tokens.load()
              << ",\"total_tokens\":" << g_stats.total_tokens.load() << "}"
              << ",\"backends\":{";
            {
                std::lock_guard<std::mutex> lk(g_bstats_mu);
                bool first = true;
                for (auto& kv : g_bstats) {
                    if (!first) s << ',';
                    first = false;
                    const BackendStats& b = kv.second;
                    s << "\"" << jesc(kv.first) << "\":{\"requests\":"
                      << b.requests
                      << ",\"2xx\":" << b.status_2xx
                      << ",\"4xx\":" << b.status_4xx
                      << ",\"5xx\":" << b.status_5xx
                      << ",\"prompt_tokens\":" << b.prompt_tokens
                      << ",\"completion_tokens\":" << b.completion_tokens
                      << ",\"total_tokens\":" << b.total_tokens << "}";
                }
            }
            s << "}}";
            if (!respond_simple(client, 200, s.str(), req.keep_alive)) break;
            if (!req.keep_alive) break;
            continue;
        }

        // native eligibility: POST to a routed endpoint with a matching
        // compiled rule; everything else → Python gateway fallback
        const Rule* rule = nullptr;
        if (req.method == "POST") {
            for (auto& ep : g_cfg.endpoints) {
                if (req.path == ep) {
                    rule = match_rule(extract_model(req), req.header("host"));
                    break;
                }
            }
        }

        bool client_ka = req.keep_alive;
        int status = 0;
        RelayResult r = RelayResult::RETRIABLE;
        std::string last_error;
        if (rule != nullptr) {
            g_stats.native_requests++;
            UsageScanner scan;
            const Backend* served = nullptr;
            TraceIds trace = trace_ids_for(req.header("traceparent"));
            struct timespec t0, t1, tw;
            clock_gettime(CLOCK_MONOTONIC, &t0);
            clock_gettime(CLOCK_REALTIME, &tw);
            int64_t start_unix_ns =
                int64_t(tw.tv_sec) * 1000000000LL + tw.tv_nsec;
            std::vector<const Backend*> order = pick_order(*rule);
            int attempts = 0;
            for (const Backend* be : order) {
                if (attempts++ > g_cfg.max_retries) break;
                scan.tail.clear();  // usage must come from the attempt
                                    // that actually answered
                r = try_backend(*be, req, client, &client_ka, &status,
                                /*failover_on_status=*/true, &last_error,
                                &scan, trace.traceparent());
                if (r != RelayResult::RETRIABLE) {
                    served = be;
                    break;
                }
                g_stats.retries++;
            }
            if (served != nullptr && status > 0) {
                clock_gettime(CLOCK_MONOTONIC, &t1);
                double ms = (t1.tv_sec - t0.tv_sec) * 1e3 +
                            (t1.tv_nsec - t0.tv_nsec) / 1e6;
                long prompt = -1, completion = -1, total = -1;
                scan.mine(&prompt, &completion, &total);
                if (prompt > 0) g_stats.prompt_tokens += uint64_t(prompt);
                if (completion > 0)
                    g_stats.completion_tokens += uint64_t(completion);
                if (total > 0) g_stats.total_tokens += uint64_t(total);
                {
                    std::lock_guard<std::mutex> lk(g_bstats_mu);
                    BackendStats& bs = g_bstats[served->name];
                    bs.requests++;
                    if (status >= 200 && status < 300) bs.status_2xx++;
                    else if (status >= 400 && status < 500) bs.status_4xx++;
                    else if (status >= 500) bs.status_5xx++;
                    if (prompt > 0) bs.prompt_tokens += uint64_t(prompt);
                    if (completion > 0)
                        bs.completion_tokens += uint64_t(completion);
                    if (total > 0) bs.total_tokens += uint64_t(total);
                }
                access_log_line(req.path, extract_model(req), served->name,
                                status, ms, prompt, completion, total,
                                r, trace, start_unix_ns);
            }
        } else {
            g_stats.fallback_requests++;
            Backend fb;
            fb.host = g_cfg.fallback_host;
            fb.port = g_cfg.fallback_port;
            fb.preserve_host = true;
            for (int i = 0; i < 2; i++) {  // one stale-conn retry
                // the Python gateway's 429/5xx are authoritative — relay
                // them; only connection-level failures retry
                r = try_backend(fb, req, client, &client_ka, &status,
                                /*failover_on_status=*/false, nullptr,
                                nullptr);
                if (r != RelayResult::RETRIABLE) break;
            }
        }
        switch (r) {
            case RelayResult::OK_REUSE:
            case RelayResult::OK_CLOSE_UPSTREAM:
                if (!client_ka) { close(client); return; }
                break;
            case RelayResult::OK_CLOSE_CLIENT:
            case RelayResult::CLIENT_GONE:
                close(client);
                return;
            case RelayResult::RETRIABLE:  // all candidates exhausted
                g_stats.upstream_errors++;
                if (!last_error.empty()) {
                    // hand the client the REAL last upstream error
                    // (the Python _attempt_loop behavior)
                    write_all(client, last_error.data(), last_error.size());
                } else {
                    respond_simple(client, 503, "no upstream available",
                                   false);
                }
                close(client);
                return;
            case RelayResult::UPSTREAM_BROKEN:
                g_stats.upstream_errors++;
                // headers may already be out; all we can do is close
                close(client);
                return;
        }
    }
    close(client);
}

// ---------------------------------------------------------------------------

int main(int argc, char** argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: aigw-core <config.json>\n");
        return 2;
    }
    if (!load_config(argv[1])) return 2;
    signal(SIGPIPE, SIG_IGN);
    if (!g_cfg.access_log_path.empty()) {
        g_access_log_fd = open(g_cfg.access_log_path.c_str(),
                               O_WRONLY | O_APPEND | O_CREAT, 0644);
        if (g_access_log_fd < 0)
            fprintf(stderr, "aigw-core: cannot open access log %s\n",
                    g_cfg.access_log_path.c_str());
    }

    int lfd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    setsockopt(lfd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof one);
    struct sockaddr_in addr {};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(g_cfg.listen_port));
    inet_pton(AF_INET, g_cfg.listen_host.c_str(), &addr.sin_addr);
    if (bind(lfd, (struct sockaddr*)&addr, sizeof addr) != 0) {
        perror("aigw-core: bind");
        return 1;
    }
    if (listen(lfd, 1024) != 0) {
        perror("aigw-core: listen");
        return 1;
    }
    fprintf(stderr, "aigw-core listening on %s:%d (%zu rules, fallback %s:%d)\n",
            g_cfg.listen_host.c_str(), g_cfg.listen_port, g_cfg.rules.size(),
            g_cfg.fallback_host.c_str(), g_cfg.fallback_port);
    fflush(stderr);
    while (true) {
        int cfd = accept(lfd, nullptr, nullptr);
        if (cfd < 0) continue;
        g_stats.accepted++;
        std::thread(handle_connection, cfd).detach();
    }
}
