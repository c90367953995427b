// sdsp_io — native host-side streaming runtime for simpledsp_jax.
//
// The accelerator owns the math (JAX/XLA); this library owns the host side
// of the pipeline: a lock-free single-producer/single-consumer byte ring
// buffer, SDR sample-format converters (interleaved int8/int16 IQ ->
// separate float32 re/im planes, matching the framework's RI data path),
// and a background file/fd reader thread.  It plays the role the
// reference's native code plays for compute (include/sdsp/*.h is all
// native C++): keeping the non-XLA part of the framework compiled code,
// not Python loops.
//
// C ABI only (consumed via ctypes from simpledsp_jax/runtime/stream.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer (byte-oriented, contiguous push/pop).
// ---------------------------------------------------------------------------

struct SdspRing {
    uint8_t* buf;
    size_t capacity;                 // power of two
    std::atomic<uint64_t> head;      // write cursor (producer)
    std::atomic<uint64_t> tail;      // read cursor (consumer)
};

static size_t round_up_pow2(size_t v) {
    size_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

SdspRing* sdsp_ring_create(size_t capacity) {
    capacity = round_up_pow2(capacity);
    auto* r = new SdspRing();
    r->buf = static_cast<uint8_t*>(std::malloc(capacity));
    if (!r->buf) { delete r; return nullptr; }
    r->capacity = capacity;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    return r;
}

void sdsp_ring_destroy(SdspRing* r) {
    if (!r) return;
    std::free(r->buf);
    delete r;
}

size_t sdsp_ring_capacity(const SdspRing* r) { return r->capacity; }

size_t sdsp_ring_readable(const SdspRing* r) {
    return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                               r->tail.load(std::memory_order_acquire));
}

size_t sdsp_ring_writable(const SdspRing* r) {
    return r->capacity - sdsp_ring_readable(r);
}

// Returns bytes actually pushed (0..n); never blocks.
size_t sdsp_ring_push(SdspRing* r, const uint8_t* src, size_t n) {
    const uint64_t head = r->head.load(std::memory_order_relaxed);
    const uint64_t tail = r->tail.load(std::memory_order_acquire);
    const size_t free_space = r->capacity - static_cast<size_t>(head - tail);
    if (n > free_space) n = free_space;
    if (n == 0) return 0;
    const size_t off = static_cast<size_t>(head) & (r->capacity - 1);
    const size_t first = (off + n <= r->capacity) ? n : r->capacity - off;
    std::memcpy(r->buf + off, src, first);
    if (n > first) std::memcpy(r->buf, src + first, n - first);
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Returns bytes actually popped (0..n); never blocks.
size_t sdsp_ring_pop(SdspRing* r, uint8_t* dst, size_t n) {
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t head = r->head.load(std::memory_order_acquire);
    const size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) n = avail;
    if (n == 0) return 0;
    const size_t off = static_cast<size_t>(tail) & (r->capacity - 1);
    const size_t first = (off + n <= r->capacity) ? n : r->capacity - off;
    std::memcpy(dst, r->buf + off, first);
    if (n > first) std::memcpy(dst + first, r->buf, n - first);
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

}  // extern "C" (resumed below — the fork-join helpers are C++ templates)

// ---------------------------------------------------------------------------
// SDR sample-format converters.  All write float32 planes, the framework's
// native IQ representation (complex never materializes on the device path).
// Each converter has a single-threaded core over an index range plus a
// fork-join multithreaded entry (nthreads <= 0 -> hardware concurrency):
// production ingest blocks are hundreds of MB, where one core cannot reach
// DRAM bandwidth but a few can, and thread spawn cost (~tens of us) is
// negligible at >= 1 MB per call (the _mt entries fall back to the serial
// loop below that).
// ---------------------------------------------------------------------------

static unsigned resolve_threads(int nthreads, size_t work_bytes) {
    unsigned n = nthreads > 0 ? static_cast<unsigned>(nthreads)
                              : std::thread::hardware_concurrency();
    if (n == 0) n = 1;
    if (n > 16) n = 16;
    // At least ~1 MB of work per thread, else serial.
    const size_t max_by_work = work_bytes >> 20;
    if (max_by_work < n) n = max_by_work ? static_cast<unsigned>(max_by_work)
                                         : 1;
    return n;
}

// Runs fn(lo, hi) over [0, total) split across resolve_threads(nthreads).
template <typename Fn>
static void parallel_for(size_t total, size_t work_bytes, int nthreads,
                         Fn fn) {
    const unsigned n = resolve_threads(nthreads, work_bytes);
    if (n <= 1) { fn(static_cast<size_t>(0), total); return; }
    std::thread workers[16];
    const size_t step = (total + n - 1) / n;
    for (unsigned t = 0; t < n; ++t) {
        const size_t lo = t * step;
        const size_t hi = lo + step < total ? lo + step : total;
        workers[t] = std::thread([=] { if (lo < hi) fn(lo, hi); });
    }
    for (unsigned t = 0; t < n; ++t) workers[t].join();
}

static void cvt_iq16_range(const int16_t* src, float* re, float* im,
                           size_t lo, size_t hi, float scale) {
    for (size_t i = lo; i < hi; ++i) {
        re[i] = static_cast<float>(src[2 * i]) * scale;
        im[i] = static_cast<float>(src[2 * i + 1]) * scale;
    }
}

static void cvt_iqu8_range(const uint8_t* src, float* re, float* im,
                           size_t lo, size_t hi, float scale) {
    for (size_t i = lo; i < hi; ++i) {
        re[i] = (static_cast<float>(src[2 * i]) - 127.5f) * scale;
        im[i] = (static_cast<float>(src[2 * i + 1]) - 127.5f) * scale;
    }
}

static void cvt_i16_f32_range(const int16_t* src, float* dst,
                              size_t lo, size_t hi, float scale) {
    for (size_t i = lo; i < hi; ++i)
        dst[i] = static_cast<float>(src[i]) * scale;
}

static void cvt_f32_i16_range(const float* src, int16_t* dst,
                              size_t lo, size_t hi, float scale) {
    for (size_t i = lo; i < hi; ++i) {
        float v = src[i] * scale;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        dst[i] = static_cast<int16_t>(v);
    }
}

extern "C" {

// Interleaved int16 IQ -> separate re/im float planes, scaled by 1/32768.
void sdsp_cvt_iq16_planes(const int16_t* src, float* re, float* im,
                          size_t npairs, float scale) {
    cvt_iq16_range(src, re, im, 0, npairs, scale);
}

void sdsp_cvt_iq16_planes_mt(const int16_t* src, float* re, float* im,
                             size_t npairs, float scale, int nthreads) {
    parallel_for(npairs, npairs * 12, nthreads,
                 [=](size_t lo, size_t hi) {
                     cvt_iq16_range(src, re, im, lo, hi, scale);
                 });
}

// Interleaved uint8 IQ (RTL-SDR convention, offset 127.5) -> planes.
void sdsp_cvt_iqu8_planes(const uint8_t* src, float* re, float* im,
                          size_t npairs, float scale) {
    cvt_iqu8_range(src, re, im, 0, npairs, scale);
}

void sdsp_cvt_iqu8_planes_mt(const uint8_t* src, float* re, float* im,
                             size_t npairs, float scale, int nthreads) {
    parallel_for(npairs, npairs * 10, nthreads,
                 [=](size_t lo, size_t hi) {
                     cvt_iqu8_range(src, re, im, lo, hi, scale);
                 });
}

// Real int16 -> float32.
void sdsp_cvt_i16_f32(const int16_t* src, float* dst, size_t n, float scale) {
    cvt_i16_f32_range(src, dst, 0, n, scale);
}

void sdsp_cvt_i16_f32_mt(const int16_t* src, float* dst, size_t n,
                         float scale, int nthreads) {
    parallel_for(n, n * 6, nthreads,
                 [=](size_t lo, size_t hi) {
                     cvt_i16_f32_range(src, dst, lo, hi, scale);
                 });
}

// float32 -> int16 with clamping (for writing demodulated audio out).
void sdsp_cvt_f32_i16(const float* src, int16_t* dst, size_t n, float scale) {
    cvt_f32_i16_range(src, dst, 0, n, scale);
}

void sdsp_cvt_f32_i16_mt(const float* src, int16_t* dst, size_t n,
                         float scale, int nthreads) {
    parallel_for(n, n * 6, nthreads,
                 [=](size_t lo, size_t hi) {
                     cvt_f32_i16_range(src, dst, lo, hi, scale);
                 });
}

// ---------------------------------------------------------------------------
// Background file reader: a thread that streams a file into a ring buffer.
// ---------------------------------------------------------------------------

struct SdspFileSource {
    SdspRing* ring;         // not owned
    std::FILE* fp;          // owned
    std::thread worker;
    std::atomic<int> state; // 0 running, 1 eof, 2 stop requested, 3 error
    size_t chunk;
};

static void file_source_loop(SdspFileSource* s) {
    uint8_t* tmp = static_cast<uint8_t*>(std::malloc(s->chunk));
    if (!tmp) { s->state.store(3); return; }
    while (s->state.load(std::memory_order_relaxed) == 0) {
        const size_t got = std::fread(tmp, 1, s->chunk, s->fp);
        if (got == 0) { s->state.store(1); break; }
        size_t off = 0;
        while (off < got && s->state.load(std::memory_order_relaxed) == 0) {
            off += sdsp_ring_push(s->ring, tmp + off, got - off);
            if (off < got)  // ring full: let the consumer drain
                std::this_thread::yield();
        }
    }
    std::free(tmp);
}

SdspFileSource* sdsp_file_source_start(const char* path, SdspRing* ring,
                                       size_t chunk) {
    std::FILE* fp = std::fopen(path, "rb");
    if (!fp) return nullptr;
    auto* s = new SdspFileSource();
    s->ring = ring;
    s->fp = fp;
    s->chunk = chunk ? chunk : (1 << 16);
    s->state.store(0);
    s->worker = std::thread(file_source_loop, s);
    return s;
}

// 0 running, 1 eof, 2 stopped, 3 error
int sdsp_file_source_state(const SdspFileSource* s) { return s->state.load(); }

void sdsp_file_source_stop(SdspFileSource* s) {
    if (!s) return;
    int expected = 0;
    s->state.compare_exchange_strong(expected, 2);
    if (s->worker.joinable()) s->worker.join();
    std::fclose(s->fp);
    delete s;
}

// ---------------------------------------------------------------------------
// Background file sink: a thread draining a ring buffer into a file — the
// output mirror of SdspFileSource (e.g. demodulated audio from the CLI rx
// loop).  On stop it drains whatever remains in the ring before closing,
// so producer-side "push then stop" never loses bytes.
// ---------------------------------------------------------------------------

struct SdspFileSink {
    SdspRing* ring;               // not owned
    std::FILE* fp;                // owned
    std::thread worker;
    std::atomic<int> state;       // 0 running, 2 stop requested, 3 error
    std::atomic<uint64_t> written;
    size_t chunk;
};

static void file_sink_loop(SdspFileSink* s) {
    uint8_t* tmp = static_cast<uint8_t*>(std::malloc(s->chunk));
    if (!tmp) { s->state.store(3); return; }
    for (;;) {
        const size_t got = sdsp_ring_pop(s->ring, tmp, s->chunk);
        if (got) {
            if (std::fwrite(tmp, 1, got, s->fp) != got) {
                s->state.store(3);
                break;
            }
            s->written.fetch_add(got, std::memory_order_relaxed);
        } else if (s->state.load(std::memory_order_relaxed) != 0) {
            break;  // stop requested AND ring drained
        } else {
            std::this_thread::yield();
        }
    }
    std::free(tmp);
}

SdspFileSink* sdsp_file_sink_start(const char* path, SdspRing* ring,
                                   size_t chunk) {
    std::FILE* fp = std::fopen(path, "wb");
    if (!fp) return nullptr;
    auto* s = new SdspFileSink();
    s->ring = ring;
    s->fp = fp;
    s->chunk = chunk ? chunk : (1 << 16);
    s->state.store(0);
    s->written.store(0);
    s->worker = std::thread(file_sink_loop, s);
    return s;
}

int sdsp_file_sink_state(const SdspFileSink* s) { return s->state.load(); }

uint64_t sdsp_file_sink_written(const SdspFileSink* s) {
    return s->written.load();
}

// Drains the ring, flushes, closes, frees.  Returns total bytes written.
uint64_t sdsp_file_sink_stop(SdspFileSink* s) {
    if (!s) return 0;
    int expected = 0;
    s->state.compare_exchange_strong(expected, 2);
    if (s->worker.joinable()) s->worker.join();
    std::fflush(s->fp);
    std::fclose(s->fp);
    const uint64_t total = s->written.load();
    delete s;
    return total;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Maximum-length-sequence (MLS) generator — Fibonacci LFSR.
//
// The recurrence is inherently serial bit work (the one workload in the
// framework that belongs in native code rather than numpy or XLA):
// with s[0:nbits] = state, the output is seq[i] = s[i] and
// s[i+nbits] = s[i] ^ XOR_{t in taps} s[i+t].  Generates in place into
// `out` (seq IS the s-stream), then advances a copy of the window to
// produce the final state for streaming continuation.
// ---------------------------------------------------------------------------

void sdsp_mls(int32_t nbits, const int32_t* taps, int32_t ntaps,
              const uint8_t* state_in, uint8_t* out, int64_t n_out,
              uint8_t* state_out) {
    const int64_t head = n_out < nbits ? n_out : nbits;
    for (int64_t i = 0; i < head; ++i) out[i] = state_in[i];
    for (int64_t i = 0; i + nbits < n_out; ++i) {
        uint8_t fb = out[i];
        for (int32_t t = 0; t < ntaps; ++t) fb ^= out[i + taps[t]];
        out[i + nbits] = fb;
    }
    // Final state: the window s[n_out : n_out + nbits].  Continue the
    // recurrence in a scratch window seeded from the stream tail.
    uint8_t win[64];
    if (n_out >= nbits) {
        for (int32_t j = 0; j < nbits; ++j)
            win[j] = out[n_out - nbits + j];
        for (int32_t step = 0; step < nbits; ++step) {
            uint8_t fb = win[0];
            for (int32_t t = 0; t < ntaps; ++t) fb ^= win[taps[t]];
            std::memmove(win, win + 1, static_cast<size_t>(nbits - 1));
            win[nbits - 1] = fb;
        }
    } else {
        for (int32_t j = 0; j < nbits; ++j) win[j] = state_in[j];
        for (int64_t step = 0; step < n_out; ++step) {
            uint8_t fb = win[0];
            for (int32_t t = 0; t < ntaps; ++t) fb ^= win[taps[t]];
            std::memmove(win, win + 1, static_cast<size_t>(nbits - 1));
            win[nbits - 1] = fb;
        }
    }
    for (int32_t j = 0; j < nbits; ++j) state_out[j] = win[j];
}

}  // extern "C" (MLS)
