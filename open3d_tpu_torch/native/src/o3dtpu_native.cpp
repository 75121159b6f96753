// o3dtpu_native: host-side native runtime for the TPU framework.
//
// Reference equivalents: the reference's C++ IO/runtime layer —
// io/file_format/FilePCD.cpp (LZF codec), utility/FileSystem.cpp, and the
// host-side data path feeding device kernels. On TPU the device compute is
// XLA; this library owns the host-side hot path instead: LZF
// compress/decompress for PCD binary_compressed, PLY/PCD binary record
// (de)interleaving, and a threaded read-ahead file prefetcher that overlaps
// disk IO with device compute (the TPU-native equivalent of the
// reference's multiprocessing frame loaders,
// examples/python/reconstruction_system/make_fragments.py:180).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LZF codec (liblzf block format: literal runs + back references)
// ---------------------------------------------------------------------------

// Decompress `slen` bytes from src into dst (capacity dlen).
// Returns decompressed size, or -1 on malformed input / overflow.
long o3d_lzf_decompress(const uint8_t* src, long slen, uint8_t* dst, long dlen) {
    long i = 0, o = 0;
    while (i < slen) {
        uint32_t ctrl = src[i++];
        if (ctrl < 32) {  // literal run of ctrl+1 bytes
            long run = (long)ctrl + 1;
            if (i + run > slen || o + run > dlen) return -1;
            std::memcpy(dst + o, src + i, (size_t)run);
            i += run;
            o += run;
        } else {  // back-reference
            long len = (long)(ctrl >> 5);
            if (len == 7) {
                if (i >= slen) return -1;
                len += src[i++];
            }
            if (i >= slen) return -1;
            long ref = o - (long)((ctrl & 0x1f) << 8) - (long)src[i++] - 1;
            if (ref < 0 || o + len + 2 > dlen) return -1;
            // overlapping copy must run forward byte-by-byte
            for (long k = 0; k < len + 2; ++k) dst[o + k] = dst[ref + k];
            o += len + 2;
        }
    }
    return o;
}

// Greedy hash-chain LZF compression (the standard liblzf strategy).
// Returns compressed size, or -1 if dst is too small.
long o3d_lzf_compress(const uint8_t* src, long slen, uint8_t* dst, long dlen) {
    if (slen < 4) {
        // tiny input: single literal run
        if (slen == 0 || slen + 1 > dlen) return slen == 0 ? 0 : -1;
        dst[0] = (uint8_t)(slen - 1);
        std::memcpy(dst + 1, src, (size_t)slen);
        return slen + 1;
    }
    constexpr int HLOG = 16;
    std::vector<long> htab((size_t)1 << HLOG, -1);
    auto hash3 = [&](long p) {
        uint32_t v = ((uint32_t)src[p] << 16) | ((uint32_t)src[p + 1] << 8) | src[p + 2];
        return (long)(((v * 2654435761u) >> (32 - HLOG)) & (((uint32_t)1 << HLOG) - 1));
    };
    long i = 0, o = 0, lit_start = 0;
    auto flush_literals = [&](long upto) -> bool {
        long n = upto - lit_start;
        while (n > 0) {
            long run = n > 32 ? 32 : n;
            if (o + run + 1 > dlen) return false;
            dst[o++] = (uint8_t)(run - 1);
            std::memcpy(dst + o, src + lit_start, (size_t)run);
            o += run;
            lit_start += run;
            n -= run;
        }
        return true;
    };
    while (i + 2 < slen) {
        long h = hash3(i);
        long ref = htab[(size_t)h];
        htab[(size_t)h] = i;
        long off = i - ref - 1;
        if (ref >= 0 && off < (1 << 13) &&
            src[ref] == src[i] && src[ref + 1] == src[i + 1] && src[ref + 2] == src[i + 2]) {
            long maxlen = slen - i;
            long len = 3;
            while (len < maxlen && len < 264 && src[ref + len] == src[i + len]) ++len;
            if (!flush_literals(i)) return -1;
            long enc = len - 2;  // encoded length
            if (enc < 7) {
                if (o + 2 > dlen) return -1;
                dst[o++] = (uint8_t)((enc << 5) | (off >> 8));
            } else {
                if (o + 3 > dlen) return -1;
                dst[o++] = (uint8_t)((7 << 5) | (off >> 8));
                dst[o++] = (uint8_t)(enc - 7);
            }
            dst[o++] = (uint8_t)(off & 0xff);
            i += len;
            lit_start = i;
        } else {
            ++i;
        }
    }
    if (!flush_literals(slen)) return -1;
    return o;
}

// ---------------------------------------------------------------------------
// Binary record (de)interleaving: AoS <-> SoA for PLY/PCD payloads.
// field_sizes: bytes per field; n_fields fields per record; n records.
// ---------------------------------------------------------------------------

void o3d_aos_to_soa(const uint8_t* src, long n, const long* field_sizes, long n_fields,
                    uint8_t** dst_columns) {
    long rec = 0;
    for (long f = 0; f < n_fields; ++f) rec += field_sizes[f];
    std::vector<long> offs(n_fields);
    long acc = 0;
    for (long f = 0; f < n_fields; ++f) { offs[(size_t)f] = acc; acc += field_sizes[f]; }
    for (long f = 0; f < n_fields; ++f) {
        const long sz = field_sizes[f];
        const uint8_t* s = src + offs[(size_t)f];
        uint8_t* d = dst_columns[f];
        for (long r = 0; r < n; ++r)
            std::memcpy(d + r * sz, s + r * rec, (size_t)sz);
    }
}

void o3d_soa_to_aos(uint8_t* const* src_columns, long n, const long* field_sizes,
                    long n_fields, uint8_t* dst) {
    long rec = 0;
    for (long f = 0; f < n_fields; ++f) rec += field_sizes[f];
    long acc = 0;
    for (long f = 0; f < n_fields; ++f) {
        const long sz = field_sizes[f];
        const uint8_t* s = src_columns[f];
        uint8_t* d = dst + acc;
        acc += sz;
        for (long r = 0; r < n; ++r)
            std::memcpy(d + r * rec, s + r * sz, (size_t)sz);
    }
}

// ---------------------------------------------------------------------------
// Threaded read-ahead file prefetcher.
//
// A pool of worker threads reads whole files into memory ahead of the
// consumer; `o3d_prefetcher_get` blocks until file i is resident and hands
// the buffer over. Double-buffering depth bounds resident memory.
// ---------------------------------------------------------------------------

struct Prefetcher {
    std::vector<std::string> paths;
    long depth;                       // max resident buffers ahead of cursor
    std::atomic<long> cursor{0};      // next index the consumer will take
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::unordered_map<long, std::vector<uint8_t>> ready;
    std::atomic<long> next_job{0};
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    void worker() {
        while (!stop.load()) {
            long j = next_job.fetch_add(1);
            if (j >= (long)paths.size()) return;
            // throttle: stay within `depth` of the consumer cursor
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] { return stop.load() || j < cursor.load() + depth; });
                if (stop.load()) return;
            }
            std::vector<uint8_t> buf;
            FILE* f = std::fopen(paths[(size_t)j].c_str(), "rb");
            if (f) {
                std::fseek(f, 0, SEEK_END);
                long sz = std::ftell(f);
                std::fseek(f, 0, SEEK_SET);
                buf.resize((size_t)(sz > 0 ? sz : 0));
                if (sz > 0 && std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz)
                    buf.clear();
                std::fclose(f);
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                ready[j] = std::move(buf);
            }
            cv_ready.notify_all();
        }
    }
};

void* o3d_prefetcher_create(const char** paths, long n, long n_threads, long depth) {
    auto* p = new Prefetcher();
    p->paths.reserve((size_t)n);
    for (long i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
    p->depth = depth > 0 ? depth : 8;
    long nt = n_threads > 0 ? n_threads : 2;
    for (long t = 0; t < nt; ++t) p->workers.emplace_back(&Prefetcher::worker, p);
    return p;
}

// Blocks until file i is resident; returns its size (buffer stays resident).
long o3d_prefetcher_wait(void* handle, long i) {
    auto* p = static_cast<Prefetcher*>(handle);
    std::unique_lock<std::mutex> lk(p->mu);
    p->cursor.store(i);
    p->cv_space.notify_all();
    p->cv_ready.wait(lk, [&] { return p->ready.count(i) > 0; });
    return (long)p->ready[i].size();
}

// Copies file i (must be resident — call wait first) into out and frees the
// internal buffer. Returns bytes copied, -1 if absent or capacity too small.
long o3d_prefetcher_take(void* handle, long i, uint8_t* out, long capacity) {
    auto* p = static_cast<Prefetcher*>(handle);
    std::unique_lock<std::mutex> lk(p->mu);
    auto it = p->ready.find(i);
    if (it == p->ready.end()) return -1;
    long sz = (long)it->second.size();
    if (sz > capacity) return -1;
    if (sz > 0) std::memcpy(out, it->second.data(), (size_t)sz);
    p->ready.erase(it);
    p->cv_space.notify_all();
    return sz;
}

// Non-blocking size query: returns -1 if not yet resident.
long o3d_prefetcher_peek_size(void* handle, long i) {
    auto* p = static_cast<Prefetcher*>(handle);
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->ready.find(i);
    return it == p->ready.end() ? -1 : (long)it->second.size();
}

void o3d_prefetcher_destroy(void* handle) {
    auto* p = static_cast<Prefetcher*>(handle);
    p->stop.store(true);
    p->cv_space.notify_all();
    p->cv_ready.notify_all();
    for (auto& t : p->workers) t.join();
    delete p;
}

}  // extern "C"
