// BGZF block compression — native runtime component.
//
// Reference analog: src/c++/lib/bgzf/BgzfCompressor.cpp (zlib raw-deflate
// per 64KB block wrapped in the BGZF/gzip member format with the BC extra
// field).  This library compresses many blocks in parallel with a simple
// pthread pool; the Python layer (io/bgzf.py) feeds it the concatenated
// uncompressed stream and receives the concatenated BGZF members.
//
// Build: see native/build.py (g++ -O2 -shared -fPIC bgzf.cpp -lz -lpthread).

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

constexpr int kHeaderLen = 18;
constexpr int kFooterLen = 8;

// Compress one block of input into a complete BGZF member.
// Returns the member's total byte length, or -1 on failure.
int compress_block(const uint8_t* in, int in_len, uint8_t* out, int out_cap,
                   int level) {
    if (out_cap < kHeaderLen + kFooterLen + 16) return -1;
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    // raw deflate (windowBits < 0), gzip wrapper written manually
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
        return -1;
    zs.next_in = const_cast<uint8_t*>(in);
    zs.avail_in = in_len;
    zs.next_out = out + kHeaderLen;
    zs.avail_out = out_cap - kHeaderLen - kFooterLen;
    int ret = deflate(&zs, Z_FINISH);
    int cdata = static_cast<int>(zs.total_out);
    deflateEnd(&zs);
    if (ret != Z_STREAM_END) return -1;

    int bsize = kHeaderLen + cdata + kFooterLen;  // total member size
    if (bsize > 65536) return -1;                  // BGZF member limit
    // gzip header with BC extra field
    static const uint8_t hdr[16] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
        0x06, 0x00, 0x42, 0x43, 0x02, 0x00};
    std::memcpy(out, hdr, 16);
    out[16] = static_cast<uint8_t>((bsize - 1) & 0xff);
    out[17] = static_cast<uint8_t>(((bsize - 1) >> 8) & 0xff);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, in, in_len);
    std::memcpy(out + kHeaderLen + cdata, &crc, 4);
    uint32_t isize = static_cast<uint32_t>(in_len);
    std::memcpy(out + kHeaderLen + cdata + 4, &isize, 4);
    return bsize;
}

}  // namespace

extern "C" {

// Compress `n_blocks` independent blocks in parallel.
//   in:        concatenated input data
//   in_offsets: n_blocks+1 offsets delimiting each block in `in`
//   out:       output arena, `out_stride` bytes reserved per block
//   out_lens:  per-block compressed member lengths (output)
//   level:     zlib level (1..9; reference uses 1 by default for speed)
//   threads:   worker threads
// Returns 0 on success, -1 if any block failed.
int bgzf_compress_many(const uint8_t* in, const int64_t* in_offsets,
                       int n_blocks, uint8_t* out, int64_t out_stride,
                       int* out_lens, int level, int threads) {
    std::atomic<int> next(0);
    std::atomic<int> failed(0);
    auto worker = [&]() {
        for (;;) {
            int b = next.fetch_add(1);
            if (b >= n_blocks || failed.load()) return;
            const uint8_t* src = in + in_offsets[b];
            int len = static_cast<int>(in_offsets[b + 1] - in_offsets[b]);
            int r = compress_block(src, len, out + b * out_stride,
                                   static_cast<int>(out_stride), level);
            if (r < 0) { failed.store(1); return; }
            out_lens[b] = r;
        }
    };
    if (threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return failed.load() ? -1 : 0;
}

// Decompress one BGZF member; returns uncompressed length or -1.
int bgzf_decompress_block(const uint8_t* in, int in_len, uint8_t* out,
                          int out_cap) {
    if (in_len < kHeaderLen + kFooterLen) return -1;
    uint32_t isize;
    std::memcpy(&isize, in + in_len - 4, 4);
    if (static_cast<int>(isize) > out_cap) return -1;
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return -1;
    zs.next_in = const_cast<uint8_t*>(in + kHeaderLen);
    zs.avail_in = in_len - kHeaderLen - kFooterLen;
    zs.next_out = out;
    zs.avail_out = out_cap;
    int ret = inflate(&zs, Z_FINISH);
    int n = static_cast<int>(zs.total_out);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END) return -1;
    return n;
}

}  // extern "C"
