// Fused BAM record-core assembler — native runtime component of the BAM
// serializer.
//
// Reference analog: the reference assembles each BAM record with
// per-field memcpy in C++ (lib/bam/Bam.cpp serialize(),
// build/FragmentAccessorBamAdapter.hh).  Our vectorized-numpy assembly
// (build/records.py to_bam_bytes) made ~10 full passes over [N, L]
// arrays (nibble lookup, where-masks, strided shifts, fancy scatters) —
// ~0.8-2 s per 524k records on the 2-core host, squarely on the e2e
// critical path.  This one-pass writer emits the fixed BAM record core
// (36-byte header + name + cigar + packed seq + qual) per record with
// plain stores, releases the GIL, and parallelizes over a thread count
// chosen by the caller.  Tag sections (variable presence) stay in numpy.
//
// Build: see native/build.py (g++ -O2 -shared -fPIC bamrec.cpp -lpthread).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const uint8_t kNib[5] = {1, 2, 4, 8, 15};

struct Args {
    uint8_t* out;
    const int64_t* u_start;
    const int32_t* body_size;
    const int32_t* ref_id;
    const int32_t* pos;
    const uint8_t* mapq;
    const uint16_t* bin;
    const uint16_t* n_cig;
    const uint16_t* flag;
    const int32_t* lseq;
    const int32_t* mate_ref;
    const int32_t* mate_pos;
    const int32_t* tlen;
    const uint8_t* name_bytes;
    int64_t name_w;
    const int32_t* name_len;
    const uint32_t* cigar_ops;
    int64_t cig_w;
    const uint8_t* seq;
    const uint8_t* qual;
    int64_t L;
};

inline void put_i32(uint8_t* p, int32_t v) { std::memcpy(p, &v, 4); }
inline void put_u16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

void assemble_range(const Args& a, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
        uint8_t* p = a.out + a.u_start[i];
        const int32_t lseq = a.lseq[i];
        const int32_t nlen = a.name_len[i];
        const int32_t ncig = a.n_cig[i];
        // block_size + 36-byte fixed header (little-endian)
        put_i32(p, a.body_size[i]);
        put_i32(p + 4, a.ref_id[i]);
        put_i32(p + 8, a.pos[i]);
        p[12] = static_cast<uint8_t>(nlen + 1);
        p[13] = a.mapq[i];
        put_u16(p + 14, a.bin[i]);
        put_u16(p + 16, a.n_cig[i]);
        put_u16(p + 18, a.flag[i]);
        put_i32(p + 20, lseq);
        put_i32(p + 24, a.mate_ref[i]);
        put_i32(p + 28, a.mate_pos[i]);
        put_i32(p + 32, a.tlen[i]);
        p += 36;
        // name + NUL
        std::memcpy(p, a.name_bytes + i * a.name_w,
                    static_cast<size_t>(nlen));
        p[nlen] = 0;
        p += nlen + 1;
        // cigar words
        if (ncig > 0) {
            std::memcpy(p, a.cigar_ops + i * a.cig_w,
                        static_cast<size_t>(ncig) * 4);
            p += static_cast<int64_t>(ncig) * 4;
        }
        // seq nibbles (codes 0-3 = ACGT, >=4 = N); pad nibble 0
        const uint8_t* s = a.seq + i * a.L;
        int32_t j = 0;
        for (; j + 1 < lseq; j += 2) {
            uint8_t hi_n = kNib[s[j] > 4 ? 4 : s[j]];
            uint8_t lo_n = kNib[s[j + 1] > 4 ? 4 : s[j + 1]];
            *p++ = static_cast<uint8_t>((hi_n << 4) | lo_n);
        }
        if (j < lseq)
            *p++ = static_cast<uint8_t>(kNib[s[j] > 4 ? 4 : s[j]] << 4);
        // qual clipped to 93
        const uint8_t* q = a.qual + i * a.L;
        for (int32_t k = 0; k < lseq; ++k)
            p[k] = q[k] > 93 ? 93 : q[k];
    }
}

}  // namespace

extern "C" {

void assemble_bam_core(
    uint8_t* out, const int64_t* u_start, const int32_t* body_size,
    const int32_t* ref_id, const int32_t* pos, const uint8_t* mapq,
    const uint16_t* bin, const uint16_t* n_cig, const uint16_t* flag,
    const int32_t* lseq, const int32_t* mate_ref, const int32_t* mate_pos,
    const int32_t* tlen, const uint8_t* name_bytes, int64_t name_w,
    const int32_t* name_len, const uint32_t* cigar_ops, int64_t cig_w,
    const uint8_t* seq, const uint8_t* qual, int64_t L, int64_t n,
    int32_t threads) {
    Args a{out, u_start, body_size, ref_id, pos, mapq, bin, n_cig, flag,
           lseq, mate_ref, mate_pos, tlen, name_bytes, name_w, name_len,
           cigar_ops, cig_w, seq, qual, L};
    if (threads <= 1 || n < 4096) {
        assemble_range(a, 0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t step = (n + threads - 1) / threads;
    for (int32_t t = 0; t < threads; ++t) {
        int64_t lo = t * step;
        int64_t hi = lo + step < n ? lo + step : n;
        if (lo >= hi) break;
        ts.emplace_back([&a, lo, hi] { assemble_range(a, lo, hi); });
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
