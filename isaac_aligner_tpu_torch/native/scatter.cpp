// Ragged byte scatter — native runtime component of the BAM serializer.
//
// Reference analog: the reference assembles BAM records with per-field
// memcpy in C++ (lib/bam/Bam.cpp serialize(), build/
// FragmentAccessorBamAdapter.hh); our vectorized-numpy assembly
// (build/records.py to_bam_bytes) was profiled with the fancy-index
// scatters as its dominant cost.  These two entry points replace them
// with row-wise memcpy: out[dest[i] : dest[i]+len[i]] = src[i, :len[i]].
//
// Build: see native/build.py (g++ -O2 -shared -fPIC scatter.cpp).

#include <cstdint>
#include <cstring>

extern "C" {

// Variable-width rows: src is [n, src_stride], lens[i] <= src_stride.
void ragged_scatter(uint8_t* out, const int64_t* dest, const uint8_t* src,
                    int64_t src_stride, const int64_t* lens, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t len = lens[i];
        if (len > 0)
            std::memcpy(out + dest[i], src + i * src_stride,
                        static_cast<size_t>(len));
    }
}

// Uniform width: src is [n, width] contiguous.
void fixed_scatter(uint8_t* out, const int64_t* dest, const uint8_t* src,
                   int64_t width, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        std::memcpy(out + dest[i], src + i * width,
                    static_cast<size_t>(width));
}

}  // extern "C"
