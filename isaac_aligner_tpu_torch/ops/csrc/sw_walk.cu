// Traceback walk and rescore of banded Smith-Waterman pairs, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package walks each pair's traceback on
// the host (isaac_aligner_tpu/align/gapped.py, polish_gapped: ops/sw.py
// traceback and ops_to_cigar, then rescore_cigar, per pair in Python); the
// port did the same until this kernel, at ~150-210 us a pair, while
// banded_sw's outputs, the queries and the windows already lay on the card.
// Per pair it does what that loop does, bit for bit:
//   exit_d = the first d of the largest gfin[d] (numpy's argmax);
//   walk from (L-1, exit_d) in state G: G emits M (first_db = i + d, next
//   state TG, i -= 1), E emits D (first_db = i + d, next TE, d -= 1),
//   F and the unused code 3 emit I (next TF, i -= 1, d += 1), until i < 0;
//   run-length encode the ops in query order;
//   a pair whose ops hold an I or a D is "gapped", and only a gapped pair is
//   rescored as rescore_cigar does: float64 log-probabilities summed in
//   query order over the M bases (a query N always matches, a window N never
//   does), mismatches, edit distance (I and D lengths, M bases that differ
//   or are N) and the normalized score (mismatch, gap open + min(max
//   extend, (len-1) * extend) per gap), the reference read from the window
//   at first_db onwards.
//
// Output row of a pair, int32 [HDR + 2L + 15]: first_db, runs, flags
// (1 gapped, 2 bad), mismatches, edit, norm, the float64 log-probability as
// its low and high words, then the runs, (len << 2) | op with op 0 M, 1 I,
// 2 D, zero past the last.  A walk takes at most 2L + 14 steps: L of G and
// F, and E steps can only undo the band offset, at most exit_d <= 15 plus
// one a F step.  So runs never overflow 2L + 15 slots; the walk stops at
// 2L + 15 steps or on leaving the band, and a quality past the tables sets
// "bad", so a corrupt input cannot hang the card or read past a buffer.  A
// bad row is zero but for its flags; the wrapper raises on one.
//
// Bound on this card.  Neither bytes nor operations.  The work needs per
// pair gfin (64 B), one 32-byte sector of traceback words for each 5 query
// rows (the walk visits every row: 960 B at L = 150), the 32-byte header
// and its runs (~2.4 a walk), and for a gapped walk the query, the
// qualities and the window bases its M runs read: ~1.3 kB a pair at
// L = 150, ~3.2 MB for the polish's ~2,400 pairs, ~1 us at 3.35 TB/s
// (chip_smoke.walk_bound).  The kernel moves more, ~3.7 kB a pair (every
// traceback word staged, the whole fixed-width row written, zero fill
// included), which costs nothing while the chain sets the time.  Its
// ~2L + 15 walk steps and L rescore terms are a few thousand instructions.
// What bounds it is the latency of one pair's serial chain: each walk step
// needs the state of the one before, and float64 bit-equality needs the sum
// in query order, one dependent add a base.
//
// Design: a warp per pair.  Its 32 lanes stage the pair's traceback words
// (16-byte loads), query, window and qualities in shared memory, so no step
// of the chain waits on device memory; lane 0 then walks and rescores out of
// shared memory, and the warp writes the row, runs and zero fill, with
// coalesced stores.  The block's first threads stage the two 100-entry
// float64 tables.  Blocks hold up to four warps, fewer when a long L would
// push the stage past 48 KB; the ~2,400 pairs of a launch all fit on the
// card at once (~18 warps an SM, of the ~40 its 48 registers allow), so
// a launch costs a few chains sharing each scheduler, not a queue of blocks:
// 0.028 ms at 1,300 pairs and 0.035-0.039 ms at 2,400 of 150 bp on an H100,
// a few percent of the byte bound (PERF.md has the times).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;
constexpr int TB_PACK = 5;
constexpr int MAX_L = 1024;       // banded_sw.cu's limit
constexpr int MAX_Q = 100;        // align/quality.py MAX_Q: the tables' size
constexpr int HDR = 8;
constexpr int MAX_WARPS = 4;
constexpr int STAGE_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

enum { OP_M = 0, OP_I = 1, OP_D = 2 };
enum { GAPPED = 1, BAD = 2 };

struct Norms {
  int mismatch, open, extend, max_extend;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int tb_groups(int l) {
  return (l + TB_PACK - 1) / TB_PACK;
}
__host__ __device__ constexpr int max_runs(int l) { return 2 * l + BAND - 1; }

__host__ __device__ constexpr int table_bytes() { return 2 * MAX_Q * 8; }

// one warp's stage: traceback words [groups][BAND], runs, then the query,
// window and quality bytes, each part a multiple of 16 bytes
__host__ __device__ constexpr int warp_stage_bytes(int l) {
  return 4 * tb_groups(l) * BAND + round16(4 * max_runs(l)) + round16(l) +
         round16(l + BAND - 1) + round16(l);
}

__device__ __forceinline__ int gap_norm(int len, const Norms& nm) {
  return nm.open + min(nm.max_extend, (len - 1) * nm.extend);
}

__global__ void sw_walk_kernel(const float* __restrict__ gfin,
                               const int32_t* __restrict__ tb,
                               const uint8_t* __restrict__ query,
                               const uint8_t* __restrict__ window,
                               const uint8_t* __restrict__ quals,
                               const double* __restrict__ log_match,
                               const double* __restrict__ log_mismatch, int n,
                               int l, Norms nm, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_lm = reinterpret_cast<double*>(smem);
  double* s_lmm = s_lm + MAX_Q;
  for (int k = threadIdx.x; k < MAX_Q; k += blockDim.x) {
    s_lm[k] = log_match[k];
    s_lmm[k] = log_mismatch[k];
  }
  __syncthreads();  // the only block-wide barrier: warps may leave below

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (p >= n) return;
  const int groups = tb_groups(l);
  const int w = l + BAND - 1;
  const int nr_max = max_runs(l);
  unsigned char* stage = smem + table_bytes() + warp * warp_stage_bytes(l);
  int32_t* s_tb = reinterpret_cast<int32_t*>(stage);
  int32_t* s_runs = s_tb + groups * BAND;
  uint8_t* s_q = reinterpret_cast<uint8_t*>(stage) + 4 * groups * BAND +
                 round16(4 * nr_max);
  uint8_t* s_db = s_q + round16(l);
  uint8_t* s_ql = s_db + round16(w);

  // a pair's traceback words are 64 * groups contiguous bytes
  const int4* g_tb4 = reinterpret_cast<const int4*>(tb + p * groups * BAND);
  int4* s_tb4 = reinterpret_cast<int4*>(s_tb);
  for (int k = lane; k < groups * BAND / 4; k += 32) s_tb4[k] = g_tb4[k];
  for (int k = lane; k < l; k += 32) {
    s_q[k] = query[p * l + k];
    s_ql[k] = quals[p * l + k];
  }
  for (int k = lane; k < w; k += 32) s_db[k] = window[p * w + k];
  __syncwarp();

  int32_t* o = out + p * (HDR + nr_max);
  int nr = 0;
  if (lane == 0) {
    const float* g = gfin + p * BAND;
    int d = 0;
    float best = g[0];
    for (int k = 1; k < BAND; ++k) {
      if (g[k] > best) {
        best = g[k];
        d = k;
      }
    }
    // the walk, its runs in walk (reverse) order
    int i = l - 1, state = 0, first_db = 0, flags = 0;
    int cur = -1, len = 0;
    for (int step = 0; i >= 0; ++step) {
      if (step == nr_max || d < 0 || d >= BAND) {
        flags = BAD;
        break;
      }
      const int code =
          (s_tb[(i / TB_PACK) * BAND + d] >> (6 * (i % TB_PACK))) & 63;
      int op;
      if (state == 0) {
        op = OP_M;
        first_db = i + d;
        state = code & 3;
        --i;
      } else if (state == 1) {
        op = OP_D;
        first_db = i + d;
        state = (code >> 2) & 3;
        --d;
      } else {
        op = OP_I;
        state = (code >> 4) & 3;
        --i;
        ++d;
      }
      if (op == cur) {
        ++len;
      } else {
        if (len) s_runs[nr++] = (len << 2) | cur;
        cur = op;
        len = 1;
      }
    }
    if (len && flags == 0) s_runs[nr++] = (len << 2) | cur;
    for (int k = 0; k < nr && flags == 0; ++k) {
      if ((s_runs[k] & 3) != OP_M) flags = GAPPED;
    }

    double lp = 0.0;
    int nmm = 0, edit = 0, norm = 0;
    if (flags == GAPPED) {
      int qpos = 0, rpos = first_db;
      for (int k = nr - 1; k >= 0; --k) {
        const int rl = s_runs[k] >> 2, op = s_runs[k] & 3;
        if (op == OP_M) {
          for (int j = 0; j < rl; ++j, ++qpos, ++rpos) {
            const int s = s_q[qpos], r = s_db[rpos], q = s_ql[qpos];
            if (q >= MAX_Q) flags = BAD;
            const int qi = min(q, MAX_Q - 1);
            if (s == 4 || (s == r && r != 4)) {
              lp += s_lm[qi];
            } else {
              lp += s_lmm[qi];
              ++nmm;
              norm += nm.mismatch;
            }
            if (s != r || s == 4) ++edit;
          }
        } else {
          if (op == OP_I) {
            qpos += rl;
          } else {
            rpos += rl;
          }
          edit += rl;
          norm += gap_norm(rl, nm);
        }
      }
    }
    if (flags & BAD) {
      flags = BAD;
      nr = 0;
      first_db = nmm = edit = norm = 0;
      lp = 0.0;
    }
    const unsigned long long bits =
        static_cast<unsigned long long>(__double_as_longlong(lp));
    o[0] = first_db;
    o[1] = nr;
    o[2] = flags;
    o[3] = nmm;
    o[4] = edit;
    o[5] = norm;
    o[6] = static_cast<int32_t>(bits & 0xffffffffu);
    o[7] = static_cast<int32_t>(bits >> 32);
  }
  nr = __shfl_sync(FULL, nr, 0);
  __syncwarp();
  // runs in query order, zero past the last
  for (int k = lane; k < nr_max; k += 32) {
    o[HDR + k] = k < nr ? s_runs[nr - 1 - k] : 0;
  }
}

}  // namespace

// gfin f32 [N, 16] and tb int32 [N, ceil(L / 5), 16] as banded_sw writes
// them; query and quals uint8 [N, L], window uint8 [N, L + 15]; the two
// float64 tables [100]; out int32 [N, 8 + 2L + 15].  All device pointers,
// row-major and contiguous, tb 16-byte aligned.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for L > sw_walk_max_len()).
extern "C" int sw_walk_launch(const void* gfin, const void* tb,
                              const void* query, const void* window,
                              const void* quals, const void* log_match,
                              const void* log_mismatch, int n, int l,
                              int norm_mismatch, int norm_open,
                              int norm_extend, int norm_max_extend, void* out,
                              void* stream) {
  if (n <= 0 || l <= 0) return 0;
  if (l > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  int warps = (STAGE_LIMIT - table_bytes()) / warp_stage_bytes(l);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  const int smem = table_bytes() + warps * warp_stage_bytes(l);
  const unsigned blocks = static_cast<unsigned>((n + warps - 1) / warps);
  sw_walk_kernel<<<blocks, 32 * warps, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gfin), static_cast<const int32_t*>(tb),
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(window),
      static_cast<const uint8_t*>(quals),
      static_cast<const double*>(log_match),
      static_cast<const double*>(log_mismatch), n, l,
      Norms{norm_mismatch, norm_open, norm_extend, norm_max_extend},
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The longest query the kernel takes, the row layout's header length and
// the entries of each quality table.
extern "C" int sw_walk_max_len() { return MAX_L; }
extern "C" int sw_walk_header() { return HDR; }
extern "C" int sw_walk_quals() { return MAX_Q; }
