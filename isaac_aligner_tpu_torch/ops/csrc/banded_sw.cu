// Banded affine-gap Smith-Waterman over a band of 16 diagonals, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_sw_body` launched by `banded_sw`
// (isaac_aligner_tpu/ops/sw.py:84-268, pl.pallas_call at :237).  Same
// recurrences and outputs, bit for bit (see that file's docstring):
//   cell (i, d) aligns query base i with window base i + d, d in [0, 16);
//   G[i,d] = max(G,E,F)[i-1,d] + W(q_i, db_{i+d})     (query N never matches)
//   F[i,d] = max(G[i-1,d+1]+open, E[i-1,d+1]+open, F[i-1,d+1]+extend)
//   E[i,d] = max(G[i,d-1]+open,   F[i,d-1]+open,   E[i,d-1]+extend)
//   row 0 starts free at any d; ties prefer G, then E, then F;
//   outputs: last-row G (f32 [N, 16]) and the traceback code
//   TG + 4*TE + 16*TF packed 6 bits per row, 5 rows per int32 word
//   ([N, ceil(L/5), 16]), both in the wrapper's public, pair-major layout.
//
// Bound on this card.  Per cell the recurrence needs 6 f32 adds (G's open
// serves both E and F) and about 27 other instructions (9 f32 max, 6 f32
// compares, 7 selects, 5 integer ops for the match test and the code
// word).  The CUDA programming guide's throughput table for compute
// capability 9.0 issues f32 adds at 128 lanes per SM per clock and
// compares, min/max and 32-bit integer ops at 64, on separate pipes that
// work at once; issue itself takes 128 lanes a clock.  The 27 half-rate
// instructions are the busier pipe, so at 1.98 GHz on 132 SMs (the
// 67 TFLOP/s of the data sheet) the card does at most ~620 G cells/s
// (1.61 ps a cell).  Memory is far below that: 2L+15 input bytes and
// 64 + 64*ceil(L/5) output bytes per pair, ~0.9 B per cell.  So issue
// bounds the work, and at the gapped polish's batch (~900 pairs, ~1.4 M
// cells) the bound is a few microseconds.
//
// What held the first design back was latency, not issue: one thread per
// pair walked 16 * L dependent cells, 7 blocks covered 132 SMs at ~900
// pairs, and each row carried a 15-step serial E chain.  This design puts
// the band across lanes and runs the rows as a wavefront:
//
// - Lane d of a 16-lane group owns band cell d.  At step t it computes row
//   i = (t - d) / 2, so the three neighbours of (i, d) are ready: (i-1, d)
//   is its own result two steps back, (i-1, d+1) lane d+1's and (i, d-1)
//   lane d-1's result of the step before.  After each step a lane sends
//   F's candidate for (i+1, d-1) down and E's candidate for (i, d+1) up,
//   value and tie code, with four width-16 shuffles.  A pair takes 2L + 15
//   dependent steps instead of 16 L.
// - Only every other (lane, step) has a cell of one pair, so each group
//   interleaves two pairs, the second one step behind the first: every lane
//   computes a cell on every step.  A warp holds four pairs and is a block;
//   ~900 pairs make ~225 warps.
// - Every cell runs the oracle's f32 operations in the oracle's order
//   (isaac_aligner_tpu/ops/sw.py:322-327; the port's banded_sw_torch and
//   banded_sw_numpy_batch run the same order), including the NEG sentinel at
//   d = 0 for E and past d = 15 for F, so the result is bit-equal by
//   construction.  Only adds and max: no multiply, so no FMA contraction.
// - No transposes.  The block's four pairs are consecutive rows of the
//   pair-major inputs, so their bytes are one contiguous span, staged into
//   shared memory with coalesced loads.  Traceback words go to a shared
//   stage in the public layout and leave as whole 16-byte vectors when the
//   pairs are done; each lane writes its last-row G straight to gfin.
// - A step's row updates are selects, not a branch, and the next row's
//   match weight is fetched a step ahead, so no shared-memory load lies on
//   the dependent path.
//
// What still holds it back: at the polish's batch each warp is alone on
// its scheduler, so a step costs the issue of its ~60 instructions plus the
// shuffle latency.  The chain of 2L + 15 steps cannot shrink: t = 2i + d is
// the fastest schedule that keeps E's serial order, which bit-equality
// needs (PERF.md has the times).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;
constexpr int TB_PACK = 5;
constexpr float NEG = -1.0e9f;
constexpr int PAIRS = 4;          // per warp = per block: 2 groups x 2 pairs
constexpr int THREADS = 32;
constexpr int MAX_L = 1024;       // keeps a block's stage at ~60 KB
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ constexpr int tb_groups(int l) {
  return (l + TB_PACK - 1) / TB_PACK;
}

// shared stage of one block: tb int32 [PAIRS][groups][BAND], then the
// query bytes [PAIRS][L] and the window bytes [PAIRS][L + 15]
__host__ __device__ constexpr int stage_bytes(int l) {
  return PAIRS * tb_groups(l) * BAND * 4 + round16(PAIRS * l) +
         round16(PAIRS * (l + BAND - 1));
}

__device__ __forceinline__ int pick3(float a, float b, float c) {
  // 0 = first (G), 1 = second (E), 2 = third (F); exact oracle order:
  // where(b > max(a, c), 1, where(c > a, 2, 0))
  return (b > fmaxf(a, c)) ? 1 : ((c > a) ? 2 : 0);
}

struct Scores {
  float match, mismatch, open, extend;
};

// One pair's state in one lane: its cell's last computed (G, E, F), the
// match weight of the row it computes next, the traceback word being
// filled and where that word goes.
struct Lane {
  float g, e, f, w;
  int32_t acc;
  int shift;
  int32_t* tb;
  const uint8_t* q;
  const uint8_t* db;   // already offset by d
};

// W(q_i, db_{i+d}) for row i clamped into [0, L)
__device__ __forceinline__ float weight(const Lane& c, int i, int l,
                                        const Scores& s) {
  const int r = min(max(i, 0), l - 1);
  const int qi = c.q[r];
  const int di = c.db[r];
  return (qi == di && qi < 4) ? s.match : s.mismatch;
}

// One wavefront step of one lane: receive the neighbours' candidates, step
// the owned cell if its row is in [0, L) (as selects, not a branch), fetch
// the next row's weight, then send this cell's candidates.  fx/fc (F for
// the lane below) and ex/ec (E for the lane above) carry the exchange from
// step to step; only the shuffles, the two selects and the candidate sums
// lie on the dependent path.
__device__ __forceinline__ void step(int t, int d, int l, const Scores& s,
                                     float f_edge, int fc_edge, Lane& c,
                                     float& fx, int& fc, float& ex, int& ec) {
  float fin = __shfl_down_sync(FULL, fx, 1, BAND);
  float ein = __shfl_up_sync(FULL, ex, 1, BAND);
  int fcin = __shfl_down_sync(FULL, fc, 1, BAND);
  int ecin = __shfl_up_sync(FULL, ec, 1, BAND);
  if (d == BAND - 1) {  // F past the band: the oracle's NEG fill
    fin = f_edge;
    fcin = fc_edge;
  }
  if (d == 0) {         // E before the band
    ein = NEG;
    ecin = 0;
  }
  const int i = (t - d) >> 1;
  const bool live = static_cast<unsigned>(i) < static_cast<unsigned>(l);
  const float m = fmaxf(fmaxf(c.g, c.e), c.f);
  const int tg = pick3(c.g, c.e, c.f);
  if (live) {
    c.g = m + c.w;
    c.e = ein;
    c.f = fin;
  }
  c.w = weight(c, i + 1, l, s);
  // candidates of this cell for F[i+1, d-1] and E[i, d+1] (rows < 0 send
  // the free start's G = 0, E = F = NEG)
  const float og = c.g + s.open, oe = c.e + s.open, of = c.f + s.open;
  const float xe = c.e + s.extend, xf = c.f + s.extend;
  fx = fmaxf(fmaxf(og, oe), xf);
  ex = fmaxf(fmaxf(og, of), xe);
  fc = pick3(og, oe, xf);
  ec = pick3(og, xe, of);
  // the traceback word of row i holds its code at bit 6 * (i % 5); it goes
  // to the stage after the fifth row or the last
  const int32_t acc = c.acc | ((tg + 4 * ecin + 16 * fcin) << c.shift);
  const bool flush = live && (c.shift == 6 * (TB_PACK - 1) || i == l - 1);
  if (flush) *c.tb = acc;
  c.tb += flush ? BAND : 0;
  c.acc = flush ? 0 : (live ? acc : c.acc);
  c.shift = flush ? 0 : (live ? c.shift + 6 : c.shift);
}

__global__ void __launch_bounds__(THREADS)
banded_sw_kernel(const uint8_t* __restrict__ query,
                 const uint8_t* __restrict__ window, int n, int l, Scores s,
                 float* __restrict__ gfin, int32_t* __restrict__ tb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = tb_groups(l);
  const int w = l + BAND - 1;
  int32_t* s_tb = reinterpret_cast<int32_t*>(smem);
  uint8_t* s_q = smem + PAIRS * groups * BAND * 4;
  uint8_t* s_db = s_q + round16(PAIRS * l);

  const int lane = threadIdx.x;
  const int64_t pair0 = static_cast<int64_t>(blockIdx.x) * PAIRS;
  const int np = n - pair0 < PAIRS ? static_cast<int>(n - pair0) : PAIRS;

  // the block's pairs are consecutive rows: one contiguous span each
  const uint8_t* gq = query + pair0 * l;
  for (int k = lane; k < np * l; k += THREADS) s_q[k] = gq[k];
  const uint8_t* gdb = window + pair0 * w;
  for (int k = lane; k < np * w; k += THREADS) s_db[k] = gdb[k];
  __syncwarp();

  const int d = lane & (BAND - 1);
  const int grp = lane / BAND;
  // set 0 runs on even steps: pair A of the group on even lanes, pair B
  // (one step behind) on odd lanes; set 1 the other pair
  Lane c[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int slot = 2 * grp + ((d & 1) ^ k);
    c[k] = Lane{0.0f, NEG, NEG, 0.0f, 0, 0, s_tb + slot * groups * BAND + d,
                s_q + slot * l, s_db + slot * w + d};
    c[k].w = weight(c[k], (k - d) >> 1, l, s);
  }
  const float f_edge = fmaxf(fmaxf(NEG + s.open, NEG + s.open), NEG + s.extend);
  const int fc_edge = pick3(NEG + s.open, NEG + s.open, NEG + s.extend);
  // the free start's candidates, for the first row of the lane below
  const float og0 = 0.0f + s.open, oe0 = NEG + s.open, of0 = NEG + s.open;
  const float xe0 = NEG + s.extend, xf0 = NEG + s.extend;
  float fx = fmaxf(fmaxf(og0, oe0), xf0);
  int fc = pick3(og0, oe0, xf0);
  float ex = fmaxf(fmaxf(og0, of0), xe0);
  int ec = pick3(og0, xe0, of0);

  // pair A ends at step 2(L-1) + 15, pair B one step later
  for (int t = 0; t < 2 * l + BAND - 1; t += 2) {
    step(t, d, l, s, f_edge, fc_edge, c[0], fx, fc, ex, ec);
    step(t + 1, d, l, s, f_edge, fc_edge, c[1], fx, fc, ex, ec);
  }
  __syncwarp();

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int slot = 2 * grp + ((d & 1) ^ k);
    if (slot < np) gfin[(pair0 + slot) * BAND + d] = c[k].g;
  }
  // traceback words of the block's pairs: one contiguous span
  const int4* src = reinterpret_cast<const int4*>(s_tb);
  int4* dst = reinterpret_cast<int4*>(tb + pair0 * groups * BAND);
  const int n4 = np * groups * BAND / 4;
  for (int k = lane; k < n4; k += THREADS) dst[k] = src[k];
}

}  // namespace

// query uint8 [N, L], window uint8 [N, L + 15]; gfin f32 [N, 16];
// tb int32 [N, ceil(L / 5), 16].  All device pointers, row-major and
// contiguous, tb 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for L > banded_sw_max_len()).
extern "C" int banded_sw_launch(const void* query, const void* window, int n,
                                int l, float match_s, float mismatch_s,
                                float open_s, float extend_s, void* gfin,
                                void* tb, void* stream) {
  if (n <= 0 || l <= 0) return 0;
  if (l > MAX_L) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stage_bytes(l);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        banded_sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const unsigned blocks = static_cast<unsigned>((n + PAIRS - 1) / PAIRS);
  banded_sw_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(window),
      n, l, Scores{match_s, mismatch_s, open_s, extend_s},
      static_cast<float*>(gfin), static_cast<int32_t*>(tb));
  return static_cast<int>(cudaGetLastError());
}

// The longest query the kernel takes.
extern "C" int banded_sw_max_len() { return MAX_L; }
