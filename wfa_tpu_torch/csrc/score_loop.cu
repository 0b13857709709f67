// Kernel K1: the WFA score loop, one thread block per pair.
//
// Replaces the TPU kernel wfa_tpu/pallas_engine.py::_kernel (95-956) as
// launched by pallas_run_batch (959-1159), in its default global mode
// (GLOBAL = true) and in semi-global mode (GLOBAL = false, 726-759 and
// 944-952).  For each pair it runs the reference's loop extend ->
// termination -> wf-adaptive reduce -> next (wfa.go:228-251) and bakes
// the backtrace aux (offset0 << 3 | tag per cell) as it goes.  Outputs per
// pair: final_s, done, overflow, term_cell (the raw M cell at
// (final_s, Ak)), the backtrace start (end_s, end_k, end_cell), and the
// aux rows 0..final_s of aux[3, S, B, K] in the lockstep engine's
// pair-major layout.  Rows above final_s are not written.
//
// Design for the card, not block by block from the Pallas code:
//  * One block of 128 threads per pair.  With no shared table window
//    every pair's result is independent of the rest of the batch, so a
//    per-pair loop is exact (the lockstep engine stops a pair at done or
//    overflow too).
//  * Extension compares the sequence bytes directly, eight at a time (two
//    aligned 8-byte loads a side, a funnel shift, XOR and the first set
//    bit), bounded by qlen and tlen like the reference's LCP walk
//    (wfa.go:411-435).  The TPU's stop tables exist because gathers are
//    slow there; the plain version keeps them, so the two check each
//    other.
//  * The workspace (the circular windows: WM = max(x, o+e) + 1 rows of M,
//    WE = e + 1 rows each of I and D; the staged aux rows; the ballot
//    words) lives in shared memory when it fits in 48 KB with the band
//    slots, else in a device scratch (kernel_engine.workspace picks by
//    shape; the body reads both through one generic pointer).
//  * A score step has four block barriers (the parent kernel had 12 for
//    K1, 14 for K1-long): extend with dmin and the Ak cell in one
//    reduction; the reduce's good / marked cells as warp ballots, one
//    barrier, then every warp finds first_good, last_good and the last
//    mark below first_good from the words; the zero pass with the flush's
//    value range in one reduction; next() with its written cells as
//    ballots, one barrier, then the new band bounds from the words.  Each
//    block reduction takes one barrier (every call site has its own
//    slots), and the band of score s rides in registers, which every
//    thread computes alike.
//  * Extend, classify and the zero pass stride only the live band; next()
//    the new band and the bands of the rows it overwrites (every other
//    cell of the window is zero), then zeroes the rest of the aux row.
//
// Semi-global mode (the window spans every diagonal, k0 = -(qlen-1)):
//  * Seeds: the first row and column, k in [-(qlen-1), tlen-1]; match
//    seeds in row 0, mismatch seeds in row x (merged when x == 0), aux =
//    the tag bits.  A mismatch seed beyond the score cap overflows the
//    pair, which with these seeds is almost every pair when x >= S.
//  * The end finder (wfa.go:270-375) is fused into the loop: on each
//    score row, post-extend and post-reduce (the terminating row
//    unreduced, before the loop breaks), the nearest stop cell on each
//    side of Ak decides; the first success over ascending s wins, its up
//    side first, and (final_s, Ak, term_cell) is the fallback.
//  * The pair runs to termination as the JAX kernel does, so final_s and
//    overflow equal its tensors.
//  * The JAX engines cancel a semi-global pair's termination when a
//    stop-table window outran an extension in the same step
//    (engine.py:868-874, pallas_engine.py:670).  K1 compares bytes and
//    has no table window, so nothing outruns and nothing is cancelled.
//  * A pair whose window misses a seed or terminal diagonal, or that has
//    a mismatch seed beyond the score cap, returns at once as overflow
//    with done = 0; the lockstep engines still extend such a pair's
//    stored seed rows while other pairs of their batch run (and may mark
//    it done), but its results are discarded either way.
//
// Long-read mode (REBASE = true, global only): the port of the TPU kernel
// wfa_tpu/pallas_longread.py::_kernel (168-845) as launched by its
// pallas_run_batch (848-1010).  Extend, terminate, reduce and next are the
// same code as above; only the aux store differs, so the two can never
// drift.  The aux is value-rebased int16: per (pair, score) row the
// minimum offset0 over the three planes' nonzero cells is the row's base,
// each found cell stores (offset0 - base + 1) << 3 | tag (a stored 0 stays
// "absent"), and the base goes to aux_base[b, s].  A row is final only
// after its own reduce (next() of step s writes row s+1, the reduce of step
// s+1 zeroes some of its cells), so the newest aux row of each plane is
// staged as int32 in the pair's workspace, zeroed where the reduce
// zeroes, and written rebased after that reduce, while next() fills the
// other of two staging rows a plane; the terminating row unreduced, at
// the break, as the TPU kernel streams it.
// A rebased value above 4095 does not fit the int16 cell: the pair is
// then reported overflowed (done = 0, final_s = term_cell = 0), so it
// retries or goes to the oracle, where the TPU kernel relies on
// wf-adaptive bounding a row's spread by about band + max_dist_diff.
// What the TPU kernel adds for its layout is not carried over: the 64- and
// 8-pair blocks, the stop tables with their per-8-pair-group VMEM windows
// and the "outrun" overflow (560-653), the CH-chunk DMA.  K1 compares
// sequence bytes, so nothing outruns: a pair the TPU kernel overflows for
// an outrun is served here at tier 0.
//
// K1-kw (global only; warp_loop_kernel, below, in the warp shape of one
// warp a pair): the port of the TPU kernel
// wfa_tpu/pallas_engine.py::_kernel with KW > 0 (cfg.aux_kw; setup
// 1061-1081, aux write 775-843), which the JAX pipeline takes for global
// reads whose longest lies in (4095 - k_win, 4096] (pipeline.py:216-223).
// It is K1-long's staging with a row window: the flush of row s also
// takes cb, the first column of the post-reduce M/I/D band union of score
// s (band slots mb at s % WM, ib and db at s % WE, each where it exists)
// // 32, clipped to [0, (K - kw) / 32]; writes only columns [cb * 32,
// cb * 32 + kw) into an aux row kw wide, values based at vb, the row's
// minimum offset0 (at least 0); and writes sbase[s, b] = vb << 5 | cb.  A
// row whose band top reaches cb * 32 + kw, or whose offsets spread past
// 4095, escapes: the pair is overflowed.  Unlike K1-long, an escape on the
// terminating row leaves done, final_s and term_cell as they are (out
// rows done = 1, overflow = 1), because the TPU kernel tests the escape in
// its aux write, after the termination test, and only sets overflow
// (pallas_engine.py:652-672, 817-819); the pair is not served either way.
// The rows it writes are kw / K of K1's and half their width, and its
// flush reads the staged cells of the band union only.
//
// Two-phase semi-global route (PHASE != kFull, semi-global only): the
// port of wfa_tpu/semi2.py's phase 1 and phase 2, with the same extend,
// terminate, reduce, next and end-finder code.
//  * K3, the prefix export (PHASE = kPrefix): replaces the TPU kernels
//    wfa_tpu/pallas_prefix.py::_kernel (92-904, via
//    pallas_run_prefix_chunked) and pallas_engine.py::_kernel in its
//    EXPORT+VSPACE mode (via pallas_run_prefix, 1259-1391, the penalties
//    the chunked kernel refuses); K3 runs at any penalties.  The pair
//    seeds over the full span Kf and runs scores 0 .. S0 - 1 with the
//    fused end finder; aux rows 0 .. S0 - 1 go to aux_old[3, S0, B, Kf]
//    (int16 cells when the buffer allows), the aux row S0 that next() of
//    step S0 - 1 writes is staged in the pair's workspace.  At exit the
//    kernel computes meta1 (done, final_s, term_cell, the end finder's
//    raw state, overflow2, k02: wfa_tpu/semi2.py:48-52, 182-206) from the
//    band union of every slot next() can still read plus Ak, and writes
//    the window rows, ainit and the band slots ALREADY REBASED to the
//    narrow window of origin k02 and width K2, in JAX's slot order (slot r
//    holds the score in (S0 - W, S0] congruent to r mod W, which is where
//    the circular windows keep it), so no gather pass follows.
//  * K3's launch shape, which kernel_engine.prefix_plan picks by shape
//    (PERF.md §6): its window and staged cells are its aux cells,
//    int16 where every offset fits them (a pair's workspace at Kf 2048 is
//    74 KB), in shared memory where two blocks fit an SM (opting in past
//    48 KB), else in the scratch; NT threads a block, 256 to 1024 (256
//    where pairs share an SM, more where a pair or fewer has one, so that
//    more loads are in flight), or a thread-block cluster of CL = 2
//    1024-thread blocks a pair over the scratch where every pair's blocks
//    fit the card at once (64 pairs of Kf 20,096 on 128 SMs): every pass
//    strides the pair's CL x NT threads, a block reduction writes each
//    warp's partial to every block's slots through distributed shared
//    memory, and every barrier is the cluster's.  Its end finder reads
//    only the band (every semi-global mode's does), and it zeroes its
//    workspace and the aux rows' tails outside next()'s columns with
//    16-byte stores.
//  * K4, the resume (warp_loop_kernel, below, with KW false; its workspace
//    layout is PHASE = kResume's): replaces pallas_engine.py::_kernel
//    with RESUME = S0 (via pallas_run_resume, 1394-1578).  No seeding: the
//    windows, band slots and aux row S0 come from those exports, done,
//    final_s, term_cell and the end finder's state from meta1, and the
//    pair runs scores S0 .. S - 1 in the narrow window (origin k02 =
//    -toff2; toff2 < 0 means the target row holds the target's suffix
//    from k02 on, and every read stays at h >= k > k02).  Aux rows S0 ..
//    go to aux2[3, S - S0, B, K].  Pairs done or escaped at S0 (meta1, or
//    Ak outside the window) do not run.  The TPU kernel's streamed table
//    window can overflow a pair or cancel a termination on an outrun; K4
//    compares bytes and has no such window.
// What neither carries over: the REORDER pass order, the KC chunks and
// guard rows, the v-space shear, 128-lane padding.
//
// What bounds it: each step is a chain of short phases joined by block
// barriers, per pair.  At l=1000 (K = 128, 2048 pairs) several blocks
// share an SM, and the instructions a step issues set the pace; the
// many-pair instantiations cap registers at 64 so that 8 blocks fit.  At
// l=50000 (K = 384, 64 pairs, ~14,500 steps a pair) one block runs an SM
// and the latency of each phase's chain sets it; the aux rows, 6 B x
// 14,500 x 384 x 64 pairs ~ 2.1 GB, take ~0.64 ms at 3.35 TB/s, so memory
// is far from the limit, and a 64-pair batch fills 64 of the 132 SMs.
// Semi-global windows are the full span (K = 2048 at l = 1000), where the
// whole-window aux rows dominate; K4 strides the narrow window.  K3 runs
// S0 = 64 steps of which the first ~16-30 pass over the whole span (Kf =
// 20,096 at l = 10000, 64 pairs) and the rest over a band of 3-40
// diagonals: the wide steps' chains of scratch loads set its pace, which
// wider blocks and clusters hide, and a batch of 64 pairs fills 64 of the
// 132 SMs in single blocks.

#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// the warp shape (K1-kw and K4, warp_loop_kernel): one warp a pair, up to
// kWarpPairs pairs a block, whose width the launch picks
// (kernel_engine.warp_plan); the registers are capped for kWarpPairs warps
// an SM (128 a thread), which hold 2,112 pairs on 132 SMs
constexpr int kWarpPairs = 16;
constexpr int kWarpBlock = 32 * kWarpPairs;
constexpr int kInsOpen = 1, kInsExt = 2, kDelOpen = 3, kDelExt = 4;
constexpr int kMismatch = 5, kMatch = 6;
constexpr int kMaxRebased = 4095;  // (v << 3) | tag must fit int16
// score-loop phases: the whole run, or phase 1 / phase 2 of the two-phase
// semi-global route
constexpr int kFull = 0, kPrefix = 1, kResume = 2;
// TIMED instantiations: per-pair clock64() sums of the pair's first
// thread, by phase (the end finder, the aux rows' zero tail, the set-up
// before the first step and the prefix's exports after the last have their
// own), then the columns extend strode summed over the steps, then the
// steps
constexpr int kPhExtend = 0, kPhTerm = 1, kPhReduce = 2, kPhFlush = 3,
              kPhNext = 4, kPhBands = 5, kPhEnd = 6, kPhTail = 7,
              kPhSetup = 8, kPhExport = 9, kPhWidth = 10, kPhSteps = 11,
              kPhases = 12;
// meta1 columns (wfa_tpu/semi2.py:48-52)
constexpr int kM1Done = 0, kM1Fs = 1, kM1Term = 2, kM1EFound = 3, kM1Es = 4,
              kM1Ek = 5, kM1ECell = 6, kM1Ovf = 7, kM1K02 = 8, kM1Cols = 9;

// The phase-1 exports in the JAX layouts: win_m[WM, B, K2],
// win_i/win_d[WE, B, K2], ainit[3, B, K2], b_m[3 WM, B] (lo, hi, ex rows),
// b_ie[6 WE, B] (I lo, hi, ex, then D), meta1[B, 9].  K3 writes them, K4
// reads them; null in the other phases.
struct Handoff {
  int32_t* win_m;
  int32_t* win_i;
  int32_t* win_d;
  int32_t* ainit;
  int32_t* b_m;
  int32_t* b_ie;
  int32_t* meta1;
  int S0;  // the score phase 2 resumes at
  int K2;  // the narrow window's width
};

// Every thread of a pair's blocks waits for all: the block's barrier, or
// with CL blocks a pair (a thread-block cluster) the cluster's, whose
// arrive releases and whose wait acquires every write before it, to
// global and shared memory alike.
template <int CL>
__device__ __forceinline__ void pair_barrier() {
  if constexpr (CL > 1) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Minimum of N values at once over a pair's W warps (its one block, or
// the CL blocks of its cluster), with one barrier (a maximum passes its
// negation; all values lie in [-kBig, kBig]).  Every thread gets the
// results.  `red` holds N * W slots in each block; a warp's lane 0 writes
// its slots in every block of the cluster.  Each call site has its own
// slots, and every path between two calls of one site crosses another
// barrier, so no thread still reads the slots a call writes.
template <int W, int CL, int N>
__device__ __forceinline__ void block_min(int (&v)[N], int* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __reduce_min_sync(0xffffffffu, v[i]);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    if constexpr (CL > 1) {
      auto cluster = cooperative_groups::this_cluster();
      const int warp = static_cast<int>(cluster.block_rank()) *
                           (W / CL) + (threadIdx.x >> 5);
      for (int r = 0; r < CL; ++r) {
        int* dst = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int i = 0; i < N; ++i) dst[i * W + warp] = v[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) red[i * W + (threadIdx.x >> 5)] = v[i];
    }
  }
  pair_barrier<CL>();
  if constexpr (W <= kWarps) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int m = red[i * W];
#pragma unroll
      for (int w = 1; w < W; ++w) m = min(m, red[i * W + w]);
      v[i] = m;
    }
  } else {  // lane w reads the slots of warps w, w + 32, .., and the warp
            // reduces them
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int m = kBig;
#pragma unroll
      for (int w = lane; w < W; w += 32) m = min(m, red[i * W + w]);
      v[i] = __reduce_min_sync(0xffffffffu, m);
    }
  }
}

// Zero the cells [a, b) of a row with 16-byte stores, the few cells before
// the first 16-byte boundary and after the last one singly; the T threads
// of a pair share the work, this one being thread `tid`.
template <int T, typename C>
__device__ __forceinline__ void zero_cells(C* row, int a, int b, int tid) {
  static_assert(16 % sizeof(C) == 0 && 16 / sizeof(C) <= T, "cell size");
  if (a >= b) return;
  constexpr int V = 16 / sizeof(C);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row + a) & 15);
  const int head = min(b - a, ((16 - mis) & 15) / static_cast<int>(sizeof(C)));
  if (tid < head) row[a + tid] = 0;
  const int a16 = a + head, n16 = (b - a16) / V;
  int4* p = reinterpret_cast<int4*>(row + a16);
  for (int i = tid; i < n16; i += T) p[i] = make_int4(0, 0, 0, 0);
  const int t = a16 + n16 * V;
  if (tid < b - t) row[t + tid] = 0;
}

// The lowest and highest set bit, as column indices, of the ballot words
// w0..w1 of each of the three masks m[c] (kBig and -kBig where none is
// set).  The warp reads 32 words at once and finds the first and last
// nonzero one with a ballot; every warp computes the same.
__device__ __forceinline__ void mask_bounds3(const uint32_t* const (&m)[3],
                                             int w0, int w1, int (&lo)[3],
                                             int (&hi)[3]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 3; ++c) lo[c] = kBig, hi[c] = -kBig;
  for (int base = w0; base <= w1; base += 32) {
    const int w = base + lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t bits = w <= w1 ? m[c][w] : 0u;
      const uint32_t nz = __ballot_sync(0xffffffffu, bits != 0);
      if (nz) {
        const int fl = __ffs(nz) - 1, ll = 31 - __clz(nz);
        const uint32_t fb = __shfl_sync(0xffffffffu, bits, fl);
        const uint32_t lb = __shfl_sync(0xffffffffu, bits, ll);
        if (lo[c] == kBig) lo[c] = (base + fl) * 32 + __ffs(fb) - 1;
        hi[c] = (base + ll) * 32 + 31 - __clz(lb);
      }
    }
  }
}

// The bytes p[0 .. need) (need <= 8) in the low bytes of a word, from the
// one or two aligned 8-byte words that hold them: the second is loaded only
// when a needed byte lies in it, so no load leaves the row.  The bytes above
// `need` are unspecified.
__device__ __forceinline__ uint64_t load_bytes(const uint8_t* p, int need) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(a & ~uintptr_t(7));
  const int off = static_cast<int>(a & 7);
  const uint64_t lo = __ldg(w);
  if (off == 0) return lo;
  const uint64_t hi = off + need > 8 ? __ldg(w + 1) : 0;
  return (lo >> (8 * off)) | (hi << (64 - 8 * off));
}

// The length of the common prefix of a[0 .. lim) and b[0 .. lim), eight
// bytes a compare (the reference's LCP walk, wfa.go:411-435).
__device__ __forceinline__ int lcp(const uint8_t* a, const uint8_t* b,
                                   int lim) {
  int n = 0;
  while (n < lim) {
    const int r = min(lim - n, 8);
    const uint64_t d = load_bytes(a + n, r) ^ load_bytes(b + n, r);
    if (d) return n + min((__ffsll(static_cast<long long>(d)) - 1) >> 3, r);
    n += r;
  }
  return n;
}

// The reference's ascending Delete loop over k in [dl, dh] applied to a
// band [lo, hi] (wfa_wavefront.go:171-183 via wfa.go:526-535): the new
// band and the zeroed range [zlo, zhi] (empty when zlo > zhi).
__device__ __forceinline__ void delete_range_asc(int dl, int dh, int lo,
                                                 int hi, int& nlo, int& nhi,
                                                 int& zlo, int& zhi) {
  bool nonempty = dl <= dh && lo <= dh && hi >= dl;
  bool hi_in = hi <= dh;
  nlo = (nonempty && lo >= dl) ? (hi_in ? hi : dh + 1) : lo;
  nhi = nonempty ? (hi_in ? hi - 1 : hi) : hi;
  zlo = nonempty ? max(dl, lo) : 1;
  zhi = nonempty ? min(dh, hi) : 0;
}

struct Band {
  int* lo;
  int* hi;
  int* ex;
};

// Source read of next() (KRange + GetAfterDiff, wfa_component.go:91-167):
// the offset at window column jj of the row `row`, or 0 when absent.
template <typename W>
__device__ __forceinline__ bool src(const W* row, bool present, int lo,
                                    int hi, int k0, int K, int jj, int& val) {
  val = 0;
  if (!present || jj < 0 || jj >= K) return false;
  int kk = k0 + jj;
  int c = row[jj];
  if (kk < lo || kk > hi || c <= 0) return false;
  val = c >> 3;
  return true;
}

// int32 cells of a pair's workspace: WM rows of M and WE rows each of I
// and D, K diagonals wide, then `stage_rows` staged aux rows, then three
// ballot words for every 32 columns.  In shared memory when the launch
// passes no scratch, else in the scratch, one workspace a pair
// (kernel_engine.workspace picks the place and counts the same ints).
// The window and staged cells are int32 (win_bytes 4), or K3's int16 cells
// (2), whose rows then fill whole 16-byte words before the ballot words.
__host__ __device__ __forceinline__ int64_t window_ints(int K, int rows,
                                                        int win_bytes) {
  const int64_t cells = (int64_t)rows * K;
  return win_bytes == 4 ? cells : (cells * win_bytes + 15) / 16 * 4;
}
__host__ __device__ __forceinline__ int64_t workspace_ints(
    int K, int WM, int WE, int stage_rows, int win_bytes = 4) {
  // a multiple of 4, so that rows of a K % 4 == 0 window start 16-byte
  // aligned in every pair's scratch
  return (window_ints(K, WM + 2 * WE + stage_rows, win_bytes) +
          3 * ((K + 31) / 32) + 3) & ~int64_t(3);
}

// shared ints ahead of a workspace in shared memory: the block_min sites'
// slots (eight for each warp of a pair, which each of its blocks holds),
// then the band slots, rounded up to a multiple of 4
constexpr int kMaxWarps = 64;  // a cluster of two 1024-thread blocks
__host__ __device__ constexpr int red_ints(int warps) { return 8 * warps; }
__host__ __device__ constexpr int slot_ints(int warps, int WM, int WE) {
  return (red_ints(warps) + 3 * WM + 6 * WE + 3) & ~3;
}
// staged aux rows in a pair's workspace: REBASE's two newest rows of each
// plane (row s is flushed while next() writes row s + 1), or the prefix's
// aux row S0 (ainit)
template <bool REBASE, int PHASE>
__host__ __device__ constexpr int stage_rows() {
  return REBASE ? 6 : (PHASE == kPrefix ? 3 : 0);
}
// the dynamic shared memory a launch gets without a function attribute;
// K3 opts in to what a Hopper block may have (232,448 bytes)
constexpr int64_t kSharedBytes = 48 * 1024;
constexpr int64_t kSharedOptIn = 227 * 1024;
template <int PHASE>
constexpr int64_t shared_limit() {
  return PHASE == kPrefix ? kSharedOptIn : kSharedBytes;
}
// ints of a launch's dynamic shared memory at `warps` warps a pair: the
// slots, and the workspace when it is in shared memory (no scratch)
inline int64_t shared_ints(int warps, int K, int WM, int WE, int stage,
                           bool scratch, int win_bytes = 4) {
  return scratch ? red_ints(warps) + 3 * WM + 6 * WE
                 : slot_ints(warps, WM, WE) +
                       workspace_ints(K, WM, WE, stage, win_bytes);
}
// the warps whose slots decide whether K3's workspace fits shared memory
// (wfa_workspace, kernel_engine.PREFIX_SHARED_WARPS): a 512-thread
// block's, the widest that holds its workspace there
constexpr int kPrefixSharedWarps = 16;
// blocks an SM the compiler keeps registers for, in the modes whose
// launches bring thousands of pairs and whose steps the issued
// instructions pace: K1 and K1-kw 8 (64 registers a thread; the fastest
// of 1, 6, 8 and of 1, 4, 6, 8), the semi-global modes 6 (of 1, 3, 4, 6),
// timed in turns on the paths' batches (PERF.md §6); K1-long's one
// block an SM takes what it needs
// K3 of a wider block keeps the semi-global modes' registers a thread (as
// many threads an SM: 3 blocks of 256), and 1 block of 512 or 1024 (a
// block of 512 takes up to 128 registers a thread, one of 1024 64)
constexpr int kMinBlocks = 8, kMinBlocksSemi = 6;
template <bool GLOBAL, bool REBASE, int NT>
constexpr int min_blocks() {
  return GLOBAL ? (!REBASE ? kMinBlocks : 1)
                : (kMinBlocksSemi * kThreads / NT > 0
                       ? kMinBlocksSemi * kThreads / NT : 1);
}

// Where the flush writes a row: the value base, and whether the row fits
// the int16 cells
struct FlushPlan {
  int base;
  bool fits;
};

// Cell: int32 aux cells, the value-rebased int16 cells of REBASE mode, or
// the int16 cells of K3 where its offsets fit them.
// NT: threads a block, CL: blocks a pair, a thread-block cluster that
// splits each pass over the columns, its workspace in the device scratch
// (K3 only; every other mode runs one block of kThreads).  K1-kw and K4
// run in warp_loop_kernel.
template <bool GLOBAL, bool REBASE, int PHASE, typename Cell,
          bool TIMED = false, int NT = kThreads, int CL = 1>
__global__ void __launch_bounds__(NT, (min_blocks<GLOBAL, REBASE, NT>()))
    score_loop_kernel(
    const uint8_t* __restrict__ qb, const uint8_t* __restrict__ tbuf,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ toff, int B, int Lq, int Ltb, int S, int K,
    int x, int oe, int e, int reduce_on, int min_wf_len, int max_dist_diff,
    int32_t* __restrict__ win, int32_t* __restrict__ out,
    Cell* __restrict__ aux, int32_t* __restrict__ aux_base, Handoff ho,
    long long* __restrict__ cycles) {
  static_assert(GLOBAL || !REBASE, "the long-read mode is global only");
  static_assert(PHASE != kResume, "K4 runs in warp_loop_kernel");
  static_assert(PHASE == kFull || (!GLOBAL && !REBASE),
                "the two-phase route is semi-global");
  static_assert(NT == kThreads || PHASE == kPrefix,
                "only K3 runs another block width");
  static_assert(CL == 1 || PHASE == kPrefix, "only K3 runs in clusters");
  constexpr int PT = NT * CL;  // threads a pair
  static_assert(NT % 32 == 0 && PT / 32 <= kMaxWarps, "block width");
  constexpr int kW = PT / 32;  // warps a pair
  constexpr int kStageRows = stage_rows<REBASE, PHASE>();
  using Dst = std::conditional_t<REBASE, int32_t, Cell>;
  // window cells: K3's are its aux cells (int16 where every offset fits
  // them, which halves its workspace), every other mode's int32; staged
  // cells: REBASE's int32 rows, K3's aux row S0 in its aux cells
  using Win = std::conditional_t<PHASE == kPrefix, Cell, int32_t>;
  using St = std::conditional_t<REBASE, int32_t, Cell>;
  constexpr int kWinBytes = sizeof(Win);
  const int S0 = PHASE == kFull ? 0 : ho.S0;
  // aux rows held: S rows, the prefix's S0
  const int Sa = PHASE == kFull ? S : S0;
  // the pair, and this thread's index over all its blocks' threads; each
  // block keeps its own band slots, which its first thread writes
  const int b = blockIdx.x / CL;
  const int rank = CL > 1 ? blockIdx.x % CL : 0;
  const int tid = rank * NT + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool lead = threadIdx.x == 0;
  auto sync_pair = [] { pair_barrier<CL>(); };
  const int WM = max(x, oe) + 1, WE = e + 1;
  const int KWd = (K + 31) / 32;  // ballot words a row
  extern __shared__ int smem[];
  // one block_min site each: extend, the flush (and the seeding), the end
  // finder
  int* red_ext = smem;
  int* red_fl = smem + 2 * kW;
  int* red_fe = smem + 6 * kW;
  int* slots = smem + red_ints(kW);
  Band mb{slots, slots + WM, slots + 2 * WM};
  int* base_ie = slots + 3 * WM;
  Band ib{base_ie, base_ie + WE, base_ie + 2 * WE};
  Band db{base_ie + 3 * WE, base_ie + 4 * WE, base_ie + 5 * WE};

  // TIMED: thread 0 adds the cycles since the last stamp to a phase
  long long t_mark = 0, acc[kPhases] = {};
  auto stamp = [&](int ph) {
    if constexpr (TIMED) {
      if (tid == 0) {
        const long long now = clock64();
        acc[ph] += now - t_mark;
        t_mark = now;
      }
    }
  };
  if constexpr (TIMED) t_mark = clock64();

  const int ql = qlen[b], tl = tlen[b], tof = toff[b];
  const int k0 = -tof, Ak = tl - ql, jak = Ak - k0;
  // the workspace: the windows, the staged rows, the ballot words
  int32_t* ws =
      win ? win + b * workspace_ints(K, WM, WE, kStageRows, kWinBytes)
          : smem + slot_ints(kW, WM, WE);
  Win* Mw = reinterpret_cast<Win*>(ws);
  Win* Iw = Mw + (int64_t)WM * K;
  Win* Dw = Iw + (int64_t)WE * K;
  St* stage = reinterpret_cast<St*>(Dw + (int64_t)WE * K);
  // (the same address both ways for int32 cells; computed from `ws` it
  // cost K1-long and K3's 1024-thread blocks registers, PERF.md §6)
  uint32_t* mk;
  if constexpr (kWinBytes == 4) {
    mk = reinterpret_cast<uint32_t*>(stage + (int64_t)kStageRows * K);
  } else {  // past the int16 rows' last whole 16-byte word
    mk = reinterpret_cast<uint32_t*>(
        ws + window_ints(K, WM + 2 * WE + kStageRows, kWinBytes));
  }
  auto aux_row = [&](int comp, int s) {
    return aux + ((int64_t)(comp * Sa + s) * B + b) * K;
  };
  // where seeding, reduce and next put a row's aux: the output row, in
  // REBASE mode the int32 staging rows of the row's parity, and for the
  // prefix's row S0 the staging rows, holding Cell values
  auto aux_dst = [&](int comp, int s) -> Dst* {
    if constexpr (REBASE) {
      return stage + (int64_t)((s & 1) * 3 + comp) * K;
    } else {
      if (PHASE == kPrefix && s == S0) return stage + (int64_t)comp * K;
      return aux_row(comp, s);
    }
  };
  // REBASE: the flush of row s from its staged cells' minimum r[0] and
  // negated maximum r[1] offset0
  auto plan_flush = [&](const int (&r)[2]) {
    FlushPlan p{r[0] < kBig ? r[0] : 0, true};
    p.fits = r[0] == kBig || -r[1] - p.base + 1 <= kMaxRebased;
    return p;
  };
  // REBASE: column j of the staged row s, rebased, to the aux rows, and the
  // row's base word.  The staged cell is left zero, so the parity is all
  // zero again
  auto flush_col = [&](int s, const FlushPlan& p, int j) {
    St* st = stage + (int64_t)(s & 1) * 3 * K + j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int cell = st[c * K];
      st[c * K] = 0;
      aux_row(c, s)[j] = static_cast<Cell>(
          cell > 0 ? (((cell >> 3) - p.base + 1) << 3) | (cell & 7) : 0);
    }
    if (j == 0) aux_base[(int64_t)b * S + s] = p.base;
  };
  // the same for columns j .. j + 3, one 16-byte load and store of each
  // staged plane and one 8-byte store of each aux row, when K is a
  // multiple of 4 (the workspace rows and aux rows are then aligned)
  const bool vec4 = K % 4 == 0;
  auto flush_col4 = [&](int s, const FlushPlan& p, int j) {
    St* st = stage + (int64_t)(s & 1) * 3 * K + j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      int4* src4 = reinterpret_cast<int4*>(st + c * K);
      const int4 v = *src4;
      *src4 = make_int4(0, 0, 0, 0);
      auto rb = [&](int cell) -> uint32_t {
        return static_cast<uint16_t>(
            cell > 0 ? (((cell >> 3) - p.base + 1) << 3) | (cell & 7) : 0);
      };
      *reinterpret_cast<uint2*>(aux_row(c, s) + j) =
          make_uint2(rb(v.x) | rb(v.y) << 16, rb(v.z) | rb(v.w) << 16);
    }
    if (j == 0) aux_base[(int64_t)b * S + s] = p.base;
  };
  // the whole flush of row s
  auto flush_row = [&](int s, const FlushPlan& p) {
    if (vec4) {
      for (int j = 4 * tid; j < K; j += 4 * PT) flush_col4(s, p, j);
    } else {
      for (int j = tid; j < K; j += PT) flush_col(s, p, j);
    }
  };

  // the window must hold the seed diagonals and the terminal one
  bool overflow = Ak < k0 || Ak >= k0 + K || 0 < k0 || 0 >= k0 + K;
  if (!GLOBAL) overflow = overflow || tl - 1 >= k0 + K;
  const uint8_t* q = qb + (int64_t)b * Lq;
  const uint8_t* t = tbuf + (int64_t)b * Ltb + tof;  // t[h], valid if !overflow
  bool done = false;
  int final_s = 0, term_cell = 0;
  // semi-global end finder: the first success over ascending s
  bool end_found = false;
  int end_s = 0, end_k = 0, end_cell = 0;
  // the prefix's per-pair summary (wfa_tpu/semi2.py:235-238)
  auto write_meta1 = [&](int k02, bool ovf2) {
    if (PHASE == kPrefix && tid == 0) {
      int32_t* m = ho.meta1 + (int64_t)b * kM1Cols;
      m[kM1Done] = done;
      m[kM1Fs] = final_s;
      m[kM1Term] = term_cell;
      m[kM1EFound] = end_found;
      m[kM1Es] = end_s;
      m[kM1Ek] = end_k;
      m[kM1ECell] = end_cell;
      m[kM1Ovf] = ovf2;
      m[kM1K02] = k02;
    }
  };
  auto write_out = [&]() {
    if (PHASE != kPrefix && tid == 0) {
      const bool use_end = !GLOBAL && done && !overflow && end_found;
      out[b] = final_s;
      out[B + b] = done;
      out[2 * B + b] = overflow || !done;
      out[3 * B + b] = term_cell;
      out[4 * B + b] = use_end ? end_s : final_s;
      out[5 * B + b] = use_end ? end_k : Ak;
      out[6 * B + b] = use_end ? end_cell : term_cell;
    }
  };
  bool eq00 = false;
  if (GLOBAL && !overflow) {
    eq00 = q[0] == t[0];
    // a mismatch seed beyond the score cap can never be reached
    if (!eq00 && x >= S && x > 0) overflow = true;
  }
  if (overflow) {
    write_out();
    write_meta1(-(ql - 1), true);
    return;
  }

  // ---- the workspace, zeroed, and the seeds
  if constexpr (PHASE == kPrefix) {
    // the windows and the staged row S0 lie end to end
    zero_cells<PT>(Mw, 0, (WM + 2 * WE + kStageRows) * K, tid);
  } else {
    for (int i = tid; i < WM * K; i += PT) Mw[i] = 0;
    for (int i = tid; i < WE * K; i += PT) Iw[i] = Dw[i] = 0;
    for (int i = tid; i < kStageRows * K; i += PT) stage[i] = 0;
  }
  sync_pair();
  if constexpr (GLOBAL) {
    // ---- seeding (wfa.go:143-184): one cell, diagonal 0 at offset 1
    const int j0 = -k0;
    const int cell0 = (1 << 3) | (eq00 ? kMatch : kMismatch);
    const int seed_row = (eq00 || x == 0) ? 0 : x;
    if (lead) {
      Mw[seed_row * K + j0] = cell0;
      for (int r = 0; r < WM; ++r) {
        mb.lo[r] = r == seed_row ? 0 : kBig;
        mb.hi[r] = r == seed_row ? 0 : -kBig;
        mb.ex[r] = r == seed_row;
      }
    }
    // aux row 0: seed cells have no sources, so their aux is the tag bits
    for (int j = tid; j < K; j += PT) {
      aux_dst(0, 0)[j] = (seed_row == 0 && j == j0) ? (cell0 & 7) : 0;
      aux_dst(1, 0)[j] = 0;
      aux_dst(2, 0)[j] = 0;
    }
  } else {
    // ---- semi-global seeding (wfa.go:163-183): k in [-(qlen-1), tlen-1],
    // k >= 0 at offset k+1 from q[0] == t[k], k < 0 at offset 1 from
    // q[-k] == t[0]; match seeds in row 0, mismatch seeds in row x
    int rs[4] = {kBig, kBig, kBig, kBig};  // min k, -max k of rows 0, x
    for (int j = tid; j < K; j += PT) {
      const int k = k0 + j;
      int aux0 = 0;
      if (k <= tl - 1 && k >= -(ql - 1)) {
        const bool eq = k >= 0 ? q[0] == t[k] : q[-k] == t[0];
        const int seed =
            ((k >= 0 ? k + 1 : 1) << 3) | (eq ? kMatch : kMismatch);
        const int r = (eq || x == 0) ? 0 : 1;
        rs[2 * r] = min(rs[2 * r], k);
        rs[2 * r + 1] = min(rs[2 * r + 1], -k);
        Mw[(r ? x : 0) * K + j] = seed;  // x < WM
        if (r == 0) aux0 = seed & 7;
      }
      aux_dst(0, 0)[j] = aux0;
      aux_dst(1, 0)[j] = 0;
      aux_dst(2, 0)[j] = 0;
    }
    block_min<kW, CL>(rs, red_fl);
    // a mismatch seed beyond the score cap can never be reached
    if (x >= S && rs[2] < kBig) {
      overflow = true;
      write_out();
      write_meta1(-(ql - 1), true);
      return;
    }
    if (lead) {
      for (int r = 0; r < WM; ++r) {
        const int i = r == 0 ? 0 : (r == x ? 2 : -1);
        const bool ex = i >= 0 && rs[i] < kBig;
        mb.lo[r] = ex ? rs[i] : kBig;
        mb.hi[r] = ex ? -rs[i + 1] : -kBig;
        mb.ex[r] = ex;
      }
    }
  }
  if (lead) {
    for (int r = 0; r < WE; ++r) {
      ib.lo[r] = db.lo[r] = kBig;
      ib.hi[r] = db.hi[r] = -kBig;
      ib.ex[r] = db.ex[r] = 0;
    }
  }
  sync_pair();

  // the nearest stop cell on each side of Ak in an M row (wfa.go:270-375):
  // the largest 2j + succ at k <= Ak and the smallest 2j + !succ above it.
  // Only the row's band [lo, hi] can hold a cell (every other cell of a
  // window row is zero), so only its columns are read; an empty band finds
  // nothing, and every thread skips alike
  auto find_end = [&](int s, const Win* row, int lo, int hi) {
    const int j0 = max(lo - k0, 0), j1 = min(hi - k0, K - 1);
    if (j0 > j1) return;
    int r2[2] = {kBig, kBig};  // -(2 j_dn + succ_dn), 2 j_up + !succ_up
    for (int j = j0 + tid; j <= j1; j += PT) {
      const int cell = row[j];
      if (cell <= 0) continue;
      const int k = k0 + j, h = cell >> 3, v = h - k;
      const bool viol = v <= 0 || v > ql || h > tl;
      const bool elig = (v == ql && h >= ql) || (h == tl && v >= tl);
      if (!viol && !elig) continue;
      if (k <= Ak) r2[0] = min(r2[0], -(2 * j + !viol));
      else r2[1] = min(r2[1], 2 * j + viol);
    }
    block_min<kW, CL>(r2, red_fe);
    const bool succ_dn = r2[0] < kBig && ((-r2[0]) & 1);
    const bool succ_up = r2[1] < kBig && !(r2[1] & 1);
    if (succ_up || succ_dn) {
      const int j = succ_up ? r2[1] >> 1 : (-r2[0]) >> 1;
      end_found = true;
      end_s = s;
      end_k = k0 + j;
      end_cell = row[j];
    }
  };

  stamp(kPhSetup);

  // The bands of score s (M at s % WM, I and D at s % WE) ride in
  // registers from the next() that found them: every thread reads the same
  // ballot words, so all hold the same values.  Thread 0 keeps the shared
  // slots up to date for the older rows next() reads.
  bool bex[3];  // M, I, D exist
  int blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
    bex[c] = bc.ex[0] != 0;
    blo[c] = bc.lo[0];
    bhi[c] = bc.hi[0];
  }

  // A step: extend with dmin and the Ak cell (one barrier); termination;
  // the reduce's classify ballots (one barrier); the zero pass with the
  // flush's value range (one barrier); next() and the flush of row s, then
  // the new bands' ballots (one barrier).  sm and se are the ring slots of
  // score s, s % WM and s % WE.
  int sm = 0, se = 0;
  for (int s = 0; s < S - 1; ++s) {
    if constexpr (TIMED) ++acc[kPhSteps];
    const int lo_ms = blo[0], hi_ms = bhi[0];
    const bool ex_ms = bex[0];
    Win* row_m = Mw + (int64_t)sm * K;
    // the band's columns (the window holds every band)
    const int jlo = max(lo_ms - k0, 0), jhi = min(hi_ms - k0, K - 1);

    // ---------------- extend (wfa.go:381-458) ----------------
    // with dmin over the extended in-bounds cells and the Ak cell
    int r1[2] = {kBig, kBig};  // dmin, -cell at Ak
    if (ex_ms) {
      for (int j = jlo + tid; j <= jhi; j += PT) {
        int cell = row_m[j];
        const int k = k0 + j;
        if (cell > 0) {
          const int h0 = cell >> 3, v0 = h0 - k;
          if (v0 > 0 && v0 < ql && h0 < tl) {
            const int n = lcp(q + v0, t + h0, min(ql - v0, tl - h0));
            if (n > 0) {
              cell += n << 3;
              row_m[j] = cell;
            }
          }
          const int hs = cell >> 3, vs = hs - k;
          if (vs >= 0 && vs < ql && hs < tl)
            r1[0] = min(r1[0], max(tl - hs, ql - vs));
        }
        if (j == jak) r1[1] = -cell;
      }
      if constexpr (TIMED) {
        if (tid == 0) acc[kPhWidth] += jhi - jlo + 1;
      }
    }
    block_min<kW, CL>(r1, red_ext);
    stamp(kPhExtend);

    // ---------------- termination (wfa.go:235-239) ----------------
    const int cell_ak = r1[1] < kBig ? -r1[1] : 0;
    if (ex_ms && Ak >= lo_ms && Ak <= hi_ms && cell_ak > 0 &&
        (cell_ak >> 3) >= tl) {
      stamp(kPhTerm);
      done = true;
      final_s = s;
      term_cell = cell_ak;
      // the terminating row is searched unreduced
      if (!GLOBAL && !end_found) find_end(s, row_m, lo_ms, hi_ms);
      stamp(kPhEnd);
      // and streamed unreduced.  A row that does not fit overflows the
      // pair, which K1-long reports not done
      if constexpr (REBASE) {
        int rf[2] = {kBig, kBig};  // min offset0, -max offset0
        const St* st = stage + (int64_t)(s & 1) * 3 * K;
        for (int j = tid; j < K; j += PT) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int cell = st[c * K + j];
            if (cell > 0) {
              rf[0] = min(rf[0], cell >> 3);
              rf[1] = min(rf[1], -(cell >> 3));
            }
          }
        }
        block_min<kW, CL>(rf, red_fl);
        const FlushPlan p = plan_flush(rf);
        flush_row(s, p);
        if (!p.fits) {
          overflow = true;
          done = false;
          final_s = term_cell = 0;
        }
      }
      stamp(kPhFlush);
      break;
    }
    stamp(kPhTerm);

    // ---------------- reduce (wfa.go:461-540) ----------------
    const bool reducing =
        reduce_on && ex_ms && hi_ms - lo_ms + 1 >= min_wf_len;
    // the post-reduce bands of score s (M, I, D) and the ranges the
    // co-deletion zeroes in I and D
    bool pex[3] = {bex[0], bex[1], bex[2]};
    int plo[3] = {blo[0], blo[1], blo[2]}, phi[3] = {bhi[0], bhi[1], bhi[2]};
    int z[2][4];
    if (reducing) {
      // classify the band: a marked cell lags dmin by more than
      // max_dist_diff; one ballot word of good and of marked cells per 32
      // columns
      const int dmin = r1[0];
      uint32_t* mk_good = mk;
      uint32_t* mk_mark = mk + KWd;
      // (word w holds columns jlo + 32 w ..)
      const int nw = (jhi - jlo) >> 5;
      for (int w = warp; w <= nw; w += kW) {
        const int j = jlo + w * 32 + lane, k = k0 + j;
        bool marked = false, good = false;
        if (j <= jhi) {
          const int cell = row_m[j], hs = cell >> 3, vs = hs - k;
          const bool okd = cell > 0 && vs >= 0 && vs < ql && hs < tl;
          marked = okd && max(tl - hs, ql - vs) - dmin > max_dist_diff;
          good = okd && !marked;
        }
        const uint32_t g = __ballot_sync(0xffffffffu, good);
        const uint32_t m = __ballot_sync(0xffffffffu, marked);
        if (lane == 0) {
          mk_good[w] = g;
          mk_mark[w] = m;
        }
      }
      sync_pair();
      // first_good, last_good, any_marked, and the last mark below
      // first_good
      // (every warp alike, 32 words at once)
      int first_good = kBig, last_good = -kBig, last_mark = -1;
      bool any_marked = false;
      for (int base = 0; base <= nw; base += 32) {
        const int w = base + lane;
        const uint32_t g = w <= nw ? mk_good[w] : 0u;
        const uint32_t m = w <= nw ? mk_mark[w] : 0u;
        any_marked |= __any_sync(0xffffffffu, m != 0);
        const uint32_t gz = __ballot_sync(0xffffffffu, g != 0);
        if (first_good == kBig) {
          // marks below the first good cell: in the words before its
          // word, and below its bit in its word
          const int fl = gz ? __ffs(gz) - 1 : 32;
          const int gb = g ? __ffs(g) - 1 : 0;  // lane fl's first good bit
          const uint32_t below =
              lane < fl ? m : (lane == fl ? m & ((1u << gb) - 1) : 0u);
          const uint32_t bz = __ballot_sync(0xffffffffu, below != 0);
          if (bz) {
            const int ll = 31 - __clz(bz);
            last_mark = jlo + (base + ll) * 32 + 31 -
                        __clz(__shfl_sync(0xffffffffu, below, ll));
          }
          if (gz)
            first_good = jlo + (base + fl) * 32 +
                         __ffs(__shfl_sync(0xffffffffu, g, fl)) - 1;
        }
        if (gz) {
          const int ll = 31 - __clz(gz);
          last_good = jlo + (base + ll) * 32 + 31 -
                      __clz(__shfl_sync(0xffffffffu, g, ll));
        }
      }
      const int new_lo = last_mark >= 0 ? k0 + last_mark + 1 : lo_ms;
      const int new_hi =
          (any_marked && first_good < kBig) ? k0 + last_good : hi_ms;
      plo[0] = new_lo;
      phi[0] = new_hi;
      // co-deletion from I and D (wfa.go:526-535): two ascending Delete
      // sweeps, [lo, new_lo) then (new_hi, hi]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int l1, h1;
        delete_range_asc(lo_ms, new_lo - 1, blo[1 + c], bhi[1 + c], l1, h1,
                         z[c][0], z[c][1]);
        delete_range_asc(new_hi + 1, hi_ms, l1, h1, plo[1 + c], phi[1 + c],
                         z[c][2], z[c][3]);
      }
      // every thread has read the band slots of score s before this step
      // (bex/blo/bhi); next() reads them after the zero pass's barrier
      if (lead) {
        mb.lo[sm] = new_lo;
        mb.hi[sm] = new_hi;
        if (bex[1]) ib.lo[se] = plo[1], ib.hi[se] = phi[1];
        if (bex[2]) db.lo[se] = plo[2], db.hi[se] = phi[2];
      }
    }

    // ---- the zero pass, and the value range of the staged row s (REBASE)
    int rf[2] = {kBig, kBig};  // min offset0, -max offset0
    if (reducing || REBASE) {
      // the union of the bands of score s holds every cell to zero and
      // every staged cell
      int ulo = kBig, uhi = -kBig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (bex[c]) {
          ulo = min(ulo, blo[c]);
          uhi = max(uhi, bhi[c]);
        }
      }
      const int u0 = max(ulo - k0, 0), u1 = min(uhi - k0, K - 1);
      Dst* aux_m = aux_dst(0, s);
      Win* row_i = Iw + (int64_t)se * K;
      Win* row_d = Dw + (int64_t)se * K;
      const St* st = stage + (int64_t)(s & 1) * 3 * K;
      for (int j = u0 + tid; j <= u1; j += PT) {
        const int k = k0 + j;
        if (reducing) {
          // (an absent cell's aux is zero already: aux mirrors cell
          // existence)
          if (k >= lo_ms && k <= hi_ms && (k < plo[0] || k > phi[0])) {
            row_m[j] = 0;
            aux_m[j] = 0;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (bex[1 + c] && ((k >= z[c][0] && k <= z[c][1]) ||
                               (k >= z[c][2] && k <= z[c][3]))) {
              (c == 0 ? row_i : row_d)[j] = 0;
              aux_dst(1 + c, s)[j] = 0;
            }
          }
        }
        if constexpr (REBASE) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int cell = st[c * K + j];
            if (cell > 0) {
              rf[0] = min(rf[0], cell >> 3);
              rf[1] = min(rf[1], -(cell >> 3));
            }
          }
        }
      }
      if constexpr (REBASE) {
        block_min<kW, CL>(rf, red_fl);
      } else {
        sync_pair();
      }
    }
    stamp(kPhReduce);

    // (the post-reduce M band, inside the band the row had)
    if (!GLOBAL && !end_found && pex[0])
      find_end(s, row_m, max(plo[0], lo_ms), min(phi[0], hi_ms));
    stamp(kPhEnd);
    // row s is final: its flush rides next()'s pass; a row that does not
    // fit overflows the pair
    FlushPlan fp{0, true};
    if constexpr (REBASE) {
      fp = plan_flush(rf);
      if (!fp.fits) {
        overflow = true;
        break;
      }
    }
    stamp(kPhFlush);

    // ---------------- next (wfa.go:549-700) ----------------
    const int s2 = s + 1;
    const int s2m = sm + 1 == WM ? 0 : sm + 1, s2e = se + 1 == WE ? 0 : se + 1;
    // (s2 - d) mod W from s2's slot r, for 0 < d < W
    auto back = [](int r, int d, int W) { return r >= d ? r - d : r - d + W; };
    // KRange of each source with the reference's (0, 0) fallback
    // (wfa_component.go:91); a zero penalty step reads the row being
    // written, which does not exist yet
    const int sx = x >= 1 ? back(s2m, x, WM) : 0;
    const int so = oe >= 1 ? back(s2m, oe, WM) : 0;
    const int sie = e >= 1 ? back(s2e, e, WE) : 0, sde = sie;
    const bool p_x = x >= 1 && x <= s2 && mb.ex[sx];
    const bool p_o = oe >= 1 && oe <= s2 && mb.ex[so];
    const bool p_i = e >= 1 && e <= s2 && ib.ex[sie];
    const bool p_d = e >= 1 && e <= s2 && db.ex[sde];
    const int lo_x = p_x ? mb.lo[sx] : 0, hi_x = p_x ? mb.hi[sx] : 0;
    const int lo_o = p_o ? mb.lo[so] : 0, hi_o = p_o ? mb.hi[so] : 0;
    const int lo_ie = p_i ? ib.lo[sie] : 0, hi_ie = p_i ? ib.hi[sie] : 0;
    const int lo_de = p_d ? db.lo[sde] : 0, hi_de = p_d ? db.hi[sde] : 0;
    const int hi_n = min(tl - 1, max(max(hi_x, hi_o), max(hi_ie, hi_de)) + 1);
    const int lo_n =
        max(-(ql - 1), min(min(lo_x, lo_o), min(lo_ie, lo_de)) - 1);
    // the fixed window must hold the new band
    if (lo_n < k0 || hi_n >= k0 + K) {
      overflow = true;
      break;
    }
    const Win* mo_row = Mw + (int64_t)so * K;
    const Win* mx_row = Mw + (int64_t)sx * K;
    const Win* ie_row = Iw + (int64_t)sie * K;
    const Win* de_row = Dw + (int64_t)sde * K;
    const bool at_seed = x > 0 && s2 == x;  // the seed row x pre-exists
    // its band, read before thread 0 rewrites the slot
    const bool ex_old = at_seed && mb.ex[s2m] != 0;
    const int lo_old = mb.lo[s2m], hi_old = mb.hi[s2m];
    // the columns to write: the new band and the bands the overwritten
    // rows still hold (score s2 - WM in M, s2 - WE in I and D, or the seed
    // row x); every other cell of those rows is already zero
    int ja = lo_n - k0, jb = hi_n - k0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
      const int sl = c ? s2e : s2m;
      if (bc.ex[sl]) {
        ja = min(ja, bc.lo[sl] - k0);
        jb = max(jb, bc.hi[sl] - k0);
      }
    }
    ja = max(ja, 0);
    jb = min(jb, K - 1);
    Win* m_new = Mw + (int64_t)s2m * K;
    Win* i_new = Iw + (int64_t)s2e * K;
    Win* d_new = Dw + (int64_t)s2e * K;
    Dst* am_new = aux_dst(0, s2);
    Dst* ai_new = aux_dst(1, s2);
    Dst* ad_new = aux_dst(2, s2);
    uint32_t* mk_i = mk;
    uint32_t* mk_d = mk + KWd;
    uint32_t* mk_m = mk + 2 * KWd;
    // columns ja..jb, a warp's 32 at a time (the ballots; word w holds
    // columns ja + 32 w ..)
    for (int jw = ja; jw <= jb; jw += PT) {
      const int j = jw + tid, k = k0 + j;
      bool wr_i = false, wr_d = false, wr_m = false;
      if (j <= jb) {
        // insertion (wfa.go:578-608): sources at k-1
        int v1i, v2i;
        bool fmi = src(mo_row, p_o, lo_o, hi_o, k0, K, j - 1, v1i);
        bool fii = src(ie_row, p_i, lo_ie, hi_ie, k0, K, j - 1, v2i);
        // pre-invalidation snapshot: the backtrace recomputes offsets from
        // raw stored cells without the bound invalidation (wfa.go:757-827)
        const int isk_nb = (fmi || fii) ? max(v1i, v2i) + 1 : 0;
        if (fmi && v1i > tl) fmi = false, v1i = 0;
        if (fii && v2i > tl) fii = false, v2i = 0;
        const int Isk = max(v1i, v2i) + 1;
        const bool upd_i = fmi || fii;
        const int tag_i = (fmi && v1i >= v2i) ? kInsOpen : kInsExt;
        // deletion (wfa.go:612-643): sources at k+1
        int v1d, v2d;
        bool fmd = src(mo_row, p_o, lo_o, hi_o, k0, K, j + 1, v1d);
        bool fdd = src(de_row, p_d, lo_de, hi_de, k0, K, j + 1, v2d);
        const int dsk_nb = (fmd || fdd) ? max(v1d, v2d) : 0;
        const bool any_id_nb = fmi || fii || fmd || fdd;
        if (fmd && v1d - k > ql) fmd = false, v1d = 0;
        if (fdd && v2d - k > ql) fdd = false, v2d = 0;
        const int Dsk = max(v1d, v2d);
        const bool upd_d = fmd || fdd;
        const int tag_d = (fmd && v1d >= v2d) ? kDelOpen : kDelExt;
        // mismatch / M with the reference tie-breaking (wfa.go:648-698)
        int v1x;
        bool fmx = src(mx_row, p_x, lo_x, hi_x, k0, K, j, v1x);
        const int off_def_nb =
            (any_id_nb || fmx) ? max(max(isk_nb, dsk_nb), v1x + 1) : 0;
        if (fmx && (v1x > tl || v1x - k > ql)) fmx = false, v1x = 0;
        const int Msk = max(max(upd_i ? Isk : 0, upd_d ? Dsk : 0), v1x + 1);
        const int tag_m = (fmx && Msk == v1x + 1)
                              ? kMismatch
                              : ((upd_i && Msk == Isk) ? tag_i : tag_d);
        const bool band = k >= lo_n && k <= hi_n;
        wr_i = upd_i && band;
        wr_d = upd_d && band;
        wr_m = (upd_i || upd_d || fmx) && band;
        // aux: each cell's backtrace branch is selected by its own tag
        const int aux_m_val = tag_m == kInsExt
                                  ? isk_nb
                                  : (tag_m == kDelExt ? dsk_nb : off_def_nb);
        const int row_m_old = at_seed ? m_new[j] : 0;
        i_new[j] = wr_i ? (Isk << 3) | tag_i : 0;
        d_new[j] = wr_d ? (Dsk << 3) | tag_d : 0;
        m_new[j] = wr_m ? (Msk << 3) | tag_m : row_m_old;
        ai_new[j] =
            wr_i ? ((tag_i == kInsExt ? isk_nb : off_def_nb) << 3) | tag_i : 0;
        ad_new[j] =
            wr_d ? ((tag_d == kDelExt ? dsk_nb : off_def_nb) << 3) | tag_d : 0;
        am_new[j] = wr_m ? (aux_m_val << 3) | tag_m : (row_m_old & 7);
      }
      const uint32_t bi = __ballot_sync(0xffffffffu, wr_i);
      const uint32_t bd = __ballot_sync(0xffffffffu, wr_d);
      const uint32_t bm = __ballot_sync(0xffffffffu, wr_m);
      const int w = ((jw - ja) >> 5) + warp;
      if (lane == 0 && w <= (jb - ja) >> 5) {
        mk_i[w] = bi;
        mk_d[w] = bd;
        mk_m[w] = bm;
      }
    }
    stamp(kPhNext);
    if constexpr (REBASE) {
      // the flush of row s, from the other staging parity, which it leaves
      // zero for next() of step s + 1
      flush_row(s, fp);
      stamp(kPhFlush);
    } else if constexpr (PHASE == kPrefix) {
      // aux rows are written whole: zero where no cell was written
      Dst* const rows[3] = {am_new, ai_new, ad_new};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        zero_cells<PT>(rows[c], 0, ja, tid);
        zero_cells<PT>(rows[c], jb + 1, K, tid);
      }
      stamp(kPhTail);
    } else {
      for (int j = tid; j < K; j += PT) {
        if (j < ja || j > jb) am_new[j] = ai_new[j] = ad_new[j] = 0;
      }
      stamp(kPhTail);
    }
    sync_pair();
    // the new bands: the lowest and highest written column of each plane
    const int wl = (lo_n - k0 - ja) >> 5, wh = (hi_n - k0 - ja) >> 5;
    int wlo[3], whi[3];  // I, D, M, as columns past ja
    const uint32_t* const masks[3] = {mk_i, mk_d, mk_m};
    mask_bounds3(masks, wl, wh, wlo, whi);
    const bool any_i = wlo[0] < kBig, any_d = wlo[1] < kBig;
    const bool any_m = wlo[2] < kBig;
    const int kb = k0 + ja;  // the diagonal of column ja
    bex[1] = any_i;
    blo[1] = any_i ? kb + wlo[0] : kBig;
    bhi[1] = any_i ? kb + whi[0] : -kBig;
    bex[2] = any_d;
    blo[2] = any_d ? kb + wlo[1] : kBig;
    bhi[2] = any_d ? kb + whi[1] : -kBig;
    int nlo_m = any_m ? kb + wlo[2] : kBig;
    int nhi_m = any_m ? kb + whi[2] : -kBig;
    if (ex_old) {
      nlo_m = min(nlo_m, lo_old);
      nhi_m = max(nhi_m, hi_old);
    }
    const bool keep = any_m || ex_old;
    bex[0] = keep;
    blo[0] = keep ? nlo_m : kBig;
    bhi[0] = keep ? nhi_m : -kBig;
    if (lead) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
        const int sl = c ? s2e : s2m;
        bc.lo[sl] = blo[c];
        bc.hi[sl] = bhi[c];
        bc.ex[sl] = bex[c];
      }
    }
    sm = s2m;
    se = s2e;
    stamp(kPhBands);
  }
  if constexpr (PHASE == kPrefix) {
    sync_pair();  // the last band slots
    // ---- the narrow window (wfa_tpu/semi2.py:182-206): the union of
    // every band slot next() can still read, plus Ak, centred in K2
    // columns and clipped to the diagonals that exist
    const int K2 = ho.K2;
    int lo_u = kBig, hi_u = -kBig;
    const Band* bands[3] = {&mb, &ib, &db};
    for (int c = 0; c < 3; ++c)
      for (int r = 0; r < (c ? WE : WM); ++r)
        if (bands[c]->ex[r]) {
          lo_u = min(lo_u, bands[c]->lo[r]);
          hi_u = max(hi_u, bands[c]->hi[r]);
        }
    const int win_lo = min(lo_u, Ak), win_hi = max(hi_u, Ak);
    const int width = win_hi - win_lo + 1;
    const int slack = K2 - width;
    int k02 = win_lo - (slack - (slack < 0 ? 1 : 0)) / 2;  // floor division
    k02 = min(max(k02, -(ql - 1)), max(tl - K2, -(ql - 1)));
    // pairs still holding a wide band escape to the wider tiers; done
    // pairs skip phase 2, so any placement serves them
    write_meta1(k02, overflow || (width > K2 && !done));
    // ---- the exports, rebased: narrow column j is window column j + d
    // (0 <= d < K after the clip), zero past the window
    const int d = k02 - k0;
    auto rebased = [&](const Win* row, int j) -> int32_t {
      return j + d < K ? row[j + d] : 0;
    };
    for (int r = 0; r < WM; ++r)
      for (int j = tid; j < K2; j += PT)
        ho.win_m[((int64_t)r * B + b) * K2 + j] = rebased(Mw + r * K, j);
    for (int r = 0; r < WE; ++r)
      for (int j = tid; j < K2; j += PT) {
        ho.win_i[((int64_t)r * B + b) * K2 + j] = rebased(Iw + r * K, j);
        ho.win_d[((int64_t)r * B + b) * K2 + j] = rebased(Dw + r * K, j);
      }
    for (int c = 0; c < 3; ++c) {
      const Cell* row = stage + (int64_t)c * K;
      for (int j = tid; j < K2; j += PT)
        ho.ainit[((int64_t)c * B + b) * K2 + j] = j + d < K ? row[j + d] : 0;
    }
    if (tid == 0) {
      for (int r = 0; r < WM; ++r) {
        ho.b_m[(int64_t)r * B + b] = mb.lo[r];
        ho.b_m[(int64_t)(WM + r) * B + b] = mb.hi[r];
        ho.b_m[(int64_t)(2 * WM + r) * B + b] = mb.ex[r];
      }
      for (int c = 0; c < 2; ++c)
        for (int r = 0; r < WE; ++r) {
          int32_t* dst = ho.b_ie + (int64_t)(3 * c * WE + r) * B + b;
          dst[0] = bands[1 + c]->lo[r];
          dst[(int64_t)WE * B] = bands[1 + c]->hi[r];
          dst[(int64_t)2 * WE * B] = bands[1 + c]->ex[r];
        }
    }
  } else {
    write_out();
  }
  stamp(kPhExport);
  if constexpr (TIMED) {
    if (tid == 0)
      for (int i = 0; i < kPhases; ++i)
        cycles[(int64_t)b * kPhases + i] = acc[i];
  }
  if constexpr (CL > 1) sync_pair();  // no block leaves its cluster early
}

// ---------------------------------------------------------------------------
// The warp shape of K1-kw and K4: one warp a pair, blockDim.x / 32 pairs a
// block (kernel_engine.warp_plan picks them, up to kWarpPairs, and where
// the workspaces lie).  The step is score_loop_kernel's (extend,
// termination, the wf-adaptive reduce, next(), the end finder, K1-kw's
// flush), for one warp: every barrier is the warp's, every reduction a
// warp reduction with no shared slots, and the ballots of the reduce's
// classify and of next() fold into registers 32 columns at a time, so the
// step has no block barrier and no ballot words.  Pairs of one block
// leave at different steps, so nothing block-wide follows the first
// branch that depends on the pair.  Each warp keeps its band slots, and
// its workspace where the launch passes no scratch, in its own share of
// the block's shared memory.  What the shape changes besides:
//  * K1-kw's flush reads, rebases and zeroes only the staged cells of the
//    band union (the 8-column groups that meet it, a cell a lane), and
//    writes every other group of each kw-wide aux row as zero with a
//    16-byte store; the terminating row's value range strides the same
//    band.  With W16 its window and staged cells
//    are uint16: every offset of a target buffer of at most kMaxLtb16
//    columns fits them ((Ltb + 2) << 3 | 7 < 2^16).
//  * K4's window cells are its aux cells (int16 where they fit, as K3's),
//    and next() writes whole 8-column groups of its aux rows (the cells
//    outside the band zero), the rest of each row zeroed with 16-byte
//    stores.
// What bounds it: on a narrow band (a mean of ~9 columns at 4/6/2, e.g.
// l=4000, l=1000) a step is a short chain for one warp, and the
// instructions an SM's warps execute set the pace when each SM holds many
// pairs (2048 of l=4000: 16 an SM in one wave); with a pair or fewer an
// SM (64 of l=10000) one warp's chain of latencies sets it.  A wide band
// (~33 columns at 4/6/1) takes one warp two passes where four warps took
// one, which costs K4 ~10% at 256 pairs of l=1000 (PERF.md §6).

// K1-kw's 16-bit cells hold every offset of a target buffer of this many
// columns or fewer (an offset0 is at most tlen + 2; kernel_engine
// .kw_cell16 mirrors it)
constexpr int kMaxLtb16 = 8189;
// window (and K1-kw's staged) cells of the warp shape
template <bool KW, typename Cell, bool W16>
using WarpCell =
    std::conditional_t<KW, std::conditional_t<W16, uint16_t, int32_t>, Cell>;

// the int32 cells of a pair's workspace in the warp shape: its windows
// and (K1-kw) six staged rows in cells of `win_bytes`, rounded up to a
// multiple of 4 (16-byte aligned workspaces); no ballot words
__host__ __device__ __forceinline__ int64_t warp_workspace_ints(
    int K, int WM, int WE, int stage, int win_bytes) {
  return (window_ints(K, WM + 2 * WE + stage, win_bytes) + 3) &
         ~int64_t(3);
}
// the warp shape's shared ints for each pair of a block: its band slots,
// rounded up to a multiple of 4, then its workspace when that lies in
// shared memory (no scratch)
__host__ __device__ constexpr int warp_slot_ints(int WM, int WE) {
  return (3 * WM + 6 * WE + 3) & ~3;
}
inline int64_t warp_shared_ints(int pairs, int K, int WM, int WE, int stage,
                                bool scratch, int win_bytes) {
  return pairs * (warp_slot_ints(WM, WE) +
                  (scratch ? 0
                           : warp_workspace_ints(K, WM, WE, stage,
                                                 win_bytes)));
}

// The minimum of N values at once over the warp (a maximum passes its
// negation); every lane gets the results, and the warp's barrier orders
// every shared and global write before it
template <int N>
__device__ __forceinline__ void warp_min(int (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __reduce_min_sync(0xffffffffu, v[i]);
  __syncwarp();
}

// K1-kw's flush of a row: the value base, the window column / 32, whether
// the row fits the int16 cells and the window, and the window columns
// [f0, f1] of the band union, which hold every staged cell
struct KwFlush {
  int base;
  int cb;
  bool fits;
  int f0;
  int f1;
};

// Zero the 8-cell groups of a row of K cells (K % 8 == 0, the row 16-byte
// aligned) outside columns [ja, jb], ja and jb + 1 multiples of 8: a lane
// a group, 16-byte stores
template <typename C>
__device__ __forceinline__ void zero_groups(C* row, int K, int ja, int jb,
                                            int lane) {
  constexpr int V = 16 / sizeof(C);  // cells a 16-byte store
  for (int j = 8 * lane; j < K; j += 256) {
    if (j < ja || j > jb) {
#pragma unroll
      for (int i = 0; i < 8; i += V)
        *reinterpret_cast<int4*>(row + j + i) = make_int4(0, 0, 0, 0);
    }
  }
}

// KW: K1-kw (global, REBASE's staging with a kw-column row window, sbase
// words) with 16-bit window and staged cells when W16; else K4 (the
// resume of the two-phase route, semi-global).  The arguments are
// score_loop_kernel's, aux_base being K1-kw's sbase.
template <bool KW, typename Cell, bool TIMED, bool W16 = false>
__global__ void __launch_bounds__(kWarpBlock, 1) warp_loop_kernel(
    const uint8_t* __restrict__ qb, const uint8_t* __restrict__ tbuf,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ toff, int B, int Lq, int Ltb, int S, int K,
    int x, int oe, int e, int reduce_on, int min_wf_len, int max_dist_diff,
    int kw, int32_t* __restrict__ win, int32_t* __restrict__ out,
    Cell* __restrict__ aux, int32_t* __restrict__ aux_base, Handoff ho,
    long long* __restrict__ cycles) {
  static_assert(KW || !W16, "16-bit staged cells are K1-kw's");
  constexpr bool GLOBAL = KW;
  using Win = WarpCell<KW, Cell, W16>;
  using Dst = std::conditional_t<KW, Win, Cell>;  // where next() puts aux
  constexpr int kStage = KW ? 6 : 0;
  const int S0 = KW ? 0 : ho.S0;
  // aux rows held and the score of the first
  const int Sa = KW ? S : S - S0;
  const int KA = KW ? kw : K;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the last block's spare warps
  const int lane = threadIdx.x & 31;
  const bool lead = lane == 0;
  const int WM = max(x, oe) + 1, WE = e + 1;
  const int64_t ws_ints =
      warp_workspace_ints(K, WM, WE, kStage, sizeof(Win));
  extern __shared__ int smem[];
  // this warp's share of the block's shared memory: its band slots, then
  // its workspace unless the launch passes a scratch
  int* const slots = smem + (threadIdx.x >> 5) *
                                (warp_slot_ints(WM, WE) + (win ? 0 : ws_ints));
  Band mb{slots, slots + WM, slots + 2 * WM};
  int* base_ie = slots + 3 * WM;
  Band ib{base_ie, base_ie + WE, base_ie + 2 * WE};
  Band db{base_ie + 3 * WE, base_ie + 4 * WE, base_ie + 5 * WE};
  // 16-byte groups of 8 cells: aux rows, staged rows and workspace rows
  // whole in 16-byte words
  const bool vec8 = K % 8 == 0 && KA % 8 == 0;

  // TIMED: lane 0 adds the cycles since the last stamp to a phase
  long long t_mark = 0, acc[kPhases] = {};
  auto stamp = [&](int ph) {
    if constexpr (TIMED) {
      if (lead) {
        const long long now = clock64();
        acc[ph] += now - t_mark;
        t_mark = now;
      }
    }
  };
  if constexpr (TIMED) t_mark = clock64();

  const int ql = qlen[b], tl = tlen[b], tof = toff[b];
  const int k0 = -tof, Ak = tl - ql, jak = Ak - k0;
  int32_t* ws = win ? win + b * ws_ints : slots + warp_slot_ints(WM, WE);
  Win* Mw = reinterpret_cast<Win*>(ws);
  Win* Iw = Mw + (int64_t)WM * K;
  Win* Dw = Iw + (int64_t)WE * K;
  Win* stage = Dw + (int64_t)WE * K;  // K1-kw's staged rows
  auto aux_row = [&](int comp, int s) {
    return aux + ((int64_t)(comp * Sa + s - S0) * B + b) * KA;
  };
  // where seeding, reduce and next put a row's aux: K1-kw's staging rows
  // of the row's parity, K4's output row
  auto aux_dst = [&](int comp, int s) -> Dst* {
    if constexpr (KW) {
      return stage + (int64_t)((s & 1) * 3 + comp) * K;
    } else {
      return aux_row(comp, s);
    }
  };
  // K1-kw: the flush of row s from its staged cells' minimum r[0] and
  // negated maximum r[1] offset0 and the row's bands after its reduce
  auto plan_flush = [&](const int (&r)[2], const bool (&bex)[3],
                        const int (&blo)[3], const int (&bhi)[3]) {
    KwFlush p{r[0] < kBig ? max(r[0], 0) : 0, 0, true, 0, -1};
    int lo_u = kBig, hi_u = -kBig;
    bool anyb = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (bex[c]) {
        lo_u = min(lo_u, blo[c]);
        hi_u = max(hi_u, bhi[c]);
        anyb = true;
      }
    }
    // C++ division truncates toward zero, as lax.div does
    if (anyb) p.cb = min(max((lo_u - k0) / 32, 0), (K - kw) / 32);
    const int vmx = r[1] < kBig ? -r[1] : -kBig;
    p.fits = !anyb || (hi_u - k0 - p.cb * 32 < kw &&
                       vmx - p.base + 1 <= kMaxRebased);
    // every staged cell lies in the band union (the reduce zeroed the
    // rest); clipped to the window, which holds it when the row fits
    if (anyb) {
      p.f0 = max(lo_u - k0, p.cb * 32);
      p.f1 = min(hi_u - k0, p.cb * 32 + kw - 1);
    }
    return p;
  };
  // K1-kw: the flush of row s into its kw-wide aux rows from window
  // column cb * 32, rebased, and its sbase word; the staged cells read are
  // left zero, so the parity is all zero again (a fitting row has no cell
  // outside the window).  Where K and kw are multiples of 8, the 8-cell
  // groups that meet the band union [f0, f1] take a lane a cell (their
  // staged cells outside the band are zero), every other group a 16-byte
  // store of zeros by a lane; else a lane a cell across the row.
  auto flush_row = [&](int s, const KwFlush& p) {
    Win* st = stage + (int64_t)(s & 1) * 3 * K;
    const int c0 = p.cb * 32;
    const bool any = p.f0 <= p.f1;
    int a = 0, z = kw - 1;  // the columns written a lane a cell
    if (vec8) {
      a = any ? (p.f0 - c0) & ~7 : kw;
      z = any ? (p.f1 - c0) | 7 : -1;
    }
    for (int j = a + lane; j <= z; j += 32) {
      const bool in = any && j + c0 >= p.f0 && j + c0 <= p.f1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        int cell = 0;
        if (in) {
          cell = st[(int64_t)c * K + c0 + j];
          st[(int64_t)c * K + c0 + j] = 0;
        }
        aux_row(c, s)[j] = static_cast<Cell>(
            cell > 0 ? (((cell >> 3) - p.base + 1) << 3) | (cell & 7) : 0);
      }
    }
    if (vec8) {
#pragma unroll
      for (int c = 0; c < 3; ++c) zero_groups(aux_row(c, s), kw, a, z, lane);
    }
    if (lead) aux_base[(int64_t)s * B + b] = (p.base << 5) | p.cb;
  };

  // the resume's holds the terminal diagonal, and meta1 says who escaped
  // phase 1
  const int32_t* m1 = KW ? nullptr : ho.meta1 + (int64_t)b * kM1Cols;
  bool overflow;
  if constexpr (KW) {
    overflow = Ak < k0 || Ak >= k0 + K || 0 < k0 || 0 >= k0 + K;
  } else {
    overflow = m1[kM1Ovf] != 0 || Ak < k0 || Ak >= k0 + K;
  }
  const uint8_t* q = qb + (int64_t)b * Lq;
  const uint8_t* t = tbuf + (int64_t)b * Ltb + tof;  // t[h], valid if !overflow
  bool done = false;
  int final_s = 0, term_cell = 0;
  // semi-global end finder: the first success over ascending s
  bool end_found = false;
  int end_s = 0, end_k = 0, end_cell = 0;
  if constexpr (!KW) {  // phase 1's results and end-finder state
    done = m1[kM1Done] != 0;
    final_s = m1[kM1Fs];
    term_cell = m1[kM1Term];
    end_found = m1[kM1EFound] != 0;
    end_s = m1[kM1Es];
    end_k = m1[kM1Ek];
    end_cell = m1[kM1ECell];
  }
  auto write_out = [&]() {
    if (lead) {
      const bool use_end = !GLOBAL && done && !overflow && end_found;
      out[b] = final_s;
      out[B + b] = done;
      out[2 * B + b] = overflow || !done;
      out[3 * B + b] = term_cell;
      out[4 * B + b] = use_end ? end_s : final_s;
      out[5 * B + b] = use_end ? end_k : Ak;
      out[6 * B + b] = use_end ? end_cell : term_cell;
    }
  };
  bool eq00 = false;
  if (KW && !overflow) {
    eq00 = q[0] == t[0];
    // a mismatch seed beyond the score cap can never be reached
    if (!eq00 && x >= S && x > 0) overflow = true;
  }
  if (overflow || (!KW && done)) {
    write_out();
    return;
  }

  if constexpr (KW) {
    for (int i = lane; i < WM * K; i += 32) Mw[i] = 0;
    for (int i = lane; i < WE * K; i += 32) Iw[i] = Dw[i] = 0;
    for (int i = lane; i < kStage * K; i += 32) stage[i] = 0;
    __syncwarp();
    // ---- seeding (wfa.go:143-184): one cell, diagonal 0 at offset 1
    const int j0 = -k0;
    const int cell0 = (1 << 3) | (eq00 ? kMatch : kMismatch);
    const int seed_row = (eq00 || x == 0) ? 0 : x;
    if (lead) {
      Mw[seed_row * K + j0] = cell0;
      for (int r = 0; r < WM; ++r) {
        mb.lo[r] = r == seed_row ? 0 : kBig;
        mb.hi[r] = r == seed_row ? 0 : -kBig;
        mb.ex[r] = r == seed_row;
      }
      for (int r = 0; r < WE; ++r) {
        ib.lo[r] = db.lo[r] = kBig;
        ib.hi[r] = db.hi[r] = -kBig;
        ib.ex[r] = db.ex[r] = 0;
      }
    }
    // aux row 0: seed cells have no sources, so their aux is the tag bits
    for (int j = lane; j < K; j += 32) {
      aux_dst(0, 0)[j] = (seed_row == 0 && j == j0) ? (cell0 & 7) : 0;
      aux_dst(1, 0)[j] = 0;
      aux_dst(2, 0)[j] = 0;
    }
  } else {
    // ---- the phase-1 handoff: window rows, band slots, aux row S0.  The
    // exports' rows [rows, B, K] of pair b to rows `stride` cells apart,
    // 16 bytes a load where K % 4 == 0, four loads in flight a lane
    auto copy_rows = [&](auto* dst, int64_t stride, const int32_t* src,
                         int rows) {
      if (K % 4 == 0) {
        const int q4 = K / 4, n = rows * q4;
#pragma unroll 4
        for (int i = lane; i < n; i += 32) {
          const int r = i / q4, j = 4 * (i - r * q4);
          const int4 v = *reinterpret_cast<const int4*>(
              src + ((int64_t)r * B + b) * K + j);
          auto* d = dst + r * stride + j;
          d[0] = v.x;
          d[1] = v.y;
          d[2] = v.z;
          d[3] = v.w;
        }
      } else {
        for (int r = 0; r < rows; ++r)
          for (int j = lane; j < K; j += 32)
            dst[r * stride + j] = src[((int64_t)r * B + b) * K + j];
      }
    };
    copy_rows(Mw, K, ho.win_m, WM);
    copy_rows(Iw, K, ho.win_i, WE);
    copy_rows(Dw, K, ho.win_d, WE);
    copy_rows(aux_row(0, S0), (int64_t)Sa * B * K, ho.ainit, 3);
    if (lead) {
      for (int r = 0; r < WM; ++r) {
        mb.lo[r] = ho.b_m[(int64_t)r * B + b];
        mb.hi[r] = ho.b_m[(int64_t)(WM + r) * B + b];
        mb.ex[r] = ho.b_m[(int64_t)(2 * WM + r) * B + b];
      }
      const Band* cbands[2] = {&ib, &db};
      for (int c = 0; c < 2; ++c)
        for (int r = 0; r < WE; ++r) {
          const int32_t* src_b = ho.b_ie + (int64_t)(3 * c * WE + r) * B + b;
          cbands[c]->lo[r] = src_b[0];
          cbands[c]->hi[r] = src_b[(int64_t)WE * B];
          cbands[c]->ex[r] = src_b[(int64_t)2 * WE * B];
        }
    }
  }
  __syncwarp();

  // the nearest stop cell on each side of Ak in an M row (wfa.go:270-375):
  // the largest 2j + succ at k <= Ak and the smallest 2j + !succ above it,
  // over the row's band [lo, hi] (every other cell of a window row is zero)
  auto find_end = [&](int s, const Win* row, int lo, int hi) {
    const int j0 = max(lo - k0, 0), j1 = min(hi - k0, K - 1);
    if (j0 > j1) return;
    int r2[2] = {kBig, kBig};  // -(2 j_dn + succ_dn), 2 j_up + !succ_up
    for (int j = j0 + lane; j <= j1; j += 32) {
      const int cell = row[j];
      if (cell <= 0) continue;
      const int k = k0 + j, h = cell >> 3, v = h - k;
      const bool viol = v <= 0 || v > ql || h > tl;
      const bool elig = (v == ql && h >= ql) || (h == tl && v >= tl);
      if (!viol && !elig) continue;
      if (k <= Ak) r2[0] = min(r2[0], -(2 * j + !viol));
      else r2[1] = min(r2[1], 2 * j + viol);
    }
    warp_min(r2);
    const bool succ_dn = r2[0] < kBig && ((-r2[0]) & 1);
    const bool succ_up = r2[1] < kBig && !(r2[1] & 1);
    if (succ_up || succ_dn) {
      const int j = succ_up ? r2[1] >> 1 : (-r2[0]) >> 1;
      end_found = true;
      end_s = s;
      end_k = k0 + j;
      end_cell = row[j];
    }
  };

  stamp(kPhSetup);

  // The bands of score s (M at s % WM, I and D at s % WE) ride in
  // registers from the next() that found them; lane 0 keeps the slots up
  // to date for the older rows next() reads.
  bool bex[3];  // M, I, D exist
  int blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
    const int sl = c ? S0 % WE : S0 % WM;
    bex[c] = bc.ex[sl] != 0;
    blo[c] = bc.lo[sl];
    bhi[c] = bc.hi[sl];
  }

  int sm = S0 % WM, se = S0 % WE;
  for (int s = S0; s < S - 1; ++s) {
    if constexpr (TIMED) ++acc[kPhSteps];
    const int lo_ms = blo[0], hi_ms = bhi[0];
    const bool ex_ms = bex[0];
    Win* row_m = Mw + (int64_t)sm * K;
    // the band's columns (the window holds every band)
    const int jlo = max(lo_ms - k0, 0), jhi = min(hi_ms - k0, K - 1);

    // ---------------- extend (wfa.go:381-458) ----------------
    // with dmin over the extended in-bounds cells and the Ak cell
    int r1[2] = {kBig, kBig};  // dmin, -cell at Ak
    if (ex_ms) {
      for (int j = jlo + lane; j <= jhi; j += 32) {
        int cell = row_m[j];
        const int k = k0 + j;
        if (cell > 0) {
          const int h0 = cell >> 3, v0 = h0 - k;
          if (v0 > 0 && v0 < ql && h0 < tl) {
            const int n = lcp(q + v0, t + h0, min(ql - v0, tl - h0));
            if (n > 0) {
              cell += n << 3;
              row_m[j] = cell;
            }
          }
          const int hs = cell >> 3, vs = hs - k;
          if (vs >= 0 && vs < ql && hs < tl)
            r1[0] = min(r1[0], max(tl - hs, ql - vs));
        }
        if (j == jak) r1[1] = -cell;
      }
      if constexpr (TIMED) {
        if (lead) acc[kPhWidth] += jhi - jlo + 1;
      }
    }
    warp_min(r1);
    stamp(kPhExtend);

    // ---------------- termination (wfa.go:235-239) ----------------
    const int cell_ak = r1[1] < kBig ? -r1[1] : 0;
    if (ex_ms && Ak >= lo_ms && Ak <= hi_ms && cell_ak > 0 &&
        (cell_ak >> 3) >= tl) {
      stamp(kPhTerm);
      done = true;
      final_s = s;
      term_cell = cell_ak;
      // the terminating row is searched unreduced
      if (!GLOBAL && !end_found) find_end(s, row_m, lo_ms, hi_ms);
      stamp(kPhEnd);
      // and K1-kw streams it unreduced.  A row that does not fit
      // overflows the pair; done, final_s and term_cell stay as the TPU
      // kernel keeps them (see the header)
      if constexpr (KW) {
        int rf[2] = {kBig, kBig};  // min offset0, -max offset0
        const Win* st = stage + (int64_t)(s & 1) * 3 * K;
        // the staged cells lie in the band union of score s
        int ulo = kBig, uhi = -kBig;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (bex[c]) {
            ulo = min(ulo, blo[c]);
            uhi = max(uhi, bhi[c]);
          }
        }
        const int j1 = min(uhi - k0, K - 1);
        for (int j = max(ulo - k0, 0) + lane; j <= j1; j += 32) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int cell = st[c * K + j];
            if (cell > 0) {
              rf[0] = min(rf[0], cell >> 3);
              rf[1] = min(rf[1], -(cell >> 3));
            }
          }
        }
        warp_min(rf);
        const KwFlush p = plan_flush(rf, bex, blo, bhi);
        flush_row(s, p);
        if (!p.fits) overflow = true;
      }
      stamp(kPhFlush);
      break;
    }
    stamp(kPhTerm);

    // ---------------- reduce (wfa.go:461-540) ----------------
    const bool reducing =
        reduce_on && ex_ms && hi_ms - lo_ms + 1 >= min_wf_len;
    // the post-reduce bands of score s (M, I, D) and the ranges the
    // co-deletion zeroes in I and D
    bool pex[3] = {bex[0], bex[1], bex[2]};
    int plo[3] = {blo[0], blo[1], blo[2]}, phi[3] = {bhi[0], bhi[1], bhi[2]};
    int z[2][4];
    if (reducing) {
      // classify the band: a marked cell lags dmin by more than
      // max_dist_diff; the warp folds the ballots of good and marked
      // cells, 32 columns at a time, into first_good, last_good, the last
      // mark below first_good and any_marked
      const int dmin = r1[0];
      int first_good = kBig, last_good = -kBig, last_mark = -1;
      bool any_marked = false;
      for (int j32 = jlo; j32 <= jhi; j32 += 32) {
        const int j = j32 + lane, k = k0 + j;
        bool marked = false, good = false;
        if (j <= jhi) {
          const int cell = row_m[j], hs = cell >> 3, vs = hs - k;
          const bool okd = cell > 0 && vs >= 0 && vs < ql && hs < tl;
          marked = okd && max(tl - hs, ql - vs) - dmin > max_dist_diff;
          good = okd && !marked;
        }
        const uint32_t g = __ballot_sync(0xffffffffu, good);
        const uint32_t m = __ballot_sync(0xffffffffu, marked);
        any_marked |= m != 0;
        if (first_good == kBig) {
          // marks below the first good cell
          const uint32_t below = g ? m & ((1u << (__ffs(g) - 1)) - 1) : m;
          if (below) last_mark = j32 + 31 - __clz(below);
          if (g) first_good = j32 + __ffs(g) - 1;
        }
        if (g) last_good = j32 + 31 - __clz(g);
      }
      const int new_lo = last_mark >= 0 ? k0 + last_mark + 1 : lo_ms;
      const int new_hi =
          (any_marked && first_good < kBig) ? k0 + last_good : hi_ms;
      plo[0] = new_lo;
      phi[0] = new_hi;
      // co-deletion from I and D (wfa.go:526-535): two ascending Delete
      // sweeps, [lo, new_lo) then (new_hi, hi]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int l1, h1;
        delete_range_asc(lo_ms, new_lo - 1, blo[1 + c], bhi[1 + c], l1, h1,
                         z[c][0], z[c][1]);
        delete_range_asc(new_hi + 1, hi_ms, l1, h1, plo[1 + c], phi[1 + c],
                         z[c][2], z[c][3]);
      }
      // every lane has read the band slots of score s before this step
      // (bex/blo/bhi); next() reads them after the zero pass's barrier
      if (lead) {
        mb.lo[sm] = new_lo;
        mb.hi[sm] = new_hi;
        if (bex[1]) ib.lo[se] = plo[1], ib.hi[se] = phi[1];
        if (bex[2]) db.lo[se] = plo[2], db.hi[se] = phi[2];
      }
    }

    // ---- the zero pass, and the value range of the staged row s (K1-kw)
    int rf[2] = {kBig, kBig};  // min offset0, -max offset0
    if (reducing || KW) {
      // the union of the bands of score s holds every cell to zero and
      // every staged cell
      int ulo = kBig, uhi = -kBig;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (bex[c]) {
          ulo = min(ulo, blo[c]);
          uhi = max(uhi, bhi[c]);
        }
      }
      const int u0 = max(ulo - k0, 0), u1 = min(uhi - k0, K - 1);
      Dst* aux_m = aux_dst(0, s);
      Win* row_i = Iw + (int64_t)se * K;
      Win* row_d = Dw + (int64_t)se * K;
      const Win* st = stage + (int64_t)(s & 1) * 3 * K;
      for (int j = u0 + lane; j <= u1; j += 32) {
        const int k = k0 + j;
        if (reducing) {
          // (an absent cell's aux is zero already: aux mirrors cell
          // existence)
          if (k >= lo_ms && k <= hi_ms && (k < plo[0] || k > phi[0])) {
            row_m[j] = 0;
            aux_m[j] = 0;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (bex[1 + c] && ((k >= z[c][0] && k <= z[c][1]) ||
                               (k >= z[c][2] && k <= z[c][3]))) {
              (c == 0 ? row_i : row_d)[j] = 0;
              aux_dst(1 + c, s)[j] = 0;
            }
          }
        }
        if constexpr (KW) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int cell = st[c * K + j];
            if (cell > 0) {
              rf[0] = min(rf[0], cell >> 3);
              rf[1] = min(rf[1], -(cell >> 3));
            }
          }
        }
      }
      if constexpr (KW) {
        warp_min(rf);
      } else {
        __syncwarp();
      }
    }
    stamp(kPhReduce);

    // (the post-reduce M band, inside the band the row had)
    if (!GLOBAL && !end_found && pex[0])
      find_end(s, row_m, max(plo[0], lo_ms), min(phi[0], hi_ms));
    stamp(kPhEnd);
    // row s is final: K1-kw's flush rides next()'s pass; a row that does
    // not fit overflows the pair
    KwFlush fp{0, 0, true, 0, -1};
    if constexpr (KW) {
      fp = plan_flush(rf, pex, plo, phi);
      if (!fp.fits) {
        overflow = true;
        break;
      }
    }
    stamp(kPhFlush);

    // ---------------- next (wfa.go:549-700) ----------------
    const int s2 = s + 1;
    const int s2m = sm + 1 == WM ? 0 : sm + 1, s2e = se + 1 == WE ? 0 : se + 1;
    // (s2 - d) mod W from s2's slot r, for 0 < d < W
    auto back = [](int r, int d, int W) { return r >= d ? r - d : r - d + W; };
    // KRange of each source with the reference's (0, 0) fallback
    // (wfa_component.go:91); a zero penalty step reads the row being
    // written, which does not exist yet
    const int sx = x >= 1 ? back(s2m, x, WM) : 0;
    const int so = oe >= 1 ? back(s2m, oe, WM) : 0;
    const int sie = e >= 1 ? back(s2e, e, WE) : 0, sde = sie;
    const bool p_x = x >= 1 && x <= s2 && mb.ex[sx];
    const bool p_o = oe >= 1 && oe <= s2 && mb.ex[so];
    const bool p_i = e >= 1 && e <= s2 && ib.ex[sie];
    const bool p_d = e >= 1 && e <= s2 && db.ex[sde];
    const int lo_x = p_x ? mb.lo[sx] : 0, hi_x = p_x ? mb.hi[sx] : 0;
    const int lo_o = p_o ? mb.lo[so] : 0, hi_o = p_o ? mb.hi[so] : 0;
    const int lo_ie = p_i ? ib.lo[sie] : 0, hi_ie = p_i ? ib.hi[sie] : 0;
    const int lo_de = p_d ? db.lo[sde] : 0, hi_de = p_d ? db.hi[sde] : 0;
    const int hi_n = min(tl - 1, max(max(hi_x, hi_o), max(hi_ie, hi_de)) + 1);
    const int lo_n =
        max(-(ql - 1), min(min(lo_x, lo_o), min(lo_ie, lo_de)) - 1);
    // the fixed window must hold the new band
    if (lo_n < k0 || hi_n >= k0 + K) {
      overflow = true;
      break;
    }
    const Win* mo_row = Mw + (int64_t)so * K;
    const Win* mx_row = Mw + (int64_t)sx * K;
    const Win* ie_row = Iw + (int64_t)sie * K;
    const Win* de_row = Dw + (int64_t)sde * K;
    const bool at_seed = x > 0 && s2 == x;  // the seed row x pre-exists
    // its band, read before lane 0 rewrites the slot
    const bool ex_old = at_seed && mb.ex[s2m] != 0;
    const int lo_old = mb.lo[s2m], hi_old = mb.hi[s2m];
    // the columns to write: the new band and the bands the overwritten
    // rows still hold (score s2 - WM in M, s2 - WE in I and D, or the seed
    // row x); every other cell of those rows is already zero.  K4 widens
    // them to whole 8-cell groups, which its aux rows take whole
    int ja = lo_n - k0, jb = hi_n - k0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
      const int sl = c ? s2e : s2m;
      if (bc.ex[sl]) {
        ja = min(ja, bc.lo[sl] - k0);
        jb = max(jb, bc.hi[sl] - k0);
      }
    }
    ja = max(ja, 0);
    jb = min(jb, K - 1);
    if (!KW && vec8) {
      ja &= ~7;
      jb |= 7;
    }
    Win* m_new = Mw + (int64_t)s2m * K;
    Win* i_new = Iw + (int64_t)s2e * K;
    Win* d_new = Dw + (int64_t)s2e * K;
    Dst* am_new = aux_dst(0, s2);
    Dst* ai_new = aux_dst(1, s2);
    Dst* ad_new = aux_dst(2, s2);
    // the lowest and highest written column of each plane (I, D, M, as
    // columns past ja), folded from the ballots as they come
    int wlo[3] = {kBig, kBig, kBig}, whi[3] = {-kBig, -kBig, -kBig};
    for (int jw = ja; jw <= jb; jw += 32) {
      const int j = jw + lane, k = k0 + j;
      bool wr_i = false, wr_d = false, wr_m = false;
      if (j <= jb) {
        // insertion (wfa.go:578-608): sources at k-1
        int v1i, v2i;
        bool fmi = src(mo_row, p_o, lo_o, hi_o, k0, K, j - 1, v1i);
        bool fii = src(ie_row, p_i, lo_ie, hi_ie, k0, K, j - 1, v2i);
        // pre-invalidation snapshot: the backtrace recomputes offsets from
        // raw stored cells without the bound invalidation (wfa.go:757-827)
        const int isk_nb = (fmi || fii) ? max(v1i, v2i) + 1 : 0;
        if (fmi && v1i > tl) fmi = false, v1i = 0;
        if (fii && v2i > tl) fii = false, v2i = 0;
        const int Isk = max(v1i, v2i) + 1;
        const bool upd_i = fmi || fii;
        const int tag_i = (fmi && v1i >= v2i) ? kInsOpen : kInsExt;
        // deletion (wfa.go:612-643): sources at k+1
        int v1d, v2d;
        bool fmd = src(mo_row, p_o, lo_o, hi_o, k0, K, j + 1, v1d);
        bool fdd = src(de_row, p_d, lo_de, hi_de, k0, K, j + 1, v2d);
        const int dsk_nb = (fmd || fdd) ? max(v1d, v2d) : 0;
        const bool any_id_nb = fmi || fii || fmd || fdd;
        if (fmd && v1d - k > ql) fmd = false, v1d = 0;
        if (fdd && v2d - k > ql) fdd = false, v2d = 0;
        const int Dsk = max(v1d, v2d);
        const bool upd_d = fmd || fdd;
        const int tag_d = (fmd && v1d >= v2d) ? kDelOpen : kDelExt;
        // mismatch / M with the reference tie-breaking (wfa.go:648-698)
        int v1x;
        bool fmx = src(mx_row, p_x, lo_x, hi_x, k0, K, j, v1x);
        const int off_def_nb =
            (any_id_nb || fmx) ? max(max(isk_nb, dsk_nb), v1x + 1) : 0;
        if (fmx && (v1x > tl || v1x - k > ql)) fmx = false, v1x = 0;
        const int Msk = max(max(upd_i ? Isk : 0, upd_d ? Dsk : 0), v1x + 1);
        const int tag_m = (fmx && Msk == v1x + 1)
                              ? kMismatch
                              : ((upd_i && Msk == Isk) ? tag_i : tag_d);
        const bool band = k >= lo_n && k <= hi_n;
        wr_i = upd_i && band;
        wr_d = upd_d && band;
        wr_m = (upd_i || upd_d || fmx) && band;
        // aux: each cell's backtrace branch is selected by its own tag
        const int aux_m_val = tag_m == kInsExt
                                  ? isk_nb
                                  : (tag_m == kDelExt ? dsk_nb : off_def_nb);
        const int row_m_old = at_seed ? m_new[j] : 0;
        i_new[j] = wr_i ? (Isk << 3) | tag_i : 0;
        d_new[j] = wr_d ? (Dsk << 3) | tag_d : 0;
        m_new[j] = wr_m ? (Msk << 3) | tag_m : row_m_old;
        ai_new[j] =
            wr_i ? ((tag_i == kInsExt ? isk_nb : off_def_nb) << 3) | tag_i : 0;
        ad_new[j] =
            wr_d ? ((tag_d == kDelExt ? dsk_nb : off_def_nb) << 3) | tag_d : 0;
        am_new[j] = wr_m ? (aux_m_val << 3) | tag_m : (row_m_old & 7);
      }
      const uint32_t bits[3] = {__ballot_sync(0xffffffffu, wr_i),
                                __ballot_sync(0xffffffffu, wr_d),
                                __ballot_sync(0xffffffffu, wr_m)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (bits[c]) {
          if (wlo[c] == kBig) wlo[c] = jw - ja + __ffs(bits[c]) - 1;
          whi[c] = jw - ja + 31 - __clz(bits[c]);
        }
      }
    }
    stamp(kPhNext);
    if constexpr (KW) {
      // the flush of row s, from the other staging parity, which it leaves
      // zero for next() of step s + 1
      flush_row(s, fp);
      stamp(kPhFlush);
    } else {
      // aux rows are written whole: zero where no cell was written
      Dst* const rows[3] = {am_new, ai_new, ad_new};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (vec8) {
          zero_groups(rows[c], K, ja, jb, lane);
        } else {
          for (int j = lane; j < K; j += 32)
            if (j < ja || j > jb) rows[c][j] = 0;
        }
      }
      stamp(kPhTail);
    }
    __syncwarp();
    // the new bands
    const bool any_i = wlo[0] < kBig, any_d = wlo[1] < kBig;
    const bool any_m = wlo[2] < kBig;
    const int kb = k0 + ja;  // the diagonal of column ja
    bex[1] = any_i;
    blo[1] = any_i ? kb + wlo[0] : kBig;
    bhi[1] = any_i ? kb + whi[0] : -kBig;
    bex[2] = any_d;
    blo[2] = any_d ? kb + wlo[1] : kBig;
    bhi[2] = any_d ? kb + whi[1] : -kBig;
    int nlo_m = any_m ? kb + wlo[2] : kBig;
    int nhi_m = any_m ? kb + whi[2] : -kBig;
    if (ex_old) {
      nlo_m = min(nlo_m, lo_old);
      nhi_m = max(nhi_m, hi_old);
    }
    const bool keep = any_m || ex_old;
    bex[0] = keep;
    blo[0] = keep ? nlo_m : kBig;
    bhi[0] = keep ? nhi_m : -kBig;
    if (lead) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const Band& bc = c == 0 ? mb : (c == 1 ? ib : db);
        const int sl = c ? s2e : s2m;
        bc.lo[sl] = blo[c];
        bc.hi[sl] = bhi[c];
        bc.ex[sl] = bex[c];
      }
    }
    sm = s2m;
    se = s2e;
    stamp(kPhBands);
  }
  write_out();
  stamp(kPhExport);
  if constexpr (TIMED) {
    if (lead)
      for (int i = 0; i < kPhases; ++i)
        cycles[(int64_t)b * kPhases + i] = acc[i];
  }
}

// Let `Kernel` take up to `limit` bytes of dynamic shared memory, once an
// instantiation and device.
template <auto Kernel>
cudaError_t allow_shared(int64_t limit) {
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kDevices || !raised[dev])) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(limit));
    if (err == cudaSuccess && dev < kDevices) raised[dev] = true;
  }
  return err;
}

// Launch one instantiation: B pairs of CL blocks of NT threads (a cluster
// of CL blocks a pair when CL > 1, its workspace in the scratch; another
// launch is refused with cudaErrorInvalidValue).  Dynamic shared memory
// holds the reduction and band slots, and each pair's workspace when
// `win` is null (kernel_engine.workspace decides by shape, under the
// kSharedBytes a launch gets without a function attribute, or for K3 the
// kSharedOptIn it raises its limit to, once an instantiation and device);
// a launch that would need more (a workspace the caller misplaced, or band
// slots of penalties near 4000) is refused with cudaErrorInvalidValue.
// TIMED adds cycles[B, kPhases].
template <bool GLOBAL, bool REBASE, int PHASE, typename Cell,
          bool TIMED = false, int NT = kThreads, int CL = 1>
int launch_loop(const uint8_t* qb, const uint8_t* tbuf, const int32_t* qlen,
                const int32_t* tlen, const int32_t* toff, int B, int Lq,
                int Ltb, int S, int K, int x, int oe, int e, int reduce_on,
                int min_wf_len, int max_dist_diff, int32_t* win,
                int32_t* out, void* aux, int32_t* aux_base, Handoff ho,
                void* stream, long long* cycles = nullptr) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  const int win_bytes = PHASE == kPrefix ? sizeof(Cell) : 4;
  const int64_t bytes =
      shared_ints(NT * CL / 32, K, WM, WE, stage_rows<REBASE, PHASE>(),
                  win != nullptr, win_bytes) *
      (int64_t)sizeof(int);
  if (bytes > shared_limit<PHASE>() || (CL > 1 && win == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel =
      score_loop_kernel<GLOBAL, REBASE, PHASE, Cell, TIMED, NT, CL>;
  if (bytes > kSharedBytes) {
    const cudaError_t err = allow_shared<kernel>(shared_limit<PHASE>());
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0 && CL > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * CL);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e,
        reduce_on, min_wf_len, max_dist_diff, win, out,
        static_cast<Cell*>(aux), aux_base, ho, cycles);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (B > 0) {
    kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, win, out, static_cast<Cell*>(aux),
        aux_base, ho, cycles);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch the warp shape of K1-kw (KW) or K4: B pairs, `pairs` (1 to
// kWarpPairs) a block; dynamic shared memory holds each pair's band slots
// and, when `win` is null, its workspace (kernel_engine.warp_plan), under
// the kSharedOptIn it raises the limit to.  Another launch is refused with
// cudaErrorInvalidValue.  TIMED adds cycles[B, kPhases].
template <bool KW, typename Cell, bool TIMED, bool W16 = false>
int launch_warp(const uint8_t* qb, const uint8_t* tbuf, const int32_t* qlen,
                const int32_t* tlen, const int32_t* toff, int B, int Lq,
                int Ltb, int S, int K, int x, int oe, int e, int reduce_on,
                int min_wf_len, int max_dist_diff, int kw, int32_t* win,
                int32_t* out, void* aux, int32_t* aux_base, Handoff ho,
                void* stream, long long* cycles, int pairs) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  if (pairs < 1 || pairs > kWarpPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes =
      warp_shared_ints(pairs, K, WM, WE, KW ? 6 : 0, win != nullptr,
                       sizeof(WarpCell<KW, Cell, W16>)) *
      (int64_t)sizeof(int);
  if (bytes > kSharedOptIn) return static_cast<int>(cudaErrorInvalidValue);
  constexpr auto kernel = warp_loop_kernel<KW, Cell, TIMED, W16>;
  if (bytes > kSharedBytes) {
    const cudaError_t err = allow_shared<kernel>(kSharedOptIn);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B > 0)
    kernel<<<(B + pairs - 1) / pairs, 32 * pairs, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, kw, win, out, static_cast<Cell*>(aux),
        aux_base, ho, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int32 cells of one pair's workspace in `mode` (wfa_score_loop's 0-3
// and 8, 4 K3 with int32 cells, 5 K4 with int32 cells, 6 K3 with int16
// cells, 7 K4 with int16 cells) at window K, and in *shared whether it
// fits shared memory with the slots (K1, K1-semi, K1-long: in a 128-thread
// block's 48 KB; K3: with a 512-thread block's slots in kSharedOptIn; the
// warp shape of K1-kw and K4, modes 3, 5, 7 and 8: one pair's in
// kSharedOptIn, its launch then picked by kernel_engine.warp_plan): the
// layout the kernels and their
// launches use, against which kernel_engine.workspace is tested.  -1 for
// an unknown mode.
extern "C" int wfa_workspace(int K, int x, int oe, int e, int mode,
                             int* shared) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  int stage;
  switch (mode) {
    case 0: case 1: stage = stage_rows<false, kFull>(); break;
    case 2: case 3: case 8: stage = stage_rows<true, kFull>(); break;
    case 4: case 6: stage = stage_rows<false, kPrefix>(); break;
    case 5: case 7: stage = stage_rows<false, kResume>(); break;
    default: return -1;
  }
  const int wb = mode >= 6 ? 2 : 4;
  if (mode == 3 || mode == 5 || mode >= 7) {  // the warp shape
    *shared = warp_shared_ints(1, K, WM, WE, stage, false, wb) *
                  (int64_t)sizeof(int) <= kSharedOptIn;
    return static_cast<int>(warp_workspace_ints(K, WM, WE, stage, wb));
  }
  *shared = (mode == 4 || mode == 6
                 ? shared_ints(kPrefixSharedWarps, K, WM, WE, stage, false,
                               wb) *
                           (int64_t)sizeof(int) <= kSharedOptIn
                 : shared_ints(kWarps, K, WM, WE, stage, false) *
                           (int64_t)sizeof(int) <= kSharedBytes);
  return static_cast<int>(workspace_ints(K, WM, WE, stage, wb));
}

// The dynamic shared memory in bytes of a launch of K1-kw (mode 3, or 8
// with 16-bit cells) or K4 (5 with int32 cells, 7 with int16 cells) at
// window K, in the warp shape at `pairs` pairs a block, the workspace in a
// device scratch or not: what the launch asks for, or -1 where it refuses
// it (another mode, pairs outside [1, kWarpPairs], or more than a block
// may have).  kernel_engine.warp_plan is held to it.
extern "C" int wfa_warp_shared(int K, int x, int oe, int e, int mode,
                               int pairs, int scratch) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  const bool kw = mode == 3 || mode == 8, resume = mode == 5 || mode == 7;
  if (!(kw || resume) || pairs < 1 || pairs > kWarpPairs) return -1;
  const int64_t bytes =
      warp_shared_ints(pairs, K, WM, WE, kw ? stage_rows<true, kFull>() : 0,
                       scratch != 0, mode >= 7 ? 2 : 4) *
      (int64_t)sizeof(int);
  return bytes > kSharedOptIn ? -1 : static_cast<int>(bytes);
}

// K3's launch shapes built, (threads a block, blocks a pair;
// kernel_engine.PREFIX_SHAPES): 1 + the index of (threads, cluster), or 0
// for a shape not built
constexpr int kPrefixShapes[][2] = {{256, 1}, {512, 1}, {1024, 1}, {1024, 2}};
static int prefix_shape(int threads, int cluster) {
  for (int i = 0; i < 4; ++i)
    if (kPrefixShapes[i][0] == threads && kPrefixShapes[i][1] == cluster)
      return i + 1;
  return 0;
}

// K3's dynamic shared memory in bytes at window K for a block of
// `threads` in clusters of `cluster` blocks a pair, with int16 cells or
// not, its workspace in a device scratch or not: what wfa_prefix's launch
// asks for, or -1 where it refuses the launch (a shape not built, a
// cluster without the scratch, or more than a block may have).
// kernel_engine.prefix_plan is held to it.
extern "C" int wfa_prefix_shared(int K, int x, int oe, int e, int cell16,
                                 int threads, int cluster, int scratch) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  const int64_t bytes =
      shared_ints(threads * cluster / 32, K, WM, WE,
                  stage_rows<false, kPrefix>(), scratch != 0,
                  cell16 ? 2 : 4) *
      (int64_t)sizeof(int);
  if (!prefix_shape(threads, cluster) || bytes > kSharedOptIn ||
      (cluster > 1 && !scratch))
    return -1;
  return static_cast<int>(bytes);
}

// K1-kw: launch_warp with 16-bit window and staged cells (W16) or int32
// ones, TIMED for the phase profile.  A kw the TPU kernel's asserts refuse
// (pallas_engine.py:1064-1070), or 16-bit cells for a target buffer past
// kMaxLtb16 columns, is refused with cudaErrorInvalidValue.
template <bool W16, bool TIMED>
int launch_kw(const uint8_t* qb, const uint8_t* tbuf, const int32_t* qlen,
              const int32_t* tlen, const int32_t* toff, int B, int Lq,
              int Ltb, int S, int K, int x, int oe, int e, int reduce_on,
              int min_wf_len, int max_dist_diff, int kw, int pairs,
              int32_t* win, int32_t* out, void* aux, int32_t* sbase,
              void* stream, long long* cycles) {
  if (kw <= 0 || kw > K || (K - kw) / 32 > 31 || Ltb >= (1 << 26) ||
      (W16 && Ltb > kMaxLtb16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_warp<true, int16_t, TIMED, W16>(
      qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
      min_wf_len, max_dist_diff, kw, win, out, aux, sbase, Handoff{}, stream,
      cycles, pairs);
}

// out is int32[7, B]: final_s, done, overflow, term_cell, end_s, end_k,
// end_cell.  mode 0: global, int32 aux; 1: semi-global, int32 aux; 2: the
// long-read mode, global with value-rebased int16 aux and its aux_base
// int32[B, S]; 3: K1-kw, global with int16 aux [3, S, B, kw] and
// aux_base = sbase int32[S, B], in the warp shape at `pairs` pairs a
// block (kernel_engine.warp_plan) with int32 window and staged cells; 8:
// the same with 16-bit ones (a target buffer of at most kMaxLtb16
// columns).  aux_base is null in modes 0 and 1, kw and pairs are read in
// modes 3 and 8 only.  win is the int32 scratch of wfa_workspace's ints a
// pair, or null to keep the workspace in shared memory.
extern "C" int wfa_score_loop(const uint8_t* qb, const uint8_t* tbuf,
                              const int32_t* qlen, const int32_t* tlen,
                              const int32_t* toff, int B, int Lq, int Ltb,
                              int S, int K, int x, int oe, int e,
                              int reduce_on, int min_wf_len,
                              int max_dist_diff, int mode, int kw, int pairs,
                              int32_t* win, int32_t* out, void* aux,
                              int32_t* aux_base, void* stream) {
  const Handoff none{};
  if (mode == 3 || mode == 8)
    return (mode == 8 ? &launch_kw<true, false> : &launch_kw<false, false>)(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, kw, pairs, win, out, aux, aux_base, stream,
        nullptr);
  if (mode == 2)
    return launch_loop<true, true, kFull, int16_t>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, win, out, aux, aux_base, none, stream);
  if (mode == 1)
    return launch_loop<false, false, kFull, int32_t>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, win, out, aux, nullptr, none, stream);
  return launch_loop<true, false, kFull, int32_t>(
      qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
      min_wf_len, max_dist_diff, win, out, aux, nullptr, none, stream);
}

// The TIMED instantiations of modes 0 (K1), 2 (K1-long) and 8 (K1-kw with
// 16-bit cells, the phase profile's batch), for the phase profile only:
// wfa_score_loop's arguments plus cycles int64[B, kPhases] (extend,
// termination, reduce, flush, next, bands, end finder, zero tail, set-up,
// exports, the columns extend strode, steps), which the caller zeroes (a
// pair that returns before its loop writes none).
extern "C" int wfa_score_loop_phases(const uint8_t* qb, const uint8_t* tbuf,
                                     const int32_t* qlen,
                                     const int32_t* tlen,
                                     const int32_t* toff, int B, int Lq,
                                     int Ltb, int S, int K, int x, int oe,
                                     int e, int reduce_on, int min_wf_len,
                                     int max_dist_diff, int mode, int kw,
                                     int pairs, int32_t* win, int32_t* out,
                                     void* aux, int32_t* aux_base,
                                     long long* cycles, void* stream) {
  const Handoff none{};
  if (mode == 8)
    return launch_kw<true, true>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, kw, pairs, win, out, aux, aux_base, stream,
        cycles);
  if (mode == 2)
    return launch_loop<true, true, kFull, int16_t, true>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, win, out, aux, aux_base, none, stream,
        cycles);
  if (mode == 0)
    return launch_loop<true, false, kFull, int32_t, true>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, win, out, aux, nullptr, none, stream,
        cycles);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3, phase 1 of the two-phase semi-global route: scores 0 .. S0 - 1 at
// the full span Kf, aux_old[3, S0, B, Kf] (int16 cells when cell16), the
// exports of Handoff at the narrow width K2.  threads is the block width,
// cluster the blocks a pair (kernel_engine.prefix_plan; a shape not built
// is refused).  win is the int32
// scratch of workspace_ints(Kf, WM, WE, 3, cell16 ? 2 : 4) a pair (the
// windows hold the aux cell type), or null for shared memory.  cycles,
// when not null, runs the TIMED instantiation (the phase profile's
// int64[B, kPhases], zeroed by the caller).
extern "C" int wfa_prefix(const uint8_t* qb, const uint8_t* tbuf,
                          const int32_t* qlen, const int32_t* tlen,
                          const int32_t* toff, int B, int Lq, int Ltb,
                          int S0, int Kf, int K2, int x, int oe, int e,
                          int reduce_on, int min_wf_len, int max_dist_diff,
                          int cell16, int threads, int cluster, int32_t* win,
                          void* aux_old, int32_t* win_m, int32_t* win_i,
                          int32_t* win_d, int32_t* ainit, int32_t* b_m,
                          int32_t* b_ie, int32_t* meta1, long long* cycles,
                          void* stream) {
  const Handoff ho{win_m, win_i, win_d, ainit, b_m, b_ie, meta1, S0, K2};
  const int w = prefix_shape(threads, cluster);
  if (!w) return static_cast<int>(cudaErrorInvalidValue);
  using Launch = decltype(&launch_loop<false, false, kPrefix, int16_t>);
  // [cell16][shape], the shapes of kPrefixShapes
#define WFA_K3(C)                                              \
  {&launch_loop<false, false, kPrefix, C, false, 256>,         \
   &launch_loop<false, false, kPrefix, C, false, 512>,         \
   &launch_loop<false, false, kPrefix, C, false, 1024>,        \
   &launch_loop<false, false, kPrefix, C, false, 1024, 2>}
  static const Launch table[2][4] = {WFA_K3(int32_t), WFA_K3(int16_t)};
#undef WFA_K3
  Launch run = table[cell16 != 0][w - 1];
  if (cycles != nullptr) {
    // the TIMED instantiations at the phase profile's two plans only
    // (profiling.SEMI2_BATCHES: int16 cells in 256-thread blocks at Kf
    // 2048, int32 cells in clusters of two 1024-thread blocks at Kf
    // 20,096), so that no other build pays for them; another is refused
    if (cell16 && threads == 256 && cluster == 1)
      run = &launch_loop<false, false, kPrefix, int16_t, true, 256>;
    else if (!cell16 && threads == 1024 && cluster == 2)
      run = &launch_loop<false, false, kPrefix, int32_t, true, 1024, 2>;
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S0 + 1, Kf, x, oe, e,
             reduce_on, min_wf_len, max_dist_diff, win, nullptr, aux_old,
             nullptr, ho, stream, cycles);
}

// K4, phase 2: resumes at S0 from the Handoff exports (width K) and runs
// to S - 1 in the narrow window of origin -toff2; aux2[3, S - S0, B, K]
// (int16 cells when cell16); out as wfa_score_loop's.  In the warp shape
// at `pairs` pairs a block (kernel_engine.warp_plan), its window cells
// int16 when cell16.  win is the int32 scratch of wfa_workspace's ints a
// pair (mode 7 when cell16, else 5), or null for shared memory.  cycles,
// when not null, runs the TIMED instantiation (the phase profile's
// int64[B, kPhases], zeroed by the caller).
extern "C" int wfa_resume(const uint8_t* qb, const uint8_t* tbuf2,
                          const int32_t* qlen, const int32_t* tlen,
                          const int32_t* toff2, int B, int Lq, int Ltb2,
                          int S, int S0, int K, int x, int oe, int e,
                          int reduce_on, int min_wf_len, int max_dist_diff,
                          int cell16, int pairs, int32_t* win, int32_t* out,
                          void* aux2, int32_t* win_m, int32_t* win_i,
                          int32_t* win_d, int32_t* ainit, int32_t* b_m,
                          int32_t* b_ie, int32_t* meta1, long long* cycles,
                          void* stream) {
  const Handoff ho{win_m, win_i, win_d, ainit, b_m, b_ie, meta1, S0, K};
  using Warp = decltype(&launch_warp<false, int16_t, false>);
  // [cell16][TIMED]
  static const Warp warp[2][2] = {
      {&launch_warp<false, int32_t, false>, &launch_warp<false, int32_t, true>},
      {&launch_warp<false, int16_t, false>,
       &launch_warp<false, int16_t, true>}};
  return warp[cell16 != 0][cycles != nullptr](
      qb, tbuf2, qlen, tlen, toff2, B, Lq, Ltb2, S, K, x, oe, e, reduce_on,
      min_wf_len, max_dist_diff, K, win, out, aux2, nullptr, ho, stream,
      cycles, pairs);
}
