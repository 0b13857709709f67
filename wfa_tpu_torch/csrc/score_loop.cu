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
//  * One block per pair.  Threads stride over the K diagonals; band
//    bounds, dmin, first_good / last_mark / last_good and the Ak cell
//    come from block reductions.  With no shared table window every
//    pair's result is independent of the rest of the batch, so a
//    per-pair loop is exact (the lockstep engine stops a pair at done or
//    overflow too).
//  * Extension compares the sequence bytes directly, q[v+i] == t[h+i]
//    within v < qlen, h < tlen, like the reference's LCP walk
//    (wfa.go:411-435).  The TPU's stop tables exist because gathers are
//    slow there; the plain version keeps them, so the two check each
//    other.
//  * The circular wavefront windows (WM = max(x, o+e) + 1 rows of M,
//    WE = e + 1 rows each of I and D) live in a global scratch tensor,
//    which serves any K; the band slots live in shared memory.
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
// staged as int32 in the per-pair scratch (3 K more ints), zeroed where
// the reduce zeroes, and written rebased after that reduce; the
// terminating row unreduced, at the break, as the TPU kernel streams it.
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
// K1-kw (REBASE and KWIN, global only): the port of the TPU kernel
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
// The rows it writes are kw / K of K1's and half their width, but the
// per-step chain is K1-long's, with the same block reductions.
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
//    step S0 - 1 writes is staged in the pair's scratch.  At exit the
//    kernel computes meta1 (done, final_s, term_cell, the end finder's
//    raw state, overflow2, k02: wfa_tpu/semi2.py:48-52, 182-206) from the
//    band union of every slot next() can still read plus Ak, and writes
//    the window rows, ainit and the band slots ALREADY REBASED to the
//    narrow window of origin k02 and width K2, in JAX's slot order (slot r
//    holds the score in (S0 - W, S0] congruent to r mod W, which is where
//    the circular windows keep it), so no gather pass follows.
//  * K4, the resume (PHASE = kResume): replaces pallas_engine.py::_kernel
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
// What bounds it: each step is a short chain of dependent L1/L2 reads
// and block barriers per pair; K = 128 diagonals give one cell per
// thread, and 2048 pairs fill the card's 132 SMs with ~16 blocks each.
// Semi-global windows are the full span (K = 2048 at l = 1000), and every
// pass strides over all K columns even after the band has collapsed to
// tens of diagonals: the whole-window aux rows and window passes are its
// cost.  K3 strides the full span (Kf = 20,096 at l = 10000) for only
// S0 = 64 steps, K4 the narrow window (256 or 512).  Long reads: at
// l = 50000, e = 0.05 (s_cap ~27,520 at tier 0,
// K = 384, final_s ~14,500) each pair is a serial chain of ~14,500 steps of
// block barriers; the aux rows, 6 B x 14,500 x 384 x 64 pairs ~ 2.1 GB,
// take ~0.64 ms at 3.35 TB/s, so the chain latency, not memory, sets the
// time, and a 64-pair batch fills only 64 of the 132 SMs.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kInsOpen = 1, kInsExt = 2, kDelOpen = 3, kDelExt = 4;
constexpr int kMismatch = 5, kMatch = 6;
constexpr int kMaxRebased = 4095;  // (v << 3) | tag must fit int16
// score-loop phases: the whole run, or phase 1 / phase 2 of the two-phase
// semi-global route
constexpr int kFull = 0, kPrefix = 1, kResume = 2;
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

// Block-wide minimum of N values at once (a maximum passes its negation;
// all values lie in [-kBig, kBig]).  Every thread gets the results.
template <int N>
__device__ __forceinline__ void block_min(int (&v)[N], int* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] = min(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int m = red[i * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = min(m, red[i * kWarps + w]);
    v[i] = m;
  }
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
__device__ __forceinline__ bool src(const int32_t* row, bool present, int lo,
                                    int hi, int k0, int K, int jj, int& val) {
  val = 0;
  if (!present || jj < 0 || jj >= K) return false;
  int kk = k0 + jj;
  int c = row[jj];
  if (kk < lo || kk > hi || c <= 0) return false;
  val = c >> 3;
  return true;
}

// Cell: int32 aux cells, the value-rebased int16 cells of REBASE mode, or
// the int16 cells of a two-phase semi-global phase whose offsets fit them.
// KWIN (with REBASE): K1-kw's aux rows kw columns wide, and aux_base is
// sbase[S, B] instead of the long-read mode's aux_base[B, S].
template <bool GLOBAL, bool REBASE, int PHASE, typename Cell,
          bool KWIN = false>
__global__ void __launch_bounds__(kThreads) score_loop_kernel(
    const uint8_t* __restrict__ qb, const uint8_t* __restrict__ tbuf,
    const int32_t* __restrict__ qlen, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ toff, int B, int Lq, int Ltb, int S, int K,
    int x, int oe, int e, int reduce_on, int min_wf_len, int max_dist_diff,
    int kw, int32_t* __restrict__ win, int32_t* __restrict__ out,
    Cell* __restrict__ aux, int32_t* __restrict__ aux_base, Handoff ho) {
  static_assert(GLOBAL || !REBASE, "the long-read mode is global only");
  static_assert(!KWIN || REBASE, "the row window rides the rebased staging");
  static_assert(PHASE == kFull || (!GLOBAL && !REBASE),
                "the two-phase route is semi-global");
  // staged aux rows in the pair's scratch: REBASE's newest rows, or the
  // prefix's aux row S0 (ainit)
  constexpr bool kStage = REBASE || PHASE == kPrefix;
  using Dst = std::conditional_t<REBASE, int32_t, Cell>;
  const int S0 = PHASE == kFull ? 0 : ho.S0;
  // aux rows held and the score of the first: S rows, the prefix's S0,
  // the resume's S - S0 from score S0
  const int Sa = PHASE == kFull ? S : (PHASE == kPrefix ? S0 : S - S0);
  const int s_lo = PHASE == kResume ? S0 : 0;
  const int KA = KWIN ? kw : K;  // aux columns a row
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int WM = max(x, oe) + 1, WE = e + 1;
  extern __shared__ int smem[];
  int* red = smem;  // 8 * kWarps reduction slots
  Band mb{smem + 8 * kWarps, smem + 8 * kWarps + WM,
          smem + 8 * kWarps + 2 * WM};
  int* base_ie = smem + 8 * kWarps + 3 * WM;
  Band ib{base_ie, base_ie + WE, base_ie + 2 * WE};
  Band db{base_ie + 3 * WE, base_ie + 4 * WE, base_ie + 5 * WE};
  __shared__ int sh_cell_ak;

  const int ql = qlen[b], tl = tlen[b], tof = toff[b];
  const int k0 = -tof, Ak = tl - ql, jak = Ak - k0;
  // per-pair scratch: the windows, then the three staged rows
  int32_t* Mw = win + (int64_t)b * (WM + 2 * WE + (kStage ? 3 : 0)) * K;
  int32_t* Iw = Mw + (int64_t)WM * K;
  int32_t* Dw = Iw + (int64_t)WE * K;
  auto aux_row = [&](int comp, int s) {
    return aux + ((int64_t)(comp * Sa + s - s_lo) * B + b) * KA;
  };
  // where seeding, reduce and next put a row's aux: the output row, in
  // REBASE mode the int32 staging rows after the I and D windows, and for
  // the prefix's row S0 the same staging rows, holding Cell values
  int32_t* stage = Dw + (int64_t)WE * K;
  auto aux_dst = [&](int comp, int s) -> Dst* {
    if constexpr (REBASE) {
      return stage + (int64_t)comp * K;
    } else {
      if (PHASE == kPrefix && s == S0)
        return reinterpret_cast<Cell*>(stage + (int64_t)comp * K);
      return aux_row(comp, s);
    }
  };
  // REBASE: write the staged row s rebased (KWIN: its kw-column window);
  // false when a value is too wide for the int16 cell (KWIN: or the band
  // passes the window)
  auto flush = [&](int s) {
    int r[2] = {kBig, kBig};  // min offset0, -max offset0 of found cells
    for (int j = tid; j < K; j += kThreads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int cell = stage[c * K + j];
        if (cell > 0) {
          r[0] = min(r[0], cell >> 3);
          r[1] = min(r[1], -(cell >> 3));
        }
      }
    }
    block_min(r, red);
    int base = r[0] < kBig ? r[0] : 0;
    bool fits = r[0] == kBig || -r[1] - base + 1 <= kMaxRebased;
    int cb = 0;  // KWIN: the window's first column / 32
    if constexpr (KWIN) {
      // the post-reduce band union of score s (every thread reads the
      // same slots)
      const int sm = s % WM, se = s % WE;
      int lo_u = kBig, hi_u = -kBig;
      bool anyb = false;
      const Band* bands[3] = {&mb, &ib, &db};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int sl = c ? se : sm;
        if (bands[c]->ex[sl]) {
          lo_u = min(lo_u, bands[c]->lo[sl]);
          hi_u = max(hi_u, bands[c]->hi[sl]);
          anyb = true;
        }
      }
      // C++ division truncates toward zero, as lax.div does
      if (anyb) cb = min(max((lo_u - k0) / 32, 0), (K - kw) / 32);
      base = max(base, 0);
      const int vmx = r[1] < kBig ? -r[1] : -kBig;
      fits = !anyb ||
             (hi_u - k0 - cb * 32 < kw && vmx - base + 1 <= kMaxRebased);
    }
    const int c0 = cb * 32;
    for (int j = tid; j < KA; j += kThreads) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int cell = stage[c * K + c0 + j];
        aux_row(c, s)[j] = static_cast<Cell>(
            cell > 0 ? (((cell >> 3) - base + 1) << 3) | (cell & 7) : 0);
      }
    }
    if (tid == 0) {
      if constexpr (KWIN) {
        aux_base[(int64_t)s * B + b] = (base << 5) | cb;
      } else {
        aux_base[(int64_t)b * S + s] = base;
      }
    }
    // KWIN: a thread read stage columns that another thread's next() is
    // about to overwrite
    if constexpr (KWIN) __syncthreads();
    return fits;
  };

  // the window must hold the seed diagonals and the terminal one; the
  // resume's holds the terminal one, and meta1 says who escaped phase 1
  const int32_t* m1 =
      PHASE == kResume ? ho.meta1 + (int64_t)b * kM1Cols : nullptr;
  bool overflow;
  if (PHASE == kResume) {
    overflow = m1[kM1Ovf] != 0 || Ak < k0 || Ak >= k0 + K;
  } else {
    overflow = Ak < k0 || Ak >= k0 + K || 0 < k0 || 0 >= k0 + K;
    if (!GLOBAL) overflow = overflow || tl - 1 >= k0 + K;
  }
  const uint8_t* q = qb + (int64_t)b * Lq;
  const uint8_t* t = tbuf + (int64_t)b * Ltb + tof;  // t[h], valid if !overflow
  bool done = false;
  int final_s = 0, term_cell = 0;
  // semi-global end finder: the first success over ascending s
  bool end_found = false;
  int end_s = 0, end_k = 0, end_cell = 0;
  if (PHASE == kResume) {  // phase 1's results and end-finder state
    done = m1[kM1Done] != 0;
    final_s = m1[kM1Fs];
    term_cell = m1[kM1Term];
    end_found = m1[kM1EFound] != 0;
    end_s = m1[kM1Es];
    end_k = m1[kM1Ek];
    end_cell = m1[kM1ECell];
  }
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
  if (overflow || (PHASE == kResume && done)) {
    write_out();
    write_meta1(-(ql - 1), true);
    return;
  }

  if constexpr (PHASE == kResume) {
    // ---- the phase-1 handoff: window rows, band slots, aux row S0
    for (int r = 0; r < WM; ++r)
      for (int j = tid; j < K; j += kThreads)
        Mw[r * K + j] = ho.win_m[((int64_t)r * B + b) * K + j];
    for (int r = 0; r < WE; ++r)
      for (int j = tid; j < K; j += kThreads) {
        Iw[r * K + j] = ho.win_i[((int64_t)r * B + b) * K + j];
        Dw[r * K + j] = ho.win_d[((int64_t)r * B + b) * K + j];
      }
    for (int c = 0; c < 3; ++c)
      for (int j = tid; j < K; j += kThreads)
        aux_row(c, S0)[j] =
            static_cast<Cell>(ho.ainit[((int64_t)c * B + b) * K + j]);
    if (tid == 0) {
      for (int r = 0; r < WM; ++r) {
        mb.lo[r] = ho.b_m[(int64_t)r * B + b];
        mb.hi[r] = ho.b_m[(int64_t)(WM + r) * B + b];
        mb.ex[r] = ho.b_m[(int64_t)(2 * WM + r) * B + b];
      }
      const Band* cb[2] = {&ib, &db};
      for (int c = 0; c < 2; ++c)
        for (int r = 0; r < WE; ++r) {
          const int32_t* src_b = ho.b_ie + (int64_t)(3 * c * WE + r) * B + b;
          cb[c]->lo[r] = src_b[0];
          cb[c]->hi[r] = src_b[(int64_t)WE * B];
          cb[c]->ex[r] = src_b[(int64_t)2 * WE * B];
        }
    }
    __syncthreads();
  } else {
    for (int i = tid; i < WM * K; i += kThreads) Mw[i] = 0;
    for (int i = tid; i < WE * K; i += kThreads) Iw[i] = Dw[i] = 0;
    if (kStage)
      for (int i = tid; i < 3 * K; i += kThreads) stage[i] = 0;
    __syncthreads();
    if constexpr (GLOBAL) {
      // ---- seeding (wfa.go:143-184): one cell, diagonal 0 at offset 1
      const int j0 = -k0;
      const int cell0 = (1 << 3) | (eq00 ? kMatch : kMismatch);
      const int seed_row = (eq00 || x == 0) ? 0 : x;
      if (tid == 0) {
        Mw[seed_row * K + j0] = cell0;
        for (int r = 0; r < WM; ++r) {
          mb.lo[r] = r == seed_row ? 0 : kBig;
          mb.hi[r] = r == seed_row ? 0 : -kBig;
          mb.ex[r] = r == seed_row;
        }
      }
      // aux row 0: seed cells have no sources, so their aux is the tag bits
      for (int j = tid; j < K; j += kThreads) {
        aux_dst(0, 0)[j] = (seed_row == 0 && j == j0) ? (cell0 & 7) : 0;
        aux_dst(1, 0)[j] = 0;
        aux_dst(2, 0)[j] = 0;
      }
    } else {
      // ---- semi-global seeding (wfa.go:163-183): k in [-(qlen-1), tlen-1],
      // k >= 0 at offset k+1 from q[0] == t[k], k < 0 at offset 1 from
      // q[-k] == t[0]; match seeds in row 0, mismatch seeds in row x
      int rs[4] = {kBig, kBig, kBig, kBig};  // min k, -max k of rows 0, x
      for (int j = tid; j < K; j += kThreads) {
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
      block_min(rs, red);
      // a mismatch seed beyond the score cap can never be reached
      if (x >= S && rs[2] < kBig) {
        overflow = true;
        write_out();
        write_meta1(-(ql - 1), true);
        return;
      }
      if (tid == 0) {
        for (int r = 0; r < WM; ++r) {
          const int i = r == 0 ? 0 : (r == x ? 2 : -1);
          const bool ex = i >= 0 && rs[i] < kBig;
          mb.lo[r] = ex ? rs[i] : kBig;
          mb.hi[r] = ex ? -rs[i + 1] : -kBig;
          mb.ex[r] = ex;
        }
      }
    }
    if (tid == 0) {
      for (int r = 0; r < WE; ++r) {
        ib.lo[r] = db.lo[r] = kBig;
        ib.hi[r] = db.hi[r] = -kBig;
        ib.ex[r] = db.ex[r] = 0;
      }
    }
    __syncthreads();
  }  // seeding

  // the nearest stop cell on each side of Ak in an M row (wfa.go:270-375):
  // the largest 2j + succ at k <= Ak and the smallest 2j + !succ above it
  auto find_end = [&](int s, const int32_t* row) {
    int r2[2] = {kBig, kBig};  // -(2 j_dn + succ_dn), 2 j_up + !succ_up
    for (int j = tid; j < K; j += kThreads) {
      const int cell = row[j];
      if (cell <= 0) continue;
      const int k = k0 + j, h = cell >> 3, v = h - k;
      const bool viol = v <= 0 || v > ql || h > tl;
      const bool elig = (v == ql && h >= ql) || (h == tl && v >= tl);
      if (!viol && !elig) continue;
      if (k <= Ak) r2[0] = min(r2[0], -(2 * j + !viol));
      else r2[1] = min(r2[1], 2 * j + viol);
    }
    block_min(r2, red);
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

  for (int s = s_lo; s < S - 1; ++s) {
    const int sm = s % WM, se = s % WE;
    const int lo_ms = mb.lo[sm], hi_ms = mb.hi[sm];
    const bool ex_ms = mb.ex[sm] != 0;
    int32_t* row_m = Mw + (int64_t)sm * K;

    // ---------------- extend (wfa.go:381-458) ----------------
    for (int j = tid; j < K; j += kThreads) {
      int cell = row_m[j];
      int k = k0 + j;
      if (ex_ms && cell > 0 && k >= lo_ms && k <= hi_ms) {
        int h0 = cell >> 3, v0 = h0 - k;
        if (v0 > 0 && v0 < ql && h0 < tl) {
          int lim = min(ql - v0, tl - h0);
          int n = 0;
          while (n < lim && q[v0 + n] == t[h0 + n]) ++n;
          if (n > 0) {
            cell += n << 3;
            row_m[j] = cell;
          }
        }
      }
      if (j == jak) sh_cell_ak = cell;
    }
    __syncthreads();

    // ---------------- termination (wfa.go:235-239) ----------------
    const int cell_ak = sh_cell_ak;
    if (ex_ms && Ak >= lo_ms && Ak <= hi_ms && cell_ak > 0 &&
        (cell_ak >> 3) >= tl) {
      done = true;
      final_s = s;
      term_cell = cell_ak;
      // the terminating row is searched unreduced
      if (!GLOBAL && !end_found) find_end(s, row_m);
      // and streamed unreduced.  A row that does not fit overflows the
      // pair; K1-long reports it not done, K1-kw keeps done, final_s and
      // term_cell as the TPU kernel keeps them (see the header)
      if (REBASE && !flush(s)) {
        overflow = true;
        if (!KWIN) {
          done = false;
          final_s = term_cell = 0;
        }
      }
      break;
    }

    // ---------------- reduce (wfa.go:461-540) ----------------
    if (reduce_on && ex_ms && hi_ms - lo_ms + 1 >= min_wf_len) {
      // dmin over the in-bounds cells
      int r1[1] = {kBig};
      for (int j = tid; j < K; j += kThreads) {
        int cell = row_m[j], k = k0 + j;
        int hs = cell >> 3, vs = hs - k;
        if (cell > 0 && k >= lo_ms && k <= hi_ms && vs >= 0 && vs < ql &&
            hs < tl)
          r1[0] = min(r1[0], max(tl - hs, ql - vs));
      }
      block_min(r1, red);
      const int dmin = r1[0];
      // marked cells lag dmin by more than max_dist_diff
      auto classify = [&](int j, bool& marked, bool& good) {
        int cell = row_m[j], k = k0 + j;
        int hs = cell >> 3, vs = hs - k;
        bool okd = cell > 0 && k >= lo_ms && k <= hi_ms && vs >= 0 &&
                   vs < ql && hs < tl;
        int dist = max(tl - hs, ql - vs);
        marked = okd && dist - dmin > max_dist_diff;
        good = okd && !marked;
      };
      int r3[3] = {kBig, kBig, kBig};  // first_good, -last_good, -any_marked
      for (int j = tid; j < K; j += kThreads) {
        bool marked, good;
        classify(j, marked, good);
        if (good) {
          r3[0] = min(r3[0], j);
          r3[1] = min(r3[1], -j);
        }
        if (marked) r3[2] = -1;
      }
      block_min(r3, red);
      const int first_good = r3[0];
      const int last_good = r3[1] == kBig ? -kBig : -r3[1];
      const bool any_good = first_good < kBig, any_marked = r3[2] == -1;
      int r4[1] = {kBig};  // -last_mark below first_good
      for (int j = tid; j < K && j < first_good; j += kThreads) {
        bool marked, good;
        classify(j, marked, good);
        if (marked) r4[0] = min(r4[0], -j);
      }
      block_min(r4, red);
      const int new_lo = r4[0] < kBig ? k0 - r4[0] + 1 : lo_ms;
      const int new_hi = (any_marked && any_good) ? k0 + last_good : hi_ms;

      // co-deletion from I and D (wfa.go:526-535): two ascending Delete
      // sweeps, [lo, new_lo) then (new_hi, hi]
      int nlo[2], nhi[2], z[2][4];
      bool gate[2];
      Band cb[2] = {ib, db};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gate[c] = cb[c].ex[se] != 0;
        int l1, h1;
        delete_range_asc(lo_ms, new_lo - 1, cb[c].lo[se], cb[c].hi[se], l1,
                         h1, z[c][0], z[c][1]);
        delete_range_asc(new_hi + 1, hi_ms, l1, h1, nlo[c], nhi[c], z[c][2],
                         z[c][3]);
      }
      Dst* aux_m = aux_dst(0, s);
      for (int j = tid; j < K; j += kThreads) {
        int k = k0 + j;
        int cell = row_m[j];
        if (cell > 0 && k >= lo_ms && k <= hi_ms && (k < new_lo || k > new_hi)) {
          row_m[j] = 0;
          aux_m[j] = 0;  // aux mirrors cell existence
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (gate[c] && ((k >= z[c][0] && k <= z[c][1]) ||
                          (k >= z[c][2] && k <= z[c][3]))) {
            (c == 0 ? Iw : Dw)[(int64_t)se * K + j] = 0;
            aux_dst(1 + c, s)[j] = 0;
          }
        }
      }
      __syncthreads();  // every thread has read the band slots
      if (tid == 0) {
        mb.lo[sm] = new_lo;
        mb.hi[sm] = new_hi;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (gate[c]) {
            cb[c].lo[se] = nlo[c];
            cb[c].hi[se] = nhi[c];
          }
        }
      }
      __syncthreads();
    }

    if (!GLOBAL && !end_found) find_end(s, row_m);
    // row s is final: stream it rebased
    if (REBASE && !flush(s)) {
      overflow = true;
      break;
    }

    // ---------------- next (wfa.go:549-700) ----------------
    const int s2 = s + 1;
    // KRange of each source with the reference's (0, 0) fallback
    // (wfa_component.go:91); a zero penalty step reads the row being
    // written, which does not exist yet
    const bool p_x = x >= 1 && x <= s2 && mb.ex[(s2 - x) % WM];
    const bool p_o = oe >= 1 && oe <= s2 && mb.ex[(s2 - oe) % WM];
    const bool p_i = e >= 1 && e <= s2 && ib.ex[(s2 - e) % WE];
    const bool p_d = e >= 1 && e <= s2 && db.ex[(s2 - e) % WE];
    const int sx = p_x ? (s2 - x) % WM : 0, so = p_o ? (s2 - oe) % WM : 0;
    const int sie = p_i ? (s2 - e) % WE : 0, sde = p_d ? (s2 - e) % WE : 0;
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
    const int32_t* mo_row = Mw + (int64_t)so * K;
    const int32_t* mx_row = Mw + (int64_t)sx * K;
    const int32_t* ie_row = Iw + (int64_t)sie * K;
    const int32_t* de_row = Dw + (int64_t)sde * K;
    const int s2m = s2 % WM, s2e = s2 % WE;
    const bool at_seed = x > 0 && s2 == x;  // the seed row x pre-exists
    int32_t* m_new = Mw + (int64_t)s2m * K;
    int32_t* i_new = Iw + (int64_t)s2e * K;
    int32_t* d_new = Dw + (int64_t)s2e * K;
    Dst* am_new = aux_dst(0, s2);
    Dst* ai_new = aux_dst(1, s2);
    Dst* ad_new = aux_dst(2, s2);
    // band reductions: min k and -max k of the written I, D, M cells
    int rb[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
    for (int j = tid; j < K; j += kThreads) {
      const int k = k0 + j;
      // insertion (wfa.go:578-608): sources at k-1
      int v1i, v2i;
      bool fmi = src(mo_row, p_o, mb.lo[so], mb.hi[so], k0, K, j - 1, v1i);
      bool fii = src(ie_row, p_i, ib.lo[sie], ib.hi[sie], k0, K, j - 1, v2i);
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
      bool fmd = src(mo_row, p_o, mb.lo[so], mb.hi[so], k0, K, j + 1, v1d);
      bool fdd = src(de_row, p_d, db.lo[sde], db.hi[sde], k0, K, j + 1, v2d);
      const int dsk_nb = (fmd || fdd) ? max(v1d, v2d) : 0;
      const bool any_id_nb = fmi || fii || fmd || fdd;
      if (fmd && v1d - k > ql) fmd = false, v1d = 0;
      if (fdd && v2d - k > ql) fdd = false, v2d = 0;
      const int Dsk = max(v1d, v2d);
      const bool upd_d = fmd || fdd;
      const int tag_d = (fmd && v1d >= v2d) ? kDelOpen : kDelExt;
      // mismatch / M with the reference tie-breaking (wfa.go:648-698)
      int v1x;
      bool fmx = src(mx_row, p_x, mb.lo[sx], mb.hi[sx], k0, K, j, v1x);
      const int off_def_nb =
          (any_id_nb || fmx) ? max(max(isk_nb, dsk_nb), v1x + 1) : 0;
      if (fmx && (v1x > tl || v1x - k > ql)) fmx = false, v1x = 0;
      const int Msk = max(max(upd_i ? Isk : 0, upd_d ? Dsk : 0), v1x + 1);
      const int tag_m = (fmx && Msk == v1x + 1)
                            ? kMismatch
                            : ((upd_i && Msk == Isk) ? tag_i : tag_d);
      const bool band = k >= lo_n && k <= hi_n;
      const bool wr_i = upd_i && band, wr_d = upd_d && band;
      const bool wr_m = (upd_i || upd_d || fmx) && band;
      // aux: each cell's backtrace branch is selected by its own tag
      const int aux_m_val = tag_m == kInsExt
                                ? isk_nb
                                : (tag_m == kDelExt ? dsk_nb : off_def_nb);
      const int row_m_old = at_seed ? m_new[j] : 0;
      i_new[j] = wr_i ? (Isk << 3) | tag_i : 0;
      d_new[j] = wr_d ? (Dsk << 3) | tag_d : 0;
      m_new[j] = wr_m ? (Msk << 3) | tag_m : row_m_old;
      ai_new[j] = wr_i ? ((tag_i == kInsExt ? isk_nb : off_def_nb) << 3) | tag_i
                       : 0;
      ad_new[j] = wr_d ? ((tag_d == kDelExt ? dsk_nb : off_def_nb) << 3) | tag_d
                       : 0;
      am_new[j] = wr_m ? (aux_m_val << 3) | tag_m : (row_m_old & 7);
      if (wr_i) rb[0] = min(rb[0], k), rb[1] = min(rb[1], -k);
      if (wr_d) rb[2] = min(rb[2], k), rb[3] = min(rb[3], -k);
      if (wr_m) rb[4] = min(rb[4], k), rb[5] = min(rb[5], -k);
    }
    block_min(rb, red);
    if (tid == 0) {
      const bool any_i = rb[0] < kBig, any_d = rb[2] < kBig;
      const bool any_m = rb[4] < kBig;
      ib.lo[s2e] = any_i ? rb[0] : kBig;
      ib.hi[s2e] = any_i ? -rb[1] : -kBig;
      ib.ex[s2e] = any_i;
      db.lo[s2e] = any_d ? rb[2] : kBig;
      db.hi[s2e] = any_d ? -rb[3] : -kBig;
      db.ex[s2e] = any_d;
      const bool ex_old = at_seed && mb.ex[s2m] != 0;
      int lo_m = any_m ? rb[4] : kBig, hi_m = any_m ? -rb[5] : -kBig;
      if (ex_old) {
        lo_m = min(lo_m, mb.lo[s2m]);
        hi_m = max(hi_m, mb.hi[s2m]);
      }
      const bool keep = any_m || ex_old;
      mb.lo[s2m] = keep ? lo_m : kBig;
      mb.hi[s2m] = keep ? hi_m : -kBig;
      mb.ex[s2m] = keep;
    }
    __syncthreads();
  }

  if constexpr (PHASE == kPrefix) {
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
    auto rebased = [&](const int32_t* row, int j) {
      return j + d < K ? row[j + d] : 0;
    };
    for (int r = 0; r < WM; ++r)
      for (int j = tid; j < K2; j += kThreads)
        ho.win_m[((int64_t)r * B + b) * K2 + j] = rebased(Mw + r * K, j);
    for (int r = 0; r < WE; ++r)
      for (int j = tid; j < K2; j += kThreads) {
        ho.win_i[((int64_t)r * B + b) * K2 + j] = rebased(Iw + r * K, j);
        ho.win_d[((int64_t)r * B + b) * K2 + j] = rebased(Dw + r * K, j);
      }
    for (int c = 0; c < 3; ++c) {
      const Cell* row = reinterpret_cast<const Cell*>(stage + (int64_t)c * K);
      for (int j = tid; j < K2; j += kThreads)
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
}

// Launch one instantiation: B blocks of kThreads, dynamic shared memory
// for the reduction and band slots.  Over the 48 KB default (penalties
// near 4000) the launch fails and the error is returned.
template <bool GLOBAL, bool REBASE, int PHASE, typename Cell,
          bool KWIN = false>
int launch_loop(const uint8_t* qb, const uint8_t* tbuf, const int32_t* qlen,
                const int32_t* tlen, const int32_t* toff, int B, int Lq,
                int Ltb, int S, int K, int x, int oe, int e, int reduce_on,
                int min_wf_len, int max_dist_diff, int kw, int32_t* win,
                int32_t* out, void* aux, int32_t* aux_base, Handoff ho,
                void* stream) {
  const int WM = (x > oe ? x : oe) + 1, WE = e + 1;
  const int smem = (8 * kWarps + 3 * WM + 6 * WE) * (int)sizeof(int);
  if (B > 0)
    score_loop_kernel<GLOBAL, REBASE, PHASE, Cell, KWIN>
        <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e,
            reduce_on, min_wf_len, max_dist_diff, kw, win, out,
            static_cast<Cell*>(aux), aux_base, ho);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is int32[7, B]: final_s, done, overflow, term_cell, end_s, end_k,
// end_cell.  mode 0: global, int32 aux; 1: semi-global, int32 aux; 2: the
// long-read mode, global with value-rebased int16 aux and its aux_base
// int32[B, S]; 3: K1-kw, global with int16 aux [3, S, B, kw] and
// aux_base = sbase int32[S, B].  aux_base is null in modes 0 and 1, kw
// is read in mode 3 only; a kw the TPU kernel's asserts refuse
// (pallas_engine.py:1064-1070) returns cudaErrorInvalidValue.
extern "C" int wfa_score_loop(const uint8_t* qb, const uint8_t* tbuf,
                              const int32_t* qlen, const int32_t* tlen,
                              const int32_t* toff, int B, int Lq, int Ltb,
                              int S, int K, int x, int oe, int e,
                              int reduce_on, int min_wf_len,
                              int max_dist_diff, int mode, int kw,
                              int32_t* win, int32_t* out, void* aux,
                              int32_t* aux_base, void* stream) {
  const Handoff none{};
  if (mode == 3) {
    if (kw <= 0 || kw > K || (K - kw) / 32 > 31 || Ltb >= (1 << 26))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_loop<true, true, kFull, int16_t, true>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, kw, win, out, aux, aux_base, none,
        stream);
  }
  if (mode == 2)
    return launch_loop<true, true, kFull, int16_t>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, K, win, out, aux, aux_base, none, stream);
  if (mode == 1)
    return launch_loop<false, false, kFull, int32_t>(
        qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
        min_wf_len, max_dist_diff, K, win, out, aux, nullptr, none, stream);
  return launch_loop<true, false, kFull, int32_t>(
      qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S, K, x, oe, e, reduce_on,
      min_wf_len, max_dist_diff, K, win, out, aux, nullptr, none, stream);
}

// K3, phase 1 of the two-phase semi-global route: scores 0 .. S0 - 1 at
// the full span Kf, aux_old[3, S0, B, Kf] (int16 cells when cell16), the
// exports of Handoff at the narrow width K2.  win is the int32 scratch,
// (WM + 2 WE + 3) * Kf a pair.
extern "C" int wfa_prefix(const uint8_t* qb, const uint8_t* tbuf,
                          const int32_t* qlen, const int32_t* tlen,
                          const int32_t* toff, int B, int Lq, int Ltb,
                          int S0, int Kf, int K2, int x, int oe, int e,
                          int reduce_on, int min_wf_len, int max_dist_diff,
                          int cell16, int32_t* win, void* aux_old,
                          int32_t* win_m, int32_t* win_i, int32_t* win_d,
                          int32_t* ainit, int32_t* b_m, int32_t* b_ie,
                          int32_t* meta1, void* stream) {
  const Handoff ho{win_m, win_i, win_d, ainit, b_m, b_ie, meta1, S0, K2};
  auto run = cell16 ? &launch_loop<false, false, kPrefix, int16_t>
                    : &launch_loop<false, false, kPrefix, int32_t>;
  return run(qb, tbuf, qlen, tlen, toff, B, Lq, Ltb, S0 + 1, Kf, x, oe, e,
             reduce_on, min_wf_len, max_dist_diff, Kf, win, nullptr, aux_old,
             nullptr, ho, stream);
}

// K4, phase 2: resumes at S0 from the Handoff exports (width K) and runs
// to S - 1 in the narrow window of origin -toff2; aux2[3, S - S0, B, K]
// (int16 cells when cell16); out as wfa_score_loop's.  win is the int32
// scratch, (WM + 2 WE) * K a pair.
extern "C" int wfa_resume(const uint8_t* qb, const uint8_t* tbuf2,
                          const int32_t* qlen, const int32_t* tlen,
                          const int32_t* toff2, int B, int Lq, int Ltb2,
                          int S, int S0, int K, int x, int oe, int e,
                          int reduce_on, int min_wf_len, int max_dist_diff,
                          int cell16, int32_t* win, int32_t* out,
                          void* aux2, int32_t* win_m, int32_t* win_i,
                          int32_t* win_d, int32_t* ainit, int32_t* b_m,
                          int32_t* b_ie, int32_t* meta1, void* stream) {
  const Handoff ho{win_m, win_i, win_d, ainit, b_m, b_ie, meta1, S0, K};
  auto run = cell16 ? &launch_loop<false, false, kResume, int16_t>
                    : &launch_loop<false, false, kResume, int32_t>;
  return run(qb, tbuf2, qlen, tlen, toff2, B, Lq, Ltb2, S, K, x, oe, e,
             reduce_on, min_wf_len, max_dist_diff, K, win, out, aux2, nullptr,
             ho, stream);
}
