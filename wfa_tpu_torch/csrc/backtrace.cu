// Kernel K2: the backtrace chase, one thread per pair.
//
// Replaces the XLA while_loop of wfa_tpu/device_backtrace.py:276-547
// (device_backtrace, global or semi-global alignment, one aux tensor or
// the two-phase route's two, pairs not on lanes).  That loop steps every
// pair of the batch in lockstep; written as torch ops it would cost one
// launch per op per step, for up to
// iter_capacity steps.  Here each thread walks its own pair to the end.
//
// Aux forms: int32 or int16 cells (offset0 << 3 | tag) from the score
// loop, or the long-read score loop's value-rebased int16 cells, whose
// found cells hold offset0 - aux_base[b, s] + 1 (device_backtrace.py:
// 327-331, 379-383); read_aux adds the base back.  K1-kw's int16 rows
// (device_backtrace.py:332-334, 352-355, 384-385) are KW columns wide,
// row s of pair b starting at window column (sbase[s, b] & 31) * 32, and
// their found cells hold offset0 - (sbase[s, b] >> 5) + 1: read_aux
// shifts the column and adds the base back.  The two-phase
// semi-global route hands in two aux tensors (device_backtrace.py:281,
// 335-375): scores below s_split read phase 1's full-span aux_old
// [3, s_split, B, Kf] at window origin k0_old = -(qlen - 1), the rest
// phase 2's aux [3, S - s_split, B, K] at origin k0; each tensor's cell
// width is its own.  The choice is per step and costs one select of the
// view and origin, so the chains do not diverge on it.
//
// What bounds it on the card: one dependent 4-byte aux read per step
// (an L2 or HBM latency, ~iter_capacity steps per pair; a rebased read
// adds an independent base read; a K1-kw read first loads the sbase word,
// whose row base places the cell, so it is a second dependent load before
// the cell load).  One thread per pair keeps a whole batch
// of those chains in flight, so the latency is hidden across pairs rather
// than within one; a 64-pair long-read batch keeps only 64 in flight.
// Every slot of buf is written, and iters[b] records the iterations the
// pair ran (their maximum is the JAX loop's trip count, which the raw
// non-compact output ships as its trim length).
//
// The step logic is an exact per-pair transcription of the JAX loop:
// the tag of the cell stepped into is read one step late, from the same
// aux cell that gives the next offset0; a pair that exits right after a
// step still applies that pending tag before the tail; the loop stops at
// it == it_cap - 1.  A semi-global chase stops, without stepping, once
// the op it recorded left it on the first row or column (h == 1 or
// v == 1: a seed cell).  Every slot of buf is written exactly once (zero
// when the pair emits nothing), so the wrapper can hand in torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInsOpen = 1, kInsExt = 2, kDelOpen = 3, kDelExt = 4;
constexpr int kMismatch = 5;
constexpr int kCodeM = 0, kCodeI = 2, kCodeH = 4;
// tag -> op code; the second table keeps the gap-extension codes apart
// (5 = insert-ext, 6 = delete-ext) for the edit-only token stream
__constant__ int kTag2Code[2][8] = {{7, 2, 2, 3, 3, 1, 0, 7},
                                    {7, 2, 5, 3, 6, 1, 0, 7}};

struct AuxCell {
  int offset0;
  int tag;
  bool found;
};

// An aux tensor [3, rows, B, K] of int16 or int32 cells holding scores
// s_lo .. s_lo + rows - 1
struct AuxView {
  const void* p;
  int rows;
  int K;
  int s_lo;
  bool c16;
};

__device__ __forceinline__ int load_cell(const AuxView& a, int comp, int s,
                                         int B, int b, int j) {
  const int64_t i = ((int64_t)(comp * a.rows + s - a.s_lo) * B + b) * a.K + j;
  return a.c16 ? static_cast<const int16_t*>(a.p)[i]
               : static_cast<const int32_t*>(a.p)[i];
}

// One aux cell at (s, comp, k): from `old` at origin k0_old below cur's
// first score (the two-phase split; `old` is empty otherwise), else from
// `cur` at origin k0.  `base` (int32[B, S]) is null but for rebased cells,
// where it holds each row's value base; `sbase` (int32[S, B]) null but for
// K1-kw's cells, where it holds each row's vb << 5 | cb.
__device__ __forceinline__ AuxCell read_aux(const AuxView& cur,
                                            const AuxView& old,
                                            const int32_t* __restrict__ base,
                                            const int32_t* __restrict__ sbase,
                                            int S, int B, int b, int k0,
                                            int k0_old, int s, int comp,
                                            int k) {
  const bool use_old = s < cur.s_lo;
  const AuxView& a = use_old ? old : cur;
  int j = k - (use_old ? k0_old : k0);
  const int s_end = use_old ? cur.s_lo : S;
  AuxCell r{0, 0, false};
  if (s < a.s_lo || s >= s_end) return r;
  int sbv = 0;
  if (sbase != nullptr) {
    sbv = sbase[(int64_t)s * B + b];
    j -= (sbv & 31) * 32;
  }
  if (j >= 0 && j < a.K) {
    const int cell = load_cell(a, comp, s, B, b, j);
    if (cell > 0) {
      int off = cell >> 3;
      if (base != nullptr) off += base[(int64_t)b * S + s] - 1;
      if (sbase != nullptr) off += (sbv >> 5) - 1;
      r = AuxCell{off, cell & 7, true};
    }
  }
  return r;
}

template <typename Tok>
__global__ void backtrace_kernel(
    AuxView cur, AuxView old, const int32_t* __restrict__ k0_old,
    const int32_t* __restrict__ aux_base, const int32_t* __restrict__ sbase,
    const int32_t* __restrict__ start_cell,
    const int32_t* __restrict__ k0s, const int32_t* __restrict__ start_s,
    const int32_t* __restrict__ start_k, const int32_t* __restrict__ qlen,
    const int32_t* __restrict__ tlen, const uint8_t* __restrict__ active0,
    int B, int S, int K, int x, int oe, int e, int it_cap, int shift,
    int split, int semi, Tok* __restrict__ tok0, Tok* __restrict__ buf,
    Tok* __restrict__ tail, int32_t* __restrict__ iters) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* code_of = kTag2Code[split];
  auto pack = [shift](int code, int n) { return (Tok)((code << shift) | n); };

  const int ql = qlen[b], tl = tlen[b], k0 = k0s[b];
  const int k0o = k0_old != nullptr ? k0_old[b] : 0;
  const bool act = active0[b] != 0;
  const int raw = start_cell[b];
  int tag = raw & 7;
  int h = raw >> 3;
  int k = start_k[b];
  int s = start_s[b];
  int v = h - k;

  // start point (wfa.go:738-750); existence deliberately unchecked
  bool fl_i = h < tl;
  bool fl_h = !fl_i && v < ql;
  tok0[b] = (act && (fl_i || fl_h))
                ? pack(fl_i ? kCodeI : kCodeH, max(fl_i ? tl - h : ql - v, 0))
                : (Tok)0;

  bool alive = act && v > 0 && h > 0;
  bool pfm = true;  // previousFromM
  bool pending = false;
  int comp = 0;
  int it = 0;
  while (alive) {
    AuxCell c =
        read_aux(cur, old, aux_base, sbase, S, B, b, k0, k0o, s, comp, k);
    if (pending) {
      if (c.found) tag = c.tag;
      else alive = false;
    }
    bool is_ie = tag == kInsExt, is_de = tag == kDelExt;
    bool cont = alive && c.offset0 != 0;

    // traceback matches (wfa.go:832-869)
    int nmatch = h - c.offset0;
    Tok tok_m = (cont && pfm && nmatch > 0) ? pack(kCodeM, nmatch) : (Tok)0;
    bool upd = cont && pfm;
    if (upd) {
      h = c.offset0;
      v = h - k;
    }
    bool cont2 = cont && !(upd && (h <= 0 || v <= 0));
    Tok tok_op = cont2 ? pack(code_of[tag], 1) : (Tok)0;
    buf[((int64_t)it * B + b) * 2] = tok_m;
    buf[((int64_t)it * B + b) * 2 + 1] = tok_op;
    // semi-global: a seed cell is the path's start
    const bool cont3 = cont2 && !(semi && (h == 1 || v == 1));

    // step to the source cell (wfa.go:884-909)
    bool is_mis = tag == kMismatch, is_io = tag == kInsOpen;
    bool is_do = tag == kDelOpen;
    bool step = cont3 && (is_mis || is_io || is_ie || is_do || is_de);
    if (step) {
      s -= is_mis ? x : ((is_io || is_do) ? oe : e);
      k += (is_io || is_ie) ? -1 : ((is_do || is_de) ? 1 : 0);
      h += (is_mis || is_io || is_ie) ? -1 : 0;
      v = h - k;
      pfm = !(is_ie || is_de);
      comp = is_ie ? 1 : (is_de ? 2 : 0);
    }
    pending = step;
    alive = step && v > 0 && h > 0 && it < it_cap - 1;
    ++it;
  }
  iters[b] = it;  // the chase iterations this pair ran
  for (; it < it_cap; ++it) {
    buf[((int64_t)it * B + b) * 2] = 0;
    buf[((int64_t)it * B + b) * 2 + 1] = 0;
  }
  // the reference updates the tag before its loop check (wfa.go:915-920)
  if (pending) {
    AuxCell c =
        read_aux(cur, old, aux_base, sbase, S, B, b, k0, k0o, s, comp, k);
    if (c.found) tag = c.tag;
  }

  // the last one (wfa.go:930-968) and the leading flanks (970-976)
  bool last = act && h > 0 && v > 0;
  int nm = min(h, v) - 1;
  bool e1 = last && nm > 0;
  Tok tok_a = e1 ? pack(kCodeM, nm) : (Tok)0;
  if (e1) {
    h -= nm;
    v -= nm;
  }
  Tok tok_b = last ? pack(code_of[tag], 1) : (Tok)0;
  Tok tok_c = (act && v > 1) ? pack(kCodeH, v - 1) : (Tok)0;
  Tok tok_d = (act && h > 1) ? pack(kCodeI, h - 1) : (Tok)0;
  tail[(int64_t)b * 4] = tok_a;
  tail[(int64_t)b * 4 + 1] = tok_b;
  tail[(int64_t)b * 4 + 2] = tok_c;
  tail[(int64_t)b * 4 + 3] = tok_d;
}

template <typename Tok>
void launch_tok(AuxView cur, AuxView old, const int32_t* k0_old,
                const int32_t* aux_base, const int32_t* sbase,
                const int32_t* start_cell,
                const int32_t* k0, const int32_t* start_s,
                const int32_t* start_k, const int32_t* qlen,
                const int32_t* tlen, const uint8_t* active0, int B, int S,
                int K, int x, int oe, int e, int it_cap, int token_shift,
                int split, int semi, void* tok0, void* buf, void* tail,
                int32_t* iters, cudaStream_t st) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  backtrace_kernel<Tok><<<blocks, threads, 0, st>>>(
      cur, old, k0_old, aux_base, sbase, start_cell, k0, start_s, start_k,
      qlen, tlen, active0, B, S, K, x, oe, e, it_cap, token_shift, split,
      semi,
      static_cast<Tok*>(tok0), static_cast<Tok*>(buf),
      static_cast<Tok*>(tail), iters);
}

}  // namespace

// aux is [3, S - s_split, B, K] of int16 (aux_c16) or int32 cells; with
// aux_base (int32[B, S]) the value-rebased int16 cells of the long-read
// score loop, with sbase (int32[S, B]) K1-kw's int16 cells, K = KW
// columns a row.  With s_split > 0, aux_old [3, s_split, B, Kf] (int16
// when old_c16) holds the scores below s_split at window origins k0_old.
// iters is int32[B].
extern "C" int wfa_backtrace(const void* aux, int aux_c16,
                             const int32_t* aux_base, const int32_t* sbase,
                             const void* aux_old,
                             int old_c16, int s_split, int Kf,
                             const int32_t* k0_old,
                             const int32_t* start_cell, const int32_t* k0,
                             const int32_t* start_s, const int32_t* start_k,
                             const int32_t* qlen, const int32_t* tlen,
                             const uint8_t* active0, int B, int S, int K,
                             int x, int oe, int e, int it_cap,
                             int token_shift, int split, int semi,
                             void* tok0, void* buf, void* tail,
                             int32_t* iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AuxView cur{aux, S - s_split, K, s_split, aux_c16 != 0};
  const AuxView old{aux_old, s_split, Kf, 0, old_c16 != 0};
  if (B > 0) {
    auto run = token_shift <= 12 ? &launch_tok<int16_t> : &launch_tok<int32_t>;
    run(cur, old, k0_old, aux_base, sbase, start_cell, k0, start_s, start_k,
        qlen, tlen, active0, B, S, K, x, oe, e, it_cap, token_shift, split,
        semi, tok0, buf, tail, iters, st);
  }
  return static_cast<int>(cudaGetLastError());
}
