// Kernel K2: the backtrace chase, one thread per pair.
//
// Replaces the XLA while_loop of wfa_tpu/device_backtrace.py:276-547
// (device_backtrace, global or semi-global alignment, one aux tensor,
// pairs not on lanes).  That loop steps every pair of the batch in lockstep; written
// as torch ops it would cost one launch per op per step, for up to
// iter_capacity steps.  Here each thread walks its own pair to the end.
//
// Two aux forms: int32 cells (offset0 << 3 | tag) from the score loop, or
// the long-read score loop's value-rebased int16 cells, whose found cells
// hold offset0 - aux_base[b, s] + 1 (device_backtrace.py:327-331,
// 379-383); read_aux is templated on the cell type and adds the base back.
//
// What bounds it on the card: one dependent 4-byte aux read per step
// (an L2 or HBM latency, ~iter_capacity steps per pair; a rebased read
// adds an independent base read).  One thread per pair keeps a whole batch
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

// One aux cell at (s, comp, k); `base` (int32[B, S]) is null for int32
// cells and the per-row value base of rebased int16 cells.
template <typename Cell>
__device__ __forceinline__ AuxCell read_aux(const Cell* __restrict__ aux,
                                            const int32_t* __restrict__ base,
                                            int S, int B, int K, int b,
                                            int k0, int s, int comp, int k) {
  int j = k - k0;
  AuxCell r{0, 0, false};
  if (s >= 0 && s < S && j >= 0 && j < K) {
    int cell = aux[((int64_t)(comp * S + s) * B + b) * K + j];
    if (cell > 0) {
      int off = cell >> 3;
      if (base != nullptr) off += base[(int64_t)b * S + s] - 1;
      r = AuxCell{off, cell & 7, true};
    }
  }
  return r;
}

template <typename Tok, typename Cell>
__global__ void backtrace_kernel(
    const Cell* __restrict__ aux, const int32_t* __restrict__ aux_base,
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
    AuxCell c = read_aux(aux, aux_base, S, B, K, b, k0, s, comp, k);
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
    AuxCell c = read_aux(aux, aux_base, S, B, K, b, k0, s, comp, k);
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
void launch_tok(const void* aux, const int32_t* aux_base,
                const int32_t* start_cell, const int32_t* k0,
                const int32_t* start_s, const int32_t* start_k,
                const int32_t* qlen, const int32_t* tlen,
                const uint8_t* active0, int B, int S, int K, int x, int oe,
                int e, int it_cap, int token_shift, int split, int semi,
                void* tok0, void* buf, void* tail, int32_t* iters,
                cudaStream_t st) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  Tok* t0 = static_cast<Tok*>(tok0);
  Tok* bf = static_cast<Tok*>(buf);
  Tok* tl = static_cast<Tok*>(tail);
  if (aux_base != nullptr) {
    backtrace_kernel<Tok, int16_t><<<blocks, threads, 0, st>>>(
        static_cast<const int16_t*>(aux), aux_base, start_cell, k0, start_s,
        start_k, qlen, tlen, active0, B, S, K, x, oe, e, it_cap, token_shift,
        split, semi, t0, bf, tl, iters);
  } else {
    backtrace_kernel<Tok, int32_t><<<blocks, threads, 0, st>>>(
        static_cast<const int32_t*>(aux), nullptr, start_cell, k0, start_s,
        start_k, qlen, tlen, active0, B, S, K, x, oe, e, it_cap, token_shift,
        split, semi, t0, bf, tl, iters);
  }
}

}  // namespace

// aux is int32[3, S, B, K] when aux_base is null, else the value-rebased
// int16[3, S, B, K] with its bases int32[B, S]; iters is int32[B]
extern "C" int wfa_backtrace(const void* aux, const int32_t* aux_base,
                             const int32_t* start_cell, const int32_t* k0,
                             const int32_t* start_s, const int32_t* start_k,
                             const int32_t* qlen, const int32_t* tlen,
                             const uint8_t* active0, int B, int S, int K,
                             int x, int oe, int e, int it_cap,
                             int token_shift, int split, int semi,
                             void* tok0, void* buf, void* tail,
                             int32_t* iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (token_shift <= 12) {
      launch_tok<int16_t>(aux, aux_base, start_cell, k0, start_s, start_k,
                          qlen, tlen, active0, B, S, K, x, oe, e, it_cap,
                          token_shift, split, semi, tok0, buf, tail, iters,
                          st);
    } else {
      launch_tok<int32_t>(aux, aux_base, start_cell, k0, start_s, start_k,
                          qlen, tlen, active0, B, S, K, x, oe, e, it_cap,
                          token_shift, split, semi, tok0, buf, tail, iters,
                          st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
