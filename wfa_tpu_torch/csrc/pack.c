/* Native host-side batch packer of wfa_tpu_torch.
 *
 * The pipeline's host hot loop (engine._pack_all) builds padded row
 * matrices for a batch of sequences and 2-bit-packs pure-ACGT batches for
 * the upload (4x smaller).  In numpy this costs ~10 full-matrix passes;
 * here it is one memcpy pass plus one fused LUT/pack pass, and the direct
 * pack of a pure-ACGT batch runs a vector body where the CPU has one.
 * The code differs from the JAX package's wfa_tpu/native/pack.c; its
 * outputs and verdicts are held equal to that file's by the tests
 * (tests/test_torch_native_pack.py).
 *
 * Counterpart of the reference's per-pair []byte handling (wfa-go.go
 * just passes Go slices); the batched design needs dense padded
 * matrices instead, so this layer is new, not a port.
 *
 * Build: cc -O3 -shared -fPIC pack.c -o <lib>.so   (see native.py)
 */

#include <stdint.h>
#include <string.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

/* 2-bit codes for ACGT; 255 = not packable (any other byte, incl. \0,
 * so embedded NULs inside a sequence force the raw path). */
static uint8_t CODES[256];
static int codes_ready = 0;

static void init_codes(void) {
    if (codes_ready) return;
    memset(CODES, 255, sizeof(CODES));
    CODES['A'] = 0; CODES['C'] = 1; CODES['G'] = 2; CODES['T'] = 3;
    codes_ready = 1;
}

/* Build the padded row matrix: row b = zeros, with seqs[b] (lens[b]
 * bytes) copied at column offs[b] (clamped to [0, L); overflow rows with
 * negative offsets get truncated content — it is never read). */
void wfa_build_rows(const char **seqs, const int32_t *lens,
                    const int32_t *offs, int32_t B, int32_t L,
                    uint8_t *raw_out) {
    for (int32_t b = 0; b < B; b++) {
        uint8_t *row = raw_out + (size_t)b * L;
        memset(row, 0, (size_t)L);
        int32_t off = offs ? offs[b] : 0;
        int32_t skip = 0;
        if (off < 0) { skip = -off; off = 0; }
        int32_t n = lens[b] - skip;
        if (n > L - off) n = L - off;
        if (n > 0) memcpy(row + off, seqs[b] + skip, (size_t)n);
    }
}

/* 2-bit-pack a zero-padded row matrix (4 bases/byte, little pairs
 * first, matching BatchAligner._pack2).  Pad bytes (\0) pack as code 0
 * and are re-zeroed by the device unpack mask.  Returns 1 iff every
 * nonzero byte was ACGT AND the nonzero count equals
 * ``expected_nonzero`` (the total in-bounds sequence length): a
 * sequence with an embedded \0 lowers the count, which forces the raw
 * path — \0 must NOT silently pack as code 0 = 'A' in bounds. */
int32_t wfa_pack2(const uint8_t *raw, int64_t n_bytes,
                  int64_t expected_nonzero, uint8_t *packed_out) {
    init_codes();
    uint32_t bad = 0;
    int64_t nz = 0;
    const uint8_t *p = raw;
    uint8_t *o = packed_out;
    for (int64_t i = 0; i < n_bytes; i += 4) {
        uint8_t b0 = p[i], b1 = p[i + 1], b2 = p[i + 2], b3 = p[i + 3];
        uint8_t c0 = b0 ? CODES[b0] : 0;
        uint8_t c1 = b1 ? CODES[b1] : 0;
        uint8_t c2 = b2 ? CODES[b2] : 0;
        uint8_t c3 = b3 ? CODES[b3] : 0;
        bad |= (uint32_t)(c0 | c1 | c2 | c3);
        nz += (b0 != 0) + (b1 != 0) + (b2 != 0) + (b3 != 0);
        *o++ = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
    }
    return ((bad & 0xfcu) == 0 && nz == expected_nonzero) ? 1 : 0;
}

/* The aligned body of a row: 4-aligned bases s[0, n) into out[0, n / 4),
 * 4 bases -> 1 output byte, ORing their codes into *bad.  Returns the
 * bases packed (n rounded down to a multiple of 4). */
typedef int32_t (*body_fn)(const uint8_t *s, int32_t n, uint8_t *out,
                           uint32_t *bad);

static int32_t body_scalar(const uint8_t *s, int32_t n, uint8_t *out,
                           uint32_t *bad) {
    uint32_t acc = 0;  /* a local: the byte stores may alias *bad */
    int32_t i = 0;
    for (; i + 4 <= n; i += 4) {
        uint8_t c0 = CODES[s[i]], c1 = CODES[s[i + 1]];
        uint8_t c2 = CODES[s[i + 2]], c3 = CODES[s[i + 3]];
        acc |= (uint32_t)(c0 | c1 | c2 | c3);
        out[i >> 2] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
    }
    *bad |= acc;
    return i;
}

#if defined(__x86_64__)
/* 32 bases a step.  The code of A, C, G, T (0x41, 0x43, 0x47, 0x54) is
 * ((b >> 1) ^ (b >> 2)) & 3 (16-bit shifts: the bits they carry across
 * bytes are masked off); a byte is ACGT iff "ACGT"[code] gives it back,
 * so NUL, lowercase, N and bytes >= 0x80 all fail.  maddubs and madd put
 * c0 | c1 << 2 | c2 << 4 | c3 << 6 in each 32-bit lane; pshufb and a
 * lane permute gather the 8 output bytes. */
__attribute__((target("avx2")))
static int32_t body_avx2(const uint8_t *s, int32_t n, uint8_t *out,
                         uint32_t *bad) {
    const __m256i three = _mm256_set1_epi8(3);
    const __m256i acgt = _mm256_setr_epi8(
        'A', 'C', 'G', 'T', 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        'A', 'C', 'G', 'T', 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0);
    const __m256i w14 = _mm256_set1_epi16(0x0401);  /* bytes 1, 4 */
    const __m256i w116 = _mm256_set1_epi32(0x00100001);  /* int16 1, 16 */
    const __m256i gather = _mm256_setr_epi8(
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
        0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
    const __m256i lanes = _mm256_setr_epi32(0, 4, 0, 0, 0, 0, 0, 0);
    __m256i ok = _mm256_set1_epi8(-1);
    int32_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i b = _mm256_loadu_si256((const __m256i *)(s + i));
        __m256i c = _mm256_and_si256(
            _mm256_xor_si256(_mm256_srli_epi16(b, 1), _mm256_srli_epi16(b, 2)),
            three);
        ok = _mm256_and_si256(
            ok, _mm256_cmpeq_epi8(_mm256_shuffle_epi8(acgt, c), b));
        __m256i p = _mm256_madd_epi16(_mm256_maddubs_epi16(c, w14), w116);
        p = _mm256_permutevar8x32_epi32(_mm256_shuffle_epi8(p, gather), lanes);
        _mm_storel_epi64((__m128i *)(out + (i >> 2)), _mm256_castsi256_si128(p));
    }
    if (_mm256_movemask_epi8(ok) != -1) *bad |= 0xfcu;
    return i + body_scalar(s + i, n - i, out + (i >> 2), bad);
}
#endif

/* The body this host runs, chosen at first use by the CPU's instruction
 * set (every thread that races here chooses the same). */
static body_fn chosen_body(void) {
    static body_fn body;
    body_fn f = __atomic_load_n(&body, __ATOMIC_RELAXED);
    if (f) return f;
    f = body_scalar;
#if defined(__x86_64__)
    __builtin_cpu_init();
    if (__builtin_cpu_supports("avx2")) f = body_avx2;
#endif
    __atomic_store_n(&body, f, __ATOMIC_RELAXED);
    return f;
}

/* 1 when wfa_pack_direct runs a vector body on this host, else 0. */
int32_t wfa_pack_vector(void) {
    return chosen_body() != body_scalar;
}

/* Direct 2-bit pack straight from the source strings — no padded raw
 * matrix intermediate (the raw rows are only needed when the batch has
 * non-ACGT bytes, and building them costs ~4x the memory traffic of the
 * packed output).  Row b's L / 4 bytes go to packed_out + b * stride, so
 * that two calls may fill the two column ranges of one matrix.  Returns
 * the bases packed; -1 means a non-ACGT byte (incl. embedded NUL) was
 * seen and the caller must fall back to wfa_build_and_pack. */
static int64_t pack_direct(body_fn body, const char **seqs,
                           const int32_t *lens, const int32_t *offs,
                           int32_t B, int32_t L, int64_t stride,
                           uint8_t *packed_out) {
    init_codes();
    uint32_t bad = 0;
    int64_t total = 0;
    int32_t W = L / 4;
    for (int32_t b = 0; b < B; b++) {
        uint8_t *row = packed_out + (size_t)b * (size_t)stride;
        memset(row, 0, (size_t)W);
        int32_t off = offs ? offs[b] : 0;
        int32_t skip = 0;
        if (off < 0) { skip = -off; off = 0; }
        int32_t n = lens[b] - skip;
        if (n > L - off) n = L - off;
        if (n <= 0) continue;
        const uint8_t *s = (const uint8_t *)seqs[b] + skip;
        int32_t i = 0;
        /* unaligned head: place bases until off+i is 4-aligned */
        for (; i < n && ((off + i) & 3); i++) {
            uint8_t c = CODES[s[i]];
            bad |= c;
            row[(off + i) >> 2] |= (uint8_t)((c & 3) << (((off + i) & 3) << 1));
        }
        /* aligned body: 4 bases -> 1 output byte */
        i += body(s + i, n - i, row + ((off + i) >> 2), &bad);
        for (; i < n; i++) {
            uint8_t c = CODES[s[i]];
            bad |= c;
            row[(off + i) >> 2] |= (uint8_t)((c & 3) << (((off + i) & 3) << 1));
        }
        if (bad & 0xfcu) return -1; /* bail early on a raw-path batch */
        total += n;
    }
    return total;
}

/* The direct pack with the body this host runs (wfa_pack_vector). */
int64_t wfa_pack_direct(const char **seqs, const int32_t *lens,
                        const int32_t *offs, int32_t B, int32_t L,
                        int64_t stride, uint8_t *packed_out) {
    return pack_direct(chosen_body(), seqs, lens, offs, B, L, stride,
                       packed_out);
}

/* The direct pack with the portable body, whatever the CPU offers. */
int64_t wfa_pack_direct_scalar(const char **seqs, const int32_t *lens,
                               const int32_t *offs, int32_t B, int32_t L,
                               int64_t stride, uint8_t *packed_out) {
    return pack_direct(body_scalar, seqs, lens, offs, B, L, stride,
                       packed_out);
}

/* Fused: build rows + pack.  Returns 1 when packed_out is valid. */
int32_t wfa_build_and_pack(const char **seqs, const int32_t *lens,
                           const int32_t *offs, int32_t B, int32_t L,
                           uint8_t *raw_out, uint8_t *packed_out) {
    wfa_build_rows(seqs, lens, offs, B, L, raw_out);
    int64_t expected = 0;
    for (int32_t b = 0; b < B; b++) {
        int32_t off = offs ? offs[b] : 0;
        int32_t skip = 0;
        if (off < 0) { skip = -off; off = 0; }
        int32_t n = lens[b] - skip;
        if (n > L - off) n = L - off;
        if (n > 0) expected += n;
    }
    return wfa_pack2(raw_out, (int64_t)B * L, expected, packed_out);
}
