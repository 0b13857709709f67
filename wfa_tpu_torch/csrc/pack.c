/* Native host-side batch packer of wfa_tpu_torch (the same source as the
 * JAX package's wfa_tpu/native/pack.c).
 *
 * The pipeline's host hot loop (engine._pack_all) builds padded row
 * matrices for a batch of sequences and 2-bit-packs pure-ACGT batches for
 * the upload (4x smaller).  In numpy this costs ~10 full-matrix passes;
 * here it is one memcpy pass plus one fused LUT/pack pass.
 *
 * Counterpart of the reference's per-pair []byte handling (wfa-go.go
 * just passes Go slices); the batched design needs dense padded
 * matrices instead, so this layer is new, not a port.
 *
 * Build: cc -O3 -shared -fPIC pack.c -o <lib>.so   (see native.py)
 */

#include <stdint.h>
#include <string.h>

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

/* Direct 2-bit pack straight from the source strings — no padded raw
 * matrix intermediate (the raw rows are only needed when the batch has
 * non-ACGT bytes, and building them costs ~4x the memory traffic of the
 * packed output).  Returns 1 when packed_out is
 * valid; 0 means a non-ACGT byte (incl. embedded NUL) was seen and the
 * caller must fall back to wfa_build_and_pack. */
int32_t wfa_pack_direct(const char **seqs, const int32_t *lens,
                        const int32_t *offs, int32_t B, int32_t L,
                        uint8_t *packed_out) {
    init_codes();
    uint32_t bad = 0;
    int32_t W = L / 4;
    for (int32_t b = 0; b < B; b++) {
        uint8_t *row = packed_out + (size_t)b * W;
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
        for (; i + 4 <= n; i += 4) {
            uint8_t c0 = CODES[s[i]], c1 = CODES[s[i + 1]];
            uint8_t c2 = CODES[s[i + 2]], c3 = CODES[s[i + 3]];
            bad |= (uint32_t)(c0 | c1 | c2 | c3);
            row[(off + i) >> 2] =
                (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
        }
        for (; i < n; i++) {
            uint8_t c = CODES[s[i]];
            bad |= c;
            row[(off + i) >> 2] |= (uint8_t)((c & 3) << (((off + i) & 3) << 1));
        }
        if (bad & 0xfcu) return 0; /* bail early on a raw-path batch */
    }
    return (bad & 0xfcu) == 0 ? 1 : 0;
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
