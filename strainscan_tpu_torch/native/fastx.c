/* Native FASTA/FASTQ reader + 2-bit packer for StrainScan-TPU.
 *
 * Replaces the reference's per-read Python/Biopython parsing and the
 * jellyfish subprocess input path (library/identify.py:73-103) with a
 * zero-copy C data loader: sequences stream through zlib (gzFile reads
 * both plain and gzipped files), bases are encoded A=0 C=1 G=2 T=3 /
 * other=4 straight into a caller-provided [batch, maxlen] uint8 buffer
 * that is shipped to the device as-is.  Long reads are split into chunks
 * with a (k-1)-base overlap so no k-mer window is lost.
 *
 * Also provides whole-genome packed-k-mer extraction for DB builds
 * (replacing Build_tree.py:93-130 / Build_kmer_sets...sp.py:518-543
 * pure-Python scans).
 *
 * Exposed via ctypes; see strainscan_tpu_torch/native/__init__.py.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <zlib.h>

#define LINEBUF (1 << 20)

static unsigned char CODE[256];
static int code_init = 0;

static void init_code(void) {
    if (code_init) return;
    memset(CODE, 4, 256);
    CODE['A'] = CODE['a'] = 0;
    CODE['C'] = CODE['c'] = 1;
    CODE['G'] = CODE['g'] = 2;
    CODE['T'] = CODE['t'] = 3;
    code_init = 1;
}

typedef struct {
    gzFile f;
    int fmt;          /* 0 unknown, 1 fastq, 2 fasta */
    char *line;       /* line buffer */
    size_t line_cap;
    /* carry-over: encoded remainder of a read too long for one row */
    unsigned char *carry;
    size_t carry_len, carry_cap, carry_off;
    /* fasta: pending sequence accumulation */
    unsigned char *seq;
    size_t seq_len, seq_cap;
    int eof;
} fastx_t;

static char *read_line(fastx_t *h) {
    if (h->eof) return NULL;
    size_t len = 0;
    for (;;) {
        if (len + LINEBUF + 1 > h->line_cap) {
            h->line_cap = (len + LINEBUF + 1) * 2;
            h->line = (char *)realloc(h->line, h->line_cap);
        }
        char *got = gzgets(h->f, h->line + len, LINEBUF);
        if (!got) {
            if (len == 0) { h->eof = 1; return NULL; }
            h->line[len] = 0;
            return h->line;
        }
        len += strlen(h->line + len);
        if (len > 0 && h->line[len - 1] == '\n') {
            h->line[--len] = 0;
            if (len > 0 && h->line[len - 1] == '\r') h->line[--len] = 0;
            return h->line;
        }
    }
}

void *fastx_open(const char *path) {
    init_code();
    gzFile f = gzopen(path, "rb");
    if (!f) return NULL;
    gzbuffer(f, 1 << 20);
    fastx_t *h = (fastx_t *)calloc(1, sizeof(fastx_t));
    h->f = f;
    h->line_cap = LINEBUF + 1;
    h->line = (char *)malloc(h->line_cap);
    return h;
}

void fastx_close(void *vh) {
    fastx_t *h = (fastx_t *)vh;
    if (!h) return;
    if (h->f) gzclose(h->f);
    free(h->line);
    free(h->carry);
    free(h->seq);
    free(h);
}

static void stash_carry(fastx_t *h, const unsigned char *enc, size_t n) {
    if (n > h->carry_cap) {
        h->carry_cap = n * 2;
        h->carry = (unsigned char *)realloc(h->carry, h->carry_cap);
    }
    memcpy(h->carry, enc, n);
    h->carry_len = n;
    h->carry_off = 0;
}

/* Encode seq into row; chunk remainder into carry. Returns rows used (1). */
static int emit_seq(fastx_t *h, const char *seq, size_t n,
                    unsigned char *row, int maxlen, int k) {
    size_t take = n > (size_t)maxlen ? (size_t)maxlen : n;
    for (size_t i = 0; i < take; i++) row[i] = CODE[(unsigned char)seq[i]];
    memset(row + take, 4, maxlen - take);
    if (n > take) {
        /* remainder with k-1 overlap */
        size_t start = take - (k - 1);
        size_t rem = n - start;
        if (rem > h->carry_cap) {
            h->carry_cap = rem * 2;
            h->carry = (unsigned char *)realloc(h->carry, h->carry_cap);
        }
        for (size_t i = 0; i < rem; i++)
            h->carry[i] = CODE[(unsigned char)seq[start + i]];
        h->carry_len = rem;
        h->carry_off = 0;
    }
    return 1;
}

/* Emit from carry buffer into row; keeps overlap chunking. */
static int emit_carry(fastx_t *h, unsigned char *row, int maxlen, int k) {
    size_t avail = h->carry_len - h->carry_off;
    size_t take = avail > (size_t)maxlen ? (size_t)maxlen : avail;
    memcpy(row, h->carry + h->carry_off, take);
    memset(row + take, 4, maxlen - take);
    if (avail > take) {
        h->carry_off += take - (k - 1);
    } else {
        h->carry_len = h->carry_off = 0;
    }
    return 1;
}

/* Fill up to `batch` rows of `out` [batch, maxlen]. Returns rows filled. */
int fastx_next_batch(void *vh, unsigned char *out, int batch, int maxlen, int k) {
    fastx_t *h = (fastx_t *)vh;
    int rows = 0;
    while (rows < batch) {
        if (h->carry_len > h->carry_off) {
            rows += emit_carry(h, out + (size_t)rows * maxlen, maxlen, k);
            continue;
        }
        char *line = read_line(h);
        if (!line) {
            /* flush pending fasta record */
            if (h->fmt == 2 && h->seq_len > 0) {
                rows += emit_seq(h, (const char *)h->seq, h->seq_len,
                                 out + (size_t)rows * maxlen, maxlen, k);
                h->seq_len = 0;
                continue;
            }
            break;
        }
        if (line[0] == 0) continue;
        if (h->fmt == 0) h->fmt = (line[0] == '@') ? 1 : 2;
        if (h->fmt == 1) {
            /* header line; next line is the sequence */
            char *seq = read_line(h);
            if (!seq) break;
            size_t n = strlen(seq);
            rows += emit_seq(h, seq, n, out + (size_t)rows * maxlen, maxlen, k);
            read_line(h); /* '+' */
            read_line(h); /* quals */
        } else {
            if (line[0] == '>') {
                if (h->seq_len > 0) {
                    rows += emit_seq(h, (const char *)h->seq, h->seq_len,
                                     out + (size_t)rows * maxlen, maxlen, k);
                    h->seq_len = 0;
                }
            } else {
                size_t n = strlen(line);
                if (h->seq_len + n > h->seq_cap) {
                    h->seq_cap = (h->seq_len + n) * 2 + 1024;
                    h->seq = (unsigned char *)realloc(h->seq, h->seq_cap);
                }
                memcpy(h->seq + h->seq_len, line, n);
                h->seq_len += n;
            }
        }
    }
    return rows;
}

/* ---------------- whole-genome packed k-mer extraction ---------------- */

typedef struct {
    uint64_t *data;
    size_t len, cap;
} u64vec;

static void push(u64vec *v, uint64_t x) {
    if (v->len == v->cap) {
        v->cap = v->cap ? v->cap * 2 : (1 << 20);
        v->data = (uint64_t *)realloc(v->data, v->cap * sizeof(uint64_t));
    }
    v->data[v->len++] = x;
}

static uint64_t revcomp64(uint64_t x, int k) {
    x = ~x;
    x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
    x = (x >> 32) | (x << 32);
    return x >> (64 - 2 * k);
}

static void scan_seq(const unsigned char *enc, size_t n, int k, int mode,
                     u64vec *v) {
    uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t cur = 0;
    int run = 0;
    for (size_t i = 0; i < n; i++) {
        unsigned char c = enc[i];
        if (c >= 4) { run = 0; cur = 0; continue; }
        cur = ((cur << 2) | c) & mask;
        if (++run >= k) {
            if (mode == 0) {
                push(v, cur);
            } else if (mode == 1) {
                push(v, cur);
                push(v, revcomp64(cur, k));
            } else {
                uint64_t rc = revcomp64(cur, k);
                push(v, cur < rc ? cur : rc);
            }
        }
    }
}

/* Extract all packed k-mers of every sequence in `path`.
 * mode: 0 = forward only, 1 = both orientations, 2 = canonical.
 * drop_last: skip each record's LAST window — bug-compatibility with
 * the reference's default tree build (Build_tree.py:100,113 iterates
 * range(len-ksize), missing one window per contig; Build_tree_mem
 * fixed it, so the canonical/memory-efficient path passes 0).
 * Returns count; *out is malloc'ed (caller frees via fastx_free_u64). */
long long fastx_kmers(const char *path, int k, int mode, int drop_last,
                      uint64_t **out) {
    init_code();
    fastx_t *h = (fastx_t *)fastx_open(path);
    if (!h) return -1;
    u64vec v = {0, 0, 0};
    unsigned char *enc = NULL;
    size_t enc_cap = 0;
    char *line;
    /* simple record walk: concatenate seq lines, scan at record boundary */
    size_t slen = 0;
    int fmt = 0;
    while ((line = read_line(h)) != NULL) {
        if (line[0] == 0) continue;
        if (fmt == 0) fmt = (line[0] == '@') ? 1 : 2;
        if (fmt == 1) {
            char *seq = read_line(h);
            if (!seq) break;
            size_t n = strlen(seq);
            if (n > enc_cap) { enc_cap = n * 2; enc = (unsigned char *)realloc(enc, enc_cap); }
            for (size_t i = 0; i < n; i++) enc[i] = CODE[(unsigned char)seq[i]];
            scan_seq(enc, drop_last && n ? n - 1 : n, k, mode, &v);
            read_line(h); read_line(h);
        } else {
            if (line[0] == '>') {
                if (slen) { scan_seq(enc, drop_last ? slen - 1 : slen, k, mode, &v); slen = 0; }
            } else {
                size_t n = strlen(line);
                if (slen + n > enc_cap) {
                    enc_cap = (slen + n) * 2 + 1024;
                    enc = (unsigned char *)realloc(enc, enc_cap);
                }
                for (size_t i = 0; i < n; i++)
                    enc[slen + i] = CODE[(unsigned char)line[i]];
                slen += n;
            }
        }
    }
    if (fmt == 2 && slen) scan_seq(enc, drop_last ? slen - 1 : slen, k, mode, &v);
    free(enc);
    fastx_close(h);
    *out = v.data;
    return (long long)v.len;
}

void fastx_free_u64(uint64_t *p) { free(p); }

/* ---------------- bucketed hash table construction ---------------- */

static uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

/* Must match strainscan_tpu_torch.index.hashtable.mix_np bit-for-bit. */
static uint32_t mix_hash(uint32_t hi, uint32_t lo) {
    uint32_t h = fmix32(hi ^ 0x9E3779B9u);
    return fmix32(h ^ lo);
}

#define TBL_BUCKET 8

/* Insert n packed keys into a bucketed open-addressing table of
 * n_buckets * 8 slots (caller-allocated, pre-filled: keys 0xFFFFFFFF,
 * val -1).  val[i] = i (the key's index).  Returns the max bucket-probe
 * count (>=1) or -1 when the table is full. */
int table_build(const uint64_t *keys, const int32_t *values, long long n,
                long long n_buckets, uint32_t *key_hi, uint32_t *key_lo,
                int32_t *val) {
    long long mask = n_buckets - 1;
    int max_probe = 1;
    for (long long i = 0; i < n; i++) {
        uint32_t hi = (uint32_t)(keys[i] >> 32);
        uint32_t lo = (uint32_t)(keys[i] & 0xFFFFFFFFu);
        long long b = (long long)(mix_hash(hi, lo)) & mask;
        for (long long p = 0; p < n_buckets; p++) {
            long long base = ((b + p) & mask) * TBL_BUCKET;
            for (int s = 0; s < TBL_BUCKET; s++) {
                if (val[base + s] < 0) {
                    key_hi[base + s] = hi;
                    key_lo[base + s] = lo;
                    val[base + s] = values[i];
                    if ((int)(p + 1) > max_probe) max_probe = (int)(p + 1);
                    goto placed;
                }
            }
        }
        return -1;
    placed:;
    }
    return max_probe;
}

/* Seeded, variable-bucket-width variant for the fingerprint probe path
 * (strainscan_tpu_torch.index.hashtable.FpTable): tries to place every key in
 * its home bucket only (probe distance 1 — the query then needs exactly
 * one row gather).  Also writes the per-slot 32-bit fingerprint
 * (second, bucket-independent hash).  Returns 0 on success, -1 when any
 * bucket overflows or two keys in one bucket share a fingerprint (caller
 * retries with the next seed). */
int table_build_fp(const uint64_t *keys, const int32_t *values, long long n,
                   long long n_buckets, int bucket, uint32_t seed,
                   uint32_t *fp, int32_t *val) {
    long long mask = n_buckets - 1;
    for (long long i = 0; i < n; i++) {
        uint32_t hi = (uint32_t)(keys[i] >> 32);
        uint32_t lo = (uint32_t)(keys[i] & 0xFFFFFFFFu);
        uint32_t h = fmix32(fmix32(hi ^ 0x9E3779B9u ^ seed) ^ lo);
        uint32_t f = fmix32(fmix32(lo ^ 0x85EBCA6Bu) ^ hi);
        long long base = ((long long)h & mask) * bucket;
        int s;
        for (s = 0; s < bucket; s++) {
            if (val[base + s] < 0) {
                fp[base + s] = f;
                val[base + s] = values[i];
                break;
            }
            if (fp[base + s] == f) return -1;  /* in-bucket fp collision */
        }
        if (s == bucket) return -1;            /* bucket overflow */
    }
    return 0;
}

/* Bit-pack an encoded read batch for host->device transfer in one pass
 * over its codes (strainscan_tpu_torch.kmer.pack.pack_batch).  codes is
 * uint8 [b, length], 0..3 a base, anything above 3 invalid.  Writes words
 * uint32 [b, w] (w = ceil(length/16); base p in bits 2*(p%16) of word
 * p/16, 0 where invalid) and, each where not NULL, vbytes uint8 [b, vb]
 * (vb = ceil(length/8); validity bit p%8 of byte p/8) and vlen uint16 [b]
 * (each row's valid count).  Returns 1 when every row's valid bases form
 * a prefix run, so that vlen is the payload of the vlen form, else 0.
 * Where the compiler targets AVX2 each 32 codes of a row are packed in
 * registers; an 8-code step on 64-bit words takes the rest.  A row stays
 * a prefix while its groups are full until one is a low run, and every
 * later one empty: each group's validity mask m is checked as it is made. */
#ifdef __AVX2__
#include <immintrin.h>
#endif

#define PREFIX_STEP(m, full) do { \
    bad |= ((m) & closed) | ((m) & ((m) + 1)); \
    closed |= -(uint32_t)((m) != (full)); } while (0)

/* 8 codes, little-endian in x -> their 16 bits of words; *v their
   validity byte. */
static inline uint32_t pack8(uint64_t x, uint32_t *v) {
    const uint64_t lo7 = 0x7F7F7F7F7F7F7F7FULL, hi = ~lo7;
    uint64_t t = x & 0xFCFCFCFCFCFCFCFCULL;              /* 0 iff code <= 3 */
    uint64_t ok = (((((t & lo7) + lo7) | t) & hi) ^ hi) >> 7;  /* 1 a byte */
    uint64_t c = x & (ok * 3);
    *v = (uint32_t)((ok * 0x0102040810204080ULL) >> 56);
    c = (c | (c >> 6)) & 0x000F000F000F000FULL;
    c = (c | (c >> 12)) & 0x000000FF000000FFULL;
    return (uint32_t)((c | (c >> 24)) & 0xFFFF);
}

int pack_batch(const unsigned char *codes, long long b, int length,
               uint32_t *words, int w, unsigned char *vbytes, int vb,
               uint16_t *vlen) {
    uint32_t any_bad = 0;
    for (long long r = 0; r < b; r++) {
        const unsigned char *row = codes + r * (long long)length;
        uint32_t *wrow = words + r * (long long)w;
        unsigned char *vrow = vbytes ? vbytes + r * (long long)vb : NULL;
        uint32_t closed = 0, bad = 0, count = 0, v, m;
        int p = 0;
#ifdef __AVX2__
        const __m256i three = _mm256_set1_epi8(3);
        const __m256i by4 = _mm256_set1_epi16(0x0401);       /* c0 + 4 c1 */
        const __m256i by16 = _mm256_set1_epi32(0x00100001);  /* + 16 (..) */
        const __m256i pick = _mm256_set1_epi32(0x0C080400); /* 0,4,8,12 */
        for (; p + 32 <= length; p += 32) {
            __m256i x = _mm256_loadu_si256((const __m256i *)(row + p));
            __m256i ok = _mm256_cmpeq_epi8(_mm256_min_epu8(x, three), x);
            __m256i c = _mm256_madd_epi16(
                _mm256_maddubs_epi16(_mm256_and_si256(x, ok), by4), by16);
            c = _mm256_shuffle_epi8(c, pick);     /* 16 codes a lane */
            wrow[p / 16] = (uint32_t)_mm_cvtsi128_si32(
                _mm256_castsi256_si128(c));
            wrow[p / 16 + 1] = (uint32_t)_mm_cvtsi128_si32(
                _mm256_extracti128_si256(c, 1));
            m = (uint32_t)_mm256_movemask_epi8(ok);
            if (vrow) memcpy(vrow + p / 8, &m, 4);
            count += (uint32_t)__builtin_popcount(m);
            PREFIX_STEP(m, 0xFFFFFFFFu);
        }
#endif
        for (; p < length; p += 8) {
            uint64_t x = 0x0404040404040404ULL;   /* past the row: invalid */
            if (p + 8 <= length) memcpy(&x, row + p, 8);
            else memcpy(&x, row + p, (size_t)(length - p));
            uint32_t bits = pack8(x, &v);
            if (p & 8) wrow[p / 16] |= bits << 16;
            else wrow[p / 16] = bits;
            if (vrow) vrow[p / 8] = (unsigned char)v;
            count += (uint32_t)__builtin_popcount(v);
            PREFIX_STEP(v, 0xFFu);
        }
        if (vlen) vlen[r] = (uint16_t)count;
        any_bad |= bad;
    }
    return any_bad == 0;
}
#undef PREFIX_STEP

/* ------------------------------------------------------------------ *
 * Sorted-uint64 set primitives for the CST builder's global id space
 * (build/tree_build.py "id_space" stage).  At E. coli scale the stage
 * binary-searches ~300M uint64 back into a 30M universe; a galloping
 * cursor over the already-sorted per-leaf arrays is faster and
 * verifies the closed-universe invariant for free.
 * ------------------------------------------------------------------ */

/* ids[i] = index of arr[i] in the ascending-sorted universe[0..nu).
   arr must be ascending too (per-leaf k-mer sets are np.unique output);
   a galloping cursor makes the whole array one forward sweep.
   Returns 0 when every element was found, 1 otherwise (closed-universe
   invariant violated — caller raises). */
int u64_lookup_sorted(const uint64_t *universe, long long nu,
                      const uint64_t *arr, long long n, int32_t *ids) {
    long long cur = 0;
    int miss = 0;
    for (long long i = 0; i < n; i++) {
        uint64_t x = arr[i];
        /* gallop forward from cur */
        long long lo = cur, step = 1;
        while (lo + step < nu && universe[lo + step] < x) {
            lo += step; step <<= 1;
        }
        long long hi = lo + step; if (hi > nu) hi = nu;
        while (lo < hi) {                       /* first index >= x */
            long long mid = lo + ((hi - lo) >> 1);
            if (universe[mid] < x) lo = mid + 1; else hi = mid;
        }
        if (lo >= nu || universe[lo] != x) {
            miss = 1;
            lo = lo < nu ? lo : (nu > 0 ? nu - 1 : 0);  /* nu==0: keep cur
                valid so the next gallop never reads universe[-1] */
        }
        ids[i] = (int32_t)lo;
        cur = lo;
    }
    return miss;
}

/* Sorted-set intersection / difference over unique ascending arrays —
   the CST builder's core algebra (build/tree_build.py _intersect /
   _setdiff).  np.intersect1d re-sorts the concatenation and setdiff1d
   re-sorts for in1d; for already-sorted inputs one linear merge (with a
   gallop when the sides are badly skewed) is several times faster.
   Output buffers: intersect needs min(na, nb) slots, diff needs na. */

#define SORTED_MERGE_OPS(T, SFX)                                          \
static long long gallop_##SFX(const T *b, long long nb, long long j, T x) { \
    long long step = 1;                                                   \
    while (j + step < nb && b[j + step] < x) { j += step; step <<= 1; }   \
    long long hi = j + step; if (hi > nb) hi = nb;                        \
    while (j < hi) {                                                      \
        long long mid = j + ((hi - j) >> 1);                              \
        if (b[mid] < x) j = mid + 1; else hi = mid;                       \
    }                                                                     \
    return j;                                                             \
}                                                                         \
long long SFX##_sorted_intersect(const T *a, long long na,                \
                                 const T *b, long long nb, T *out) {      \
    long long i = 0, j = 0, m = 0;                                        \
    int skew = (na > 32 * nb) || (nb > 32 * na);                          \
    while (i < na && j < nb) {                                            \
        if (a[i] < b[j]) {                                                \
            i++;                                                          \
            if (skew && i < na && a[i] < b[j])                            \
                i = gallop_##SFX(a, na, i, b[j]);                         \
        } else if (b[j] < a[i]) {                                         \
            j++;                                                          \
            if (skew && j < nb && b[j] < a[i])                            \
                j = gallop_##SFX(b, nb, j, a[i]);                         \
        } else { out[m++] = a[i]; i++; j++; }                             \
    }                                                                     \
    return m;                                                             \
}                                                                         \
long long SFX##_sorted_diff(const T *a, long long na,                     \
                            const T *b, long long nb, T *out) {           \
    long long i = 0, j = 0, m = 0;                                        \
    int skew = nb > 32 * na;                                              \
    while (i < na && j < nb) {                                            \
        if (a[i] < b[j]) { out[m++] = a[i]; i++; }                        \
        else if (b[j] < a[i]) {                                           \
            j++;                                                          \
            if (skew && j < nb && b[j] < a[i])                            \
                j = gallop_##SFX(b, nb, j, a[i]);                         \
        }                                                                 \
        else { i++; j++; }                                                \
    }                                                                     \
    while (i < na) out[m++] = a[i++];                                     \
    return m;                                                             \
}

SORTED_MERGE_OPS(int32_t, i32)
SORTED_MERGE_OPS(uint64_t, u64)

/* K-way merge-unique of already-sorted unique uint64 arrays — builds the
   CST id_space universe without materializing + re-sorting the 2.4 GB
   concatenation (the per-leaf Lv/spec sets are each np.unique output).
   Binary min-heap of (head value, source); out must hold sum(lens) in
   the worst case (only the unique prefix is written).  Returns the
   unique count. */
long long u64_kway_merge_unique(const uint64_t **arrs, const long long *lens,
                                int k, uint64_t *out) {
    typedef struct { uint64_t v; int s; } node_t;
    node_t *heap = (node_t *)malloc((size_t)(k > 0 ? k : 1) * sizeof(node_t));
    long long *pos = (long long *)calloc((size_t)(k > 0 ? k : 1),
                                         sizeof(long long));
    if (!heap || !pos) { free(heap); free(pos); return -1; }
    int hn = 0;
    for (int s = 0; s < k; s++) {
        if (lens[s] <= 0) continue;
        node_t n = { arrs[s][0], s };
        int i = hn++;                              /* sift up */
        while (i > 0) {
            int p = (i - 1) >> 1;
            if (heap[p].v <= n.v) break;
            heap[i] = heap[p]; i = p;
        }
        heap[i] = n;
    }
    long long m = 0;
    uint64_t last = 0; int have_last = 0;
    while (hn > 0) {
        node_t top = heap[0];
        if (!have_last || top.v != last) {
            out[m++] = top.v; last = top.v; have_last = 1;
        }
        int s = top.s;
        node_t n;
        if (++pos[s] < lens[s]) {
            n = (node_t){ arrs[s][pos[s]], s };
        } else {
            n = heap[--hn];
            if (hn == 0) break;
        }
        int i = 0;                                  /* sift down */
        for (;;) {
            int l = 2 * i + 1, r = l + 1, sm = i;
            if (l < hn && heap[l].v < n.v) sm = l;
            if (r < hn && heap[r].v < (sm == i ? n.v : heap[l].v)) sm = r;
            if (sm == i) break;
            heap[i] = heap[sm]; i = sm;
        }
        heap[i] = n;
    }
    free(heap); free(pos);
    return m;
}

/* ------------------------------------------------------------------ *
 * Positive Elastic-Net cyclic coordinate descent over the Gram
 * formulation, warm-started along a shared alpha path, independently
 * per CV fold.  Scalar float64 semantics mirror ops/enet.py::_cd_gram
 * (itself matched to sklearn's enet_coordinate_descent as used by the
 * reference at identify_strains_L2_Enet_Pscan_new_sp.py:433-456):
 * minimizes 0.5 w^T G w - b^T w + n*alpha*l1r*||w||_1
 *           + (n*alpha*(1-l1r)/2)*||w||^2.
 *
 * grams   [F, s, s] row-major; moments [F, s]; n_train [F]
 * alphas  [A] in path order (descending); out_w [A, F, s]
 * Returns 0 on success.
 * ------------------------------------------------------------------ */
int enet_cd_path(const double *grams, const double *moments,
                 const double *n_train, long long F, long long s,
                 const double *alphas, long long A, double l1_ratio,
                 long long max_iter, double tol, int positive,
                 double *out_w) {
    double *w = (double *)malloc((size_t)s * sizeof(double));
    double *q = (double *)malloc((size_t)s * sizeof(double));
    if (!w || !q) { free(w); free(q); return -1; }
    for (long long f = 0; f < F; f++) {
        const double *G = grams + f * s * s;
        const double *b = moments + f * s;
        double n = n_train[f];
        for (long long j = 0; j < s; j++) w[j] = 0.0;
        for (long long ai = 0; ai < A; ai++) {
            double alpha = alphas[ai];
            double l1 = n * alpha * l1_ratio;
            double l2 = n * alpha * (1.0 - l1_ratio);
            /* q = G @ w recomputed at every alpha entry (matches the
             * host path, which calls _cd_gram afresh per alpha) */
            for (long long i = 0; i < s; i++) {
                double acc = 0.0;
                const double *Gi = G + i * s;
                for (long long j = 0; j < s; j++) acc += Gi[j] * w[j];
                q[i] = acc;
            }
            for (long long it = 0; it < max_iter; it++) {
                double w_max = 0.0, d_w_max = 0.0;
                for (long long j = 0; j < s; j++) {
                    double dj = G[j * s + j];
                    double denom = dj + l2;
                    if (denom == 0.0) continue;
                    double rho = b[j] - q[j] + dj * w[j];
                    double neww;
                    if (positive) {
                        neww = rho - l1;
                        if (neww < 0.0) neww = 0.0;
                        neww /= denom;
                    } else {
                        double a = fabs(rho) - l1;
                        if (a < 0.0) a = 0.0;
                        neww = (rho > 0.0 ? a : (rho < 0.0 ? -a : 0.0))
                               / denom;
                    }
                    double delta = neww - w[j];
                    if (delta != 0.0) {
                        for (long long i = 0; i < s; i++)
                            q[i] += G[i * s + j] * delta;
                        w[j] = neww;
                    }
                    if (fabs(delta) > d_w_max) d_w_max = fabs(delta);
                    if (fabs(neww) > w_max) w_max = fabs(neww);
                }
                double wm = w_max > 1e-300 ? w_max : 1e-300;
                if (w_max == 0.0 || d_w_max / wm < tol) break;
            }
            double *out = out_w + (ai * F + f) * s;
            for (long long j = 0; j < s; j++) out[j] = w[j];
        }
    }
    free(w); free(q);
    return 0;
}
