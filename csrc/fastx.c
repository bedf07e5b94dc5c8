/* Native FASTA/FASTQ(.gz) batch reader + 2-bit encoder.
 *
 * Batched equivalent of the reference's kseq streaming layer
 * (src/lib/utils.h kseq macros): the host runtime's job here is to turn a
 * (possibly gzipped) FASTX stream into padded 2-bit batches the device
 * consumes, as fast as the wire allows. Exposed via ctypes (no pybind11
 * in this image); see desamba_tpu/io/native.py.
 *
 * Build: cc -O3 -shared -fPIC -o libdesfastx.so fastx.c -lz
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

/* CLY_Bit encoding (reference src/cly.c:17-35): ACGT->0..3, everything
 * else (incl. N) -> 1 ('C'). */
static uint8_t CODE[256];
static int code_init = 0;
static void init_code(void) {
    if (code_init) return;
    for (int i = 0; i < 256; i++) CODE[i] = 1;
    CODE['A'] = CODE['a'] = 0;
    CODE['C'] = CODE['c'] = 1;
    CODE['G'] = CODE['g'] = 2;
    CODE['T'] = CODE['t'] = 3;
    code_init = 1;
}

typedef struct {
    gzFile fp;
    char *line;
    size_t cap;
    int pushed;     /* line already read (lookahead) */
} FastxReader;

static int read_line(FastxReader *r) {
    size_t len = 0;
    if (!r->line) { r->cap = 1 << 16; r->line = malloc(r->cap); }
    for (;;) {
        if (len + 4096 > r->cap) { r->cap <<= 1; r->line = realloc(r->line, r->cap); }
        if (gzgets(r->fp, r->line + len, (int)(r->cap - len)) == NULL)
            return len > 0 ? (int)len : -1;
        len += strlen(r->line + len);
        if (len > 0 && r->line[len - 1] == '\n') {
            r->line[--len] = 0;
            if (len > 0 && r->line[len - 1] == '\r') r->line[--len] = 0;
            return (int)len;
        }
    }
}

void *fastx_open(const char *path) {
    init_code();
    gzFile fp = gzopen(path, "rb");
    if (!fp) return NULL;
    gzbuffer(fp, 1 << 20);
    FastxReader *r = calloc(1, sizeof(FastxReader));
    r->fp = fp;
    return r;
}

void fastx_close(void *h) {
    FastxReader *r = h;
    if (!r) return;
    gzclose(r->fp);
    free(r->line);
    free(r);
}

/* Read up to max_reads records. Outputs:
 *   names   : '\n'-joined headers (name + ' ' + comment), cap names_cap
 *   seqs    : raw sequence bytes, concatenated, cap seqs_cap
 *   quals   : quality bytes ('\0' marker rows for FASTA), same layout
 *   lens    : per-read sequence length
 * Returns number of records read (0 = EOF, -1 = error/overflow).
 * Caller sizes buffers; on overflow the reader keeps the record pending
 * and returns what fit so far. */
int64_t fastx_read_batch(void *h, int64_t max_reads, int64_t max_bases,
                         char *names, int64_t names_cap, char *seqs,
                         uint8_t *has_qual, char *quals, int64_t *lens) {
    FastxReader *r = h;
    int64_t n = 0, base_total = 0, name_off = 0;
    int64_t seq_off = 0;
    while (n < max_reads && base_total < max_bases) {
        int len;
        if (r->pushed) { len = (int)strlen(r->line); r->pushed = 0; }
        else {
            len = read_line(r);
            if (len < 0) break;
        }
        if (len == 0) continue;
        char type = r->line[0];
        if (type != '>' && type != '@') return -1;
        int64_t hlen = len - 1;
        if (name_off + hlen + 1 > names_cap) { r->pushed = 1; break; }
        memcpy(names + name_off, r->line + 1, hlen);
        names[name_off + hlen] = '\n';
        name_off += hlen + 1;
        /* sequence lines */
        int64_t slen = 0;
        if (type == '@') {
            len = read_line(r);
            if (len < 0) return -1;
            memcpy(seqs + seq_off, r->line, len);
            slen = len;
            if (read_line(r) < 0) return -1;   /* '+' */
            len = read_line(r);                 /* qual */
            if (len < 0) return -1;
            memcpy(quals + seq_off, r->line, len);
            has_qual[n] = 1;
        } else {
            for (;;) {
                len = read_line(r);
                if (len < 0) break;
                if (r->line[0] == '>' || r->line[0] == '@') { r->pushed = 1; break; }
                memcpy(seqs + seq_off, r->line, len);
                slen += len;
                seq_off += len;
            }
            seq_off -= slen;
            has_qual[n] = 0;
        }
        lens[n] = slen;
        seq_off += slen;
        base_total += slen;
        n++;
    }
    return n;
}

/* Encode ASCII bases into the classify engine's F+R buffer layout:
 * out[0:len] = 2-bit codes, out[len:2*len] = reverse complement. */
void fastx_encode_fr(const char *seq, int64_t len, uint8_t *out) {
    init_code();
    for (int64_t i = 0; i < len; i++) {
        uint8_t c = CODE[(uint8_t)seq[i]];
        out[i] = c;
        out[2 * len - 1 - i] = 3 - c;
    }
}

/* Batch variant: encode n sequences (concatenated, lens[]) into a padded
 * (n, 2*pad_len) uint8 matrix. */
void fastx_encode_batch(const char *seqs, const int64_t *lens, int64_t n,
                        int64_t pad_len, uint8_t *out) {
    init_code();
    int64_t off = 0;
    for (int64_t i = 0; i < n; i++) {
        const char *s = seqs + off;
        uint8_t *row = out + i * 2 * pad_len;
        int64_t len = lens[i];
        for (int64_t j = 0; j < len; j++) {
            uint8_t c = CODE[(uint8_t)s[j]];
            row[j] = c;
            row[2 * len - 1 - j] = 3 - c;
        }
        off += len;
    }
}
