/* fast_reader — delimited text → columnar parser, the port's copy of
 * `shifu_tpu/native/fast_reader.c` (same parse, same results).
 *
 * One mmap'd pass, pthread-parallel over newline-aligned row ranges,
 * emitting
 *   - float32 row-major (R x n_num) values for the numeric column
 *     subset (unparseable/missing tokens -> NaN, the framework's missing
 *     encoding; tokens parse with strtof), and
 *   - (offset, length) field slices for the string column subset, so
 *     Python materializes only the few categorical/meta columns.
 *
 * Built with the host C compiler by `shifu_tpu_torch/data/native_reader.py`
 * into `shifu_tpu_torch/build/` and loaded with ctypes. It keeps no state
 * between calls: every function works on its arguments only.
 */

#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

typedef struct {
    const char *data;
    int64_t begin;          /* byte offset of first row in this chunk  */
    int64_t end;            /* byte offset one past last row           */
    int64_t row0;           /* global row index of first row           */
    char delim;
    int n_cols;
    const int32_t *num_idx; /* per-column: output slot or -1           */
    int n_num;
    float *num_out;         /* (n_rows, n_num) row-major               */
    const int32_t *str_idx; /* per-column: output slot or -1           */
    int n_str;
    int64_t *str_off;       /* (n_rows, n_str)                         */
    int32_t *str_len;       /* (n_rows, n_str)                         */
} chunk_t;

float ft_parse_field(const char *p, int len) {
    char buf[64];
    char *endp;
    if (len <= 0 || len >= (int)sizeof(buf)) return __builtin_nanf("");
    memcpy(buf, p, (size_t)len);
    buf[len] = '\0';
    float v = strtof(buf, &endp);
    /* trailing junk (or an empty/garbage token) means "not a number" */
    while (*endp == ' ' || *endp == '\t' || *endp == '\r') endp++;
    if (endp == buf || *endp != '\0') return __builtin_nanf("");
    return v;
}

void *ft_parse_chunk(void *arg) {
    chunk_t *c = (chunk_t *)arg;
    const char *data = c->data;
    int64_t pos = c->begin, row = c->row0;
    while (pos < c->end) {
        int64_t line_end = pos;
        while (line_end < c->end && data[line_end] != '\n') line_end++;
        /* blank lines (empty or lone \r) are not rows — match pandas
         * skip_blank_lines */
        if (line_end == pos ||
            (line_end == pos + 1 && data[pos] == '\r')) {
            pos = line_end + 1;
            continue;
        }
        int64_t field_start = pos;
        int col = 0;
        for (int64_t i = pos; i <= line_end && col < c->n_cols; i++) {
            if (i == line_end || data[i] == c->delim) {
                int64_t fs = field_start;
                int64_t fe = i;
                /* trim spaces and a trailing \r on the last field */
                while (fs < fe && (data[fs] == ' ' || data[fs] == '\t')) fs++;
                while (fe > fs && (data[fe - 1] == ' ' || data[fe - 1] == '\t'
                                   || data[fe - 1] == '\r')) fe--;
                int32_t slot = c->num_idx[col];
                if (slot >= 0)
                    c->num_out[row * c->n_num + slot] =
                        ft_parse_field(data + fs, (int)(fe - fs));
                slot = c->str_idx[col];
                if (slot >= 0) {
                    c->str_off[row * c->n_str + slot] = fs;
                    c->str_len[row * c->n_str + slot] = (int32_t)(fe - fs);
                }
                field_start = i + 1;
                col++;
            }
        }
        /* short rows: remaining numeric slots stay NaN (pre-filled) */
        row++;
        pos = line_end + 1;
    }
    return NULL;
}

/* Count non-blank data rows (newline-terminated lines plus an
 * unterminated tail); blank lines are skipped like in ft_parse_chunk. */
int64_t ft_count_rows(const char *data, int64_t size) {
    int64_t n = 0;
    const char *p = data, *end = data + size;
    while (p < end) {
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        const char *line_end = nl ? nl : end;
        int64_t len = line_end - p;
        if (!(len == 0 || (len == 1 && p[0] == '\r'))) n++;
        if (!nl) break;
        p = nl + 1;
    }
    return n;
}

/* Parse one mmap'd buffer. skip: leading rows to drop (in-file header).
 * Returns number of parsed rows, or -1 on error. Output arrays must be
 * sized for at least (total_rows - skip) rows; num_out pre-filled NaN
 * by the caller. */
int64_t ft_parse_buffer(const char *data, int64_t size, char delim,
                        int skip, int n_cols,
                        const int32_t *num_idx, int n_num, float *num_out,
                        const int32_t *str_idx, int n_str,
                        int64_t *str_off, int32_t *str_len,
                        int n_threads) {
    int64_t start = 0;
    for (int s = 0; s < skip && start < size; s++) {
        const char *nl = memchr(data + start, '\n', (size_t)(size - start));
        if (!nl) return 0;
        start = (nl - data) + 1;
    }
    int64_t n_rows = ft_count_rows(data + start, size - start);
    if (n_rows <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;

    /* newline-aligned chunk boundaries + per-chunk starting row */
    chunk_t chunks[64];
    pthread_t tids[64];
    int used = 0;
    int64_t bytes = size - start;
    int64_t row_acc = 0, prev_end = start;
    for (int t = 0; t < n_threads && prev_end < size; t++) {
        int64_t target = (t == n_threads - 1)
            ? size : start + bytes * (t + 1) / n_threads;
        if (target < prev_end) target = prev_end;
        if (target < 1) target = 1; /* data[target-1] below needs >=1 */
        /* advance to the end of the current line */
        while (target < size && data[target - 1] != '\n') target++;
        chunk_t *c = &chunks[used];
        c->data = data; c->begin = prev_end; c->end = target;
        c->row0 = row_acc; c->delim = delim; c->n_cols = n_cols;
        c->num_idx = num_idx; c->n_num = n_num; c->num_out = num_out;
        c->str_idx = str_idx; c->n_str = n_str;
        c->str_off = str_off; c->str_len = str_len;
        row_acc += ft_count_rows(data + c->begin, c->end - c->begin);
        prev_end = target;
        used++;
    }
    for (int t = 0; t < used; t++)
        pthread_create(&tids[t], NULL, ft_parse_chunk, &chunks[t]);
    for (int t = 0; t < used; t++)
        pthread_join(tids[t], NULL);
    return row_acc;
}

/* Convenience: mmap a file and parse it. Returns rows parsed or -1. */
int64_t ft_parse_file(const char *path, char delim, int skip, int n_cols,
                      const int32_t *num_idx, int n_num, float *num_out,
                      const int32_t *str_idx, int n_str,
                      int64_t *str_off, int32_t *str_len, int n_threads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    if (st.st_size == 0) { close(fd); return 0; }
    char *data = (char *)mmap(NULL, (size_t)st.st_size, PROT_READ,
                              MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;
    int64_t n = ft_parse_buffer(data, st.st_size, delim, skip, n_cols,
                                num_idx, n_num, num_out,
                                str_idx, n_str, str_off, str_len,
                                n_threads);
    munmap(data, (size_t)st.st_size);
    return n;
}

int64_t ft_count_file_rows(const char *path, int skip) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    if (st.st_size == 0) { close(fd); return 0; }
    char *data = (char *)mmap(NULL, (size_t)st.st_size, PROT_READ,
                              MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;
    int64_t n = ft_count_rows(data, st.st_size) - skip;
    munmap(data, (size_t)st.st_size);
    return n < 0 ? 0 : n;
}
