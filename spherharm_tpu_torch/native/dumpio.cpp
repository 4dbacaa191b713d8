// Native trajectory/data-file formatter: the hot host-side I/O path of
// spherharm_tpu_torch (a copy of spherharm_tpu/native/dumpio.cpp; the
// port imports nothing of the JAX package). A Python per-row loop
// dominates the dump cadence at N = 100k; this formats a whole frame in
// one call. Host C++, built with g++ and bound with ctypes
// (spherharm_tpu_torch/native/__init__.py).
//
// Exposed C ABI (ctypes):
//   sh_format_dump(rows, n_rows, n_cols, int_mask, header, out_cap, out)
//     rows:    double[n_rows * n_cols], row-major
//     int_mask: per-column 1 = integer formatting (%lld), 0 = %.8g
//     header:  full "ITEM: ..." preamble text (written verbatim)
//     returns bytes written, or -1 if out_cap too small.
//
//   sh_parse_table(text, n_rows, n_cols, out)
//     whitespace-separated numeric table -> double[n_rows * n_cols];
//     returns rows parsed (fast path for read_data / read_dump).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

extern "C" {

int64_t sh_format_dump(const double* rows, int64_t n_rows, int64_t n_cols,
                       const int32_t* int_mask, const char* header,
                       int64_t out_cap, char* out) {
    int64_t pos = 0;
    int64_t hlen = (int64_t)strlen(header);
    if (hlen >= out_cap) return -1;
    memcpy(out, header, (size_t)hlen);
    pos += hlen;
    for (int64_t r = 0; r < n_rows; ++r) {
        // Worst case ~ 24 chars per cell + separators.
        if (pos + 32 * n_cols + 2 > out_cap) return -1;
        const double* row = rows + r * n_cols;
        for (int64_t c = 0; c < n_cols; ++c) {
            if (c) out[pos++] = ' ';
            if (int_mask[c]) {
                pos += snprintf(out + pos, (size_t)(out_cap - pos), "%lld",
                                (long long)row[c]);
            } else {
                pos += snprintf(out + pos, (size_t)(out_cap - pos), "%.8g",
                                row[c]);
            }
        }
        out[pos++] = '\n';
    }
    return pos;
}

int64_t sh_parse_table(const char* text, int64_t n_rows, int64_t n_cols,
                       double* out) {
    const char* p = text;
    char* end = nullptr;
    for (int64_t r = 0; r < n_rows; ++r) {
        for (int64_t c = 0; c < n_cols; ++c) {
            double v = strtod(p, &end);
            if (end == p) return r;  // ran out of numbers
            out[r * n_cols + c] = v;
            p = end;
        }
    }
    return n_rows;
}

}  // extern "C"
