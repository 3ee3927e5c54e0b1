// Native numeric-CSV parser (the port's copy of
// deeplearning4j_tpu/native/fastcsv.cpp, unchanged in what it computes).
//
// A single-allocation two-pass parser that turns a numeric CSV straight into
// a float32 matrix at C speed, for `datasets/records.py`'s
// `CSVRecordReader.numeric_matrix`. deeplearning4j_tpu_torch/native/
// __init__.py builds this file with g++ at first use into build/native/ and
// loads it with ctypes (no pybind11). A file that is not uniformly numeric
// goes to the Python reader (`_read_csv_rows`), which gives the same matrix.
//
// Exported contract (all returns: 0 ok, -1 file error, -2 non-numeric
// field, -3 ragged rows):
//   csv_dims(path, delim, skip, &rows, &cols)   -- count data rows/cols
//   csv_parse(path, delim, skip, out, rows, cols) -- fill out[rows*cols]

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read the whole file + a trailing NUL (so strtof can never overrun);
// empty vector on failure. The NUL is part of the vector: use
// `content_end()` for the logical end of the file data.
std::vector<char> slurp(const char* path) {
    std::vector<char> buf;
    FILE* f = std::fopen(path, "rb");
    if (!f) return buf;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n > 0) {
        buf.resize(static_cast<size_t>(n) + 1);
        if (std::fread(buf.data(), 1, static_cast<size_t>(n), f) !=
            static_cast<size_t>(n)) {
            buf.clear();
        } else {
            buf.back() = '\0';
        }
    }
    std::fclose(f);
    return buf;
}

struct LineWalker {
    const char* p;
    const char* end;
    explicit LineWalker(const std::vector<char>& b)  // excludes the NUL
        : p(b.data()), end(b.data() + b.size() - 1) {}
    // Next line [begin, stop) INCLUDING blank ones (callers count every
    // line toward `skip`, exactly like the Python csv.reader fallback,
    // then drop blanks); false at EOF.
    bool next(const char** begin, const char** stop) {
        if (p >= end) return false;
        const char* line = p;
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* e = nl ? nl : end;
        p = nl ? nl + 1 : end;
        if (e > line && e[-1] == '\r') --e;
        *begin = line;
        *stop = e;
        return true;
    }
};

long count_fields(const char* b, const char* e, char delim) {
    long n = 1;
    for (const char* q = b; q < e; ++q)
        if (*q == delim) ++n;
    return n;
}

}  // namespace

extern "C" {

long csv_dims(const char* path, char delim, long skip, long* rows,
              long* cols) {
    std::vector<char> buf = slurp(path);
    if (buf.empty()) return -1;
    LineWalker w(buf);
    const char *b, *e;
    long line_no = 0, nrows = 0, ncols = 0;
    while (w.next(&b, &e)) {
        if (line_no++ < skip) {
            // A quoted field in the skipped region can span lines: the
            // Python csv.reader fallback counts LOGICAL rows toward skip,
            // this walker counts physical lines. Punt to the fallback the
            // moment a quote shows up so the two paths can never start
            // data at different rows.
            if (std::memchr(b, '"', static_cast<size_t>(e - b))) return -2;
            continue;
        }
        if (b == e) continue;  // blank line (counted toward skip above)
        long c = count_fields(b, e, delim);
        if (ncols == 0) ncols = c;
        else if (c != ncols) return -3;
        ++nrows;
    }
    *rows = nrows;
    *cols = ncols;
    return 0;
}

long csv_parse(const char* path, char delim, long skip, float* out,
               long rows, long cols) {
    std::vector<char> buf = slurp(path);
    if (buf.empty()) return -1;
    LineWalker w(buf);
    const char *b, *e;
    long line_no = 0, r = 0;
    while (w.next(&b, &e)) {
        if (line_no++ < skip) {
            // Match csv_dims: quoted skip regions go to the Python fallback.
            if (std::memchr(b, '"', static_cast<size_t>(e - b))) return -2;
            continue;
        }
        if (b == e) continue;  // blank line
        if (r >= rows) return -3;
        long c = 0;
        const char* q = b;
        while (q <= e) {
            const char* field_end = q;
            while (field_end < e && *field_end != delim) ++field_end;
            if (c >= cols || field_end == q) return -2;
            // strtof directly on the buffer: the delimiter/newline byte
            // after the field stops the parse (slurp() NUL-terminates the
            // whole buffer so the final field is safe too).
            // Python float() rejects C hex-float literals; stay in sync
            // so the native and the Python path never disagree on a file.
            for (const char* hx = q; hx < field_end; ++hx)
                if (*hx == 'x' || *hx == 'X') return -2;
            char* endp = nullptr;
            float v = std::strtof(q, &endp);
            while (endp < field_end && *endp == ' ') ++endp;
            if (endp != field_end) return -2;
            out[r * cols + c] = v;
            ++c;
            q = field_end + 1;
            if (field_end == e) break;
        }
        if (c != cols) return -3;
        ++r;
    }
    return r == rows ? 0 : -3;
}

}  // extern "C"
