// Native FASTQ reader: zlib-backed gzip decode + record parsing into
// fixed-shape row buffers, the host data-loading hot path feeding device
// batches (the fastq_set ReadPair streaming analog,
// lib/rust/cr_lib/src/barcode_sort.rs:64-67, re-done as a C++ library bound
// via ctypes — no per-record Python object churn).
//
// Build: g++ -O3 -shared -fPIC fastq_reader.cpp -o libfastq_reader.so -lz

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t CHUNK = 1 << 20;

struct Reader {
    gzFile gz = nullptr;
    std::vector<char> buf;
    size_t start = 0;   // consumed prefix
    size_t end = 0;     // valid bytes
    bool eof = false;
    std::string err;

    bool fill() {
        if (eof) return end > start;
        if (start > 0) {
            memmove(buf.data(), buf.data() + start, end - start);
            end -= start;
            start = 0;
        }
        if (buf.size() - end < CHUNK) buf.resize(end + CHUNK);
        int n = gzread(gz, buf.data() + end, (unsigned)(buf.size() - end));
        if (n < 0) {
            int errnum = 0;
            err = gzerror(gz, &errnum);
            eof = true;
            return false;
        }
        if (n == 0) eof = true;
        end += (size_t)n;
        return end > start;
    }

    // next line [begin, len) excluding newline; returns false at EOF
    bool next_line(const char** begin, size_t* len) {
        for (;;) {
            const char* p = (const char*)memchr(buf.data() + start, '\n', end - start);
            if (p) {
                *begin = buf.data() + start;
                *len = (size_t)(p - (buf.data() + start));
                start = (size_t)(p - buf.data()) + 1;
                if (*len && (*begin)[*len - 1] == '\r') (*len)--;
                return true;
            }
            size_t before = end - start;
            if (!fill() || (eof && end - start == before)) {
                if (end > start) {  // final unterminated line
                    *begin = buf.data() + start;
                    *len = end - start;
                    start = end;
                    return true;
                }
                return false;
            }
        }
    }
};

}  // namespace

extern "C" {

void* fq_open(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    gzbuffer(gz, 1 << 20);
    auto* r = new Reader();
    r->gz = gz;
    r->buf.resize(CHUNK * 2);
    return r;
}

// Read up to max_records records. seqs/quals are [max_records, max_len]
// row-major byte buffers (0-padded; qual pads '!'); lens gets true sequence
// lengths (clipped to max_len reported, full length in full_lens);
// names: optional [max_records, name_stride] arena ('\0'-terminated,
// clipped), pass nullptr to skip. Returns #records, or -1 on parse error.
int fq_next_batch(void* h, int max_records, int max_len,
                  uint8_t* seqs, uint8_t* quals, int32_t* lens,
                  char* names, int name_stride) {
    auto* r = (Reader*)h;
    int n = 0;
    const char* line;
    size_t len;
    while (n < max_records) {
        if (!r->next_line(&line, &len)) break;  // EOF
        if (len == 0) continue;
        if (line[0] != '@') return -1;
        if (names) {
            size_t keep = len - 1;
            // name ends at first space
            const char* sp = (const char*)memchr(line + 1, ' ', keep);
            if (sp) keep = (size_t)(sp - line - 1);
            if (keep >= (size_t)name_stride) keep = (size_t)name_stride - 1;
            memcpy(names + (size_t)n * name_stride, line + 1, keep);
            names[(size_t)n * name_stride + keep] = '\0';
        }
        if (!r->next_line(&line, &len)) return -1;   // seq
        size_t sl = len;
        size_t copy = sl < (size_t)max_len ? sl : (size_t)max_len;
        memcpy(seqs + (size_t)n * max_len, line, copy);
        if (copy < (size_t)max_len)
            memset(seqs + (size_t)n * max_len + copy, 0, (size_t)max_len - copy);
        lens[n] = (int32_t)copy;
        if (!r->next_line(&line, &len)) return -1;   // '+'
        if (len == 0 || line[0] != '+') return -1;
        if (!r->next_line(&line, &len)) return -1;   // qual
        size_t qc = len < (size_t)max_len ? len : (size_t)max_len;
        memcpy(quals + (size_t)n * max_len, line, qc);
        if (qc < (size_t)max_len)
            memset(quals + (size_t)n * max_len + qc, '!', (size_t)max_len - qc);
        n++;
    }
    return n;
}

const char* fq_error(void* h) {
    auto* r = (Reader*)h;
    return r->err.c_str();
}

void fq_close(void* h) {
    auto* r = (Reader*)h;
    if (r->gz) gzclose(r->gz);
    delete r;
}

}  // extern "C"
