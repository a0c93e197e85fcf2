// Native gz-FASTQ batch parser + 2-bit-code packer.
//
// The port's copy of megapath_tpu/native/fastq.cpp, built by
// megapath_tpu_torch/native.py (g++ -lz). The equivalent of the
// reference's async input thread (soap4/aio_thread.cpp +
// QueryParser.cpp): the host side of the pipeline parses gzip FASTQ into
// fixed-shape code/length batches. Python drives it from a reader thread
// (megapath_tpu_torch/io/stream.py), so parsing overlaps the engines'
// work like the reference's double-buffered AIO thread.
//
// Encoding matches megapath_tpu_torch.index.pack.encode_seq: A=0 C=1 G=2
// T=3, every other character -> 2 (the reference charMap sends N to G,
// soap4/IndexHandler.cpp:42-45).

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FqStream {
    gzFile fp = nullptr;
    std::string pending;   // carry-over partial line
    std::vector<char> buf;
    bool eof = false;

    bool next_line(std::string &out) {
        out.clear();
        for (;;) {
            size_t nl = pending.find('\n');
            if (nl != std::string::npos) {
                out.assign(pending, 0, nl);
                pending.erase(0, nl + 1);
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
            if (eof) {
                if (pending.empty()) return false;
                out.swap(pending);
                pending.clear();
                return true;
            }
            int got = gzread(fp, buf.data(), (unsigned)buf.size());
            if (got <= 0) {
                eof = true;
                continue;
            }
            pending.append(buf.data(), (size_t)got);
        }
    }
};

uint8_t g_code[256];

struct CodeInit {
    CodeInit() {
        memset(g_code, 2, sizeof(g_code));  // non-ACGT -> G
        g_code[(unsigned char)'A'] = 0; g_code[(unsigned char)'a'] = 0;
        g_code[(unsigned char)'C'] = 1; g_code[(unsigned char)'c'] = 1;
        g_code[(unsigned char)'G'] = 2; g_code[(unsigned char)'g'] = 2;
        g_code[(unsigned char)'T'] = 3; g_code[(unsigned char)'t'] = 3;
    }
} g_code_init;

}  // namespace

extern "C" {

void *fq_open(const char *path) {
    gzFile fp = gzopen(path, "rb");
    if (!fp) return nullptr;
    gzbuffer(fp, 1 << 20);
    FqStream *s = new FqStream();
    s->fp = fp;
    s->buf.resize(1 << 20);
    return s;
}

void fq_close(void *h) {
    if (!h) return;
    FqStream *s = (FqStream *)h;
    if (s->fp) gzclose(s->fp);
    delete s;
}

// Parse up to `cap` records. codes/quals are [cap, max_len] row-major
// (quals/seq_ascii raw ASCII, 0 past length), names [cap, name_cap] NUL-padded
// (truncated; the pair-end /1 /2 suffix is stripped like
// cc/fastq2lsam.cpp trim_readno). Returns records parsed, 0 at EOF,
// -1 on malformed input.
long long fq_next_batch(void *h, long long cap, int max_len,
                        uint8_t *codes, int32_t *lens, uint8_t *quals,
                        uint8_t *seq_ascii, char *names, int name_cap) {
    FqStream *s = (FqStream *)h;
    std::string line, seq, qual;
    long long n = 0;
    while (n < cap) {
        if (!s->next_line(line)) break;
        if (line.empty()) continue;
        bool fastq = line[0] == '@';
        if (!fastq && line[0] != '>') return -1;
        // name = up to first space/tab; strip /1 /2
        size_t end = line.find_first_of(" \t");
        size_t stop = (end == std::string::npos ? line.size() : end);
        size_t start = 1;
        size_t nl = stop - start;
        if (nl > 2 && line[stop - 2] == '/' &&
            (line[stop - 1] >= '0' && line[stop - 1] <= '9'))
            nl -= 2;
        if ((long long)nl > name_cap - 1) nl = name_cap - 1;
        char *nrow = names + n * name_cap;
        memcpy(nrow, line.data() + start, nl);
        memset(nrow + nl, 0, name_cap - nl);

        if (!s->next_line(seq)) return -1;
        if (fastq) {
            if (!s->next_line(line)) return -1;  // '+'
            if (!s->next_line(qual)) return -1;
        } else {
            // multiline FASTA: accumulate until the next header
            std::string more;
            while (s->next_line(more)) {
                if (!more.empty() && (more[0] == '>' || more[0] == '@')) {
                    s->pending.insert(0, more + "\n");  // push back
                    break;
                }
                seq += more;
            }
            qual.clear();
        }
        int L = (int)seq.size();
        if (L > max_len) L = max_len;
        uint8_t *crow = codes + n * (long long)max_len;
        uint8_t *qrow = quals + n * (long long)max_len;
        uint8_t *srow = seq_ascii + n * (long long)max_len;
        for (int i = 0; i < L; ++i) crow[i] = g_code[(unsigned char)seq[i]];
        memset(crow + L, 0, max_len - L);
        memcpy(srow, seq.data(), L);
        memset(srow + L, 0, max_len - L);
        if (fastq) {
            int QL = (int)qual.size();
            if (QL > L) QL = L;
            memcpy(qrow, qual.data(), QL);
            memset(qrow + QL, 0, max_len - QL);
        } else {
            memset(qrow, 'I', L);
            memset(qrow + L, 0, max_len - L);
        }
        lens[n] = L;
        ++n;
    }
    return n;
}

}  // extern "C"
