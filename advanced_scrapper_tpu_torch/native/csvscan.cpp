// Streaming RFC4180 CSV column scanner.
//
// The framework's resume anti-join re-reads the success/failed CSVs on
// every start (the reference does the same with pandas' C parser,
// constant_rate_scrapper.py:316-356).  Those files carry full article
// bodies — multi-GB after a long crawl — and the values contain commas,
// quotes and newlines, so a correct quoted-field state machine is
// required; a line-split fast path would mis-parse them.
//
// One pass, fixed 1 MiB read buffer, materialises only the header row and
// the target column's values.  Output: a malloc'd arena of NUL-terminated
// values back to back (count entries), freed by the caller via csv_free.
//
// Semantics mirror Python csv.DictReader on the default dialect:
//   - quoted fields may contain delimiters, CR/LF, and doubled quotes;
//   - completely blank rows are skipped;
//   - rows shorter than the header contribute no value for the column;
//   - rows longer than the header ignore the extras.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Scanner {
    std::string field;            // current field (materialised when needed)
    std::vector<std::string> header;
    std::string out;              // value arena
    long long count = 0;
    int col = 0;                  // current column index in this row
    int target = -1;              // resolved target column index
    bool in_quotes = false;
    bool after_quote = false;     // just saw a quote inside a quoted field
    bool at_field_start = true;   // no char consumed yet in this field
    bool row_started = false;     // any char or delimiter seen this row
    bool header_done = false;
    const char* want = nullptr;

    bool materialise() const {
        return !header_done || (target >= 0 && col == target);
    }

    void end_field() {
        if (!header_done) {
            header.push_back(field);
        } else if (target >= 0 && col == target) {
            out.append(field);
            out.push_back('\0');
            ++count;
        }
        field.clear();
        ++col;
        in_quotes = false;
        after_quote = false;
        at_field_start = true;
    }

    // returns false when the target column is absent from the header
    bool end_row() {
        if (!row_started) return true;  // blank line: skip (DictReader parity)
        end_field();
        if (!header_done) {
            header_done = true;
            // keep the LAST matching column: csv.DictReader's dict build
            // overwrites duplicates, so the last duplicate's values win —
            // the Python fallback and this scanner must agree
            for (size_t i = 0; i < header.size(); ++i) {
                if (want && header[i] == want) target = (int)i;
            }
            if (target < 0) return false;
        }
        col = 0;
        row_started = false;
        return true;
    }

    bool feed(const char* buf, size_t n) {
        for (size_t i = 0; i < n; ++i) {
            char c = buf[i];
            if (in_quotes) {
                if (after_quote) {
                    after_quote = false;
                    if (c == '"') { if (materialise()) field.push_back('"'); continue; }
                    in_quotes = false;
                    // fall through: c is an ordinary structural char now
                } else if (c == '"') {
                    after_quote = true;
                    continue;
                } else {
                    if (materialise()) field.push_back(c);
                    continue;
                }
            }
            // an opening quote only at field start; field.empty() would
            // misfire for non-materialised columns, whose buffer stays empty
            if (c == '"' && at_field_start) {
                in_quotes = true; row_started = true; at_field_start = false;
                continue;
            }
            if (c == ',') { row_started = true; end_field(); continue; }
            if (c == '\n') { if (!end_row()) return false; continue; }
            if (c == '\r') continue;  // CRLF / stray CR outside quotes
            row_started = true;
            at_field_start = false;
            if (materialise()) field.push_back(c);
        }
        return true;
    }

    bool finish() {
        if (in_quotes && after_quote) { in_quotes = false; after_quote = false; }
        if (row_started) return end_row();
        return true;
    }
};

}  // namespace

extern "C" {

char* csv_scan_column(const char* path, const char* column,
                      long long* count, long long* nbytes) {
    *count = 0;
    *nbytes = 0;
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    Scanner s;
    s.want = column;
    std::vector<char> buf(1 << 20);
    bool ok = true;
    size_t n;
    while (ok && (n = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
        ok = s.feed(buf.data(), n);
    }
    std::fclose(f);
    if (!ok || !s.finish()) return nullptr;
    char* arena = (char*)std::malloc(s.out.size() ? s.out.size() : 1);
    if (!arena) return nullptr;
    std::memcpy(arena, s.out.data(), s.out.size());
    *count = s.count;
    *nbytes = (long long)s.out.size();
    return arena;
}

void csv_free(char* p) { std::free(p); }

}  // extern "C"
