// RevBayes posterior-sample TSV parser: native host-side ingestion kernel.
//
// Parses the in-memory bytes of a RevBayes `.trees` file (tab-separated;
// required columns Iteration, Likelihood, Prior, alpha, er[1..6], pi[1..4],
// tree; extra columns ignored) into a dense [rows, 14] numeric matrix plus
// (offset, length) spans of the newick column within the original buffer.
// The reference's equivalent native boundary is the vendored
// fast-cpp-csv-parser stream in RunPipeline (reference src/PhyloHMM.cpp:396,
// 414-426); the Python fallback lives in linearham_tpu/io/trees_tsv.py.
//
// C ABI only; bound from Python via ctypes (no pybind11 in this image).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNumeric = 14;  // Iteration, Likelihood, Prior, alpha,
                              // er[1..6], pi[1..4]

void set_err(char* err, long errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// Split one line [begin, end) on tabs into spans.
void split_tabs(const char* begin, const char* end,
                std::vector<std::pair<const char*, const char*>>* out) {
  out->clear();
  const char* field = begin;
  for (const char* p = begin; p <= end; ++p) {
    if (p == end || *p == '\t') {
      out->push_back({field, p});
      field = p + 1;
    }
  }
}

std::string trim(const char* b, const char* e) {
  while (b < e && (*b == ' ' || *b == '\r' || *b == '"')) ++b;
  while (e > b && (e[-1] == ' ' || e[-1] == '\r' || e[-1] == '"')) --e;
  return std::string(b, e);
}

}  // namespace

extern "C" int lh_parse_trees_tsv(
    const char* data, long len,
    long max_rows,
    long* n_rows_out,
    double* numeric,      // [max_rows, 14], row-major
    long* tree_off,       // [max_rows] byte offset of newick in `data`
    long* tree_len,       // [max_rows]
    char* err, long errlen) {
  if (!data || len <= 0) {
    set_err(err, errlen, "empty TSV buffer");
    return 1;
  }
  const char* end = data + len;

  // --- header ---------------------------------------------------------
  const char* nl = static_cast<const char*>(memchr(data, '\n', len));
  if (!nl) {
    set_err(err, errlen, "TSV has no newline-terminated header");
    return 1;
  }
  std::vector<std::pair<const char*, const char*>> fields;
  split_tabs(data, nl, &fields);

  const char* names[kNumeric + 1] = {
      "Iteration", "Likelihood", "Prior", "alpha",
      "er[1]", "er[2]", "er[3]", "er[4]", "er[5]", "er[6]",
      "pi[1]", "pi[2]", "pi[3]", "pi[4]", "tree"};
  int col_of[kNumeric + 1];
  for (int c = 0; c <= kNumeric; ++c) {
    col_of[c] = -1;
    for (size_t f = 0; f < fields.size(); ++f) {
      if (trim(fields[f].first, fields[f].second) == names[c]) {
        col_of[c] = static_cast<int>(f);
        break;
      }
    }
    if (col_of[c] < 0) {
      // Same phrasing as the Python loader's error contract.
      set_err(err, errlen,
              std::string("TSV lacks required columns: ") + names[c]);
      return 1;
    }
  }

  // --- rows -----------------------------------------------------------
  long row = 0;
  const char* line = nl + 1;
  while (line < end) {
    const char* nl2 = static_cast<const char*>(
        memchr(line, '\n', static_cast<size_t>(end - line)));
    const char* le = nl2 ? nl2 : end;
    // One past the newline, but never past one-past-the-end (UB).
    const char* next = nl2 ? nl2 + 1 : end;
    while (le > line && le[-1] == '\r') --le;  // CRLF line endings
    if (le > line) {  // skip blank lines
      if (row >= max_rows) {
        set_err(err, errlen, "TSV has more rows than the caller allocated");
        return 1;
      }
      split_tabs(line, le, &fields);
      for (int c = 0; c < kNumeric; ++c) {
        if (static_cast<size_t>(col_of[c]) >= fields.size()) {
          set_err(err, errlen,
                  "row " + std::to_string(row) + " is missing column " +
                      names[c]);
          return 1;
        }
        auto [fb, fe] = fields[col_of[c]];
        char* pe = nullptr;
        std::string tok = trim(fb, fe);
        numeric[row * kNumeric + c] = std::strtod(tok.c_str(), &pe);
        if (pe == tok.c_str()) {
          set_err(err, errlen,
                  "row " + std::to_string(row) + " column " + names[c] +
                      " is not numeric: '" + tok + "'");
          return 1;
        }
      }
      if (static_cast<size_t>(col_of[kNumeric]) >= fields.size()) {
        set_err(err, errlen, "row " + std::to_string(row) +
                                 " is missing the tree column");
        return 1;
      }
      auto [tb, te] = fields[col_of[kNumeric]];
      while (tb < te && (*tb == ' ' || *tb == '"')) ++tb;
      while (te > tb && (te[-1] == ' ' || te[-1] == '\r' || te[-1] == '"'))
        --te;
      tree_off[row] = tb - data;
      tree_len[row] = te - tb;
      ++row;
    }
    line = next;
  }
  if (row == 0) {
    set_err(err, errlen, "TSV contains no posterior samples");
    return 1;
  }
  *n_rows_out = row;
  return 0;
}
