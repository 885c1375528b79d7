// Output TSV rows: native host-side formatting of the pipeline's output.
//
// Formats a block of rows of the reference-format pipeline TSV (reference
// src/PhyloHMM.cpp:244-327) into one caller-sized buffer, in one call: the
// numeric columns, the Newick with its bracketed comments stripped, and each
// row's annotation tail (tab-joined by the caller).  The bytes equal the
// Python writer's (io/output_tsv.py), which joins `str()` of numpy scalars:
// integers in decimal, floats in Python's repr(float) layout.
//
// C ABI only; bound from Python via ctypes, which releases the GIL for the
// call.  Built only where the standard library has floating-point
// std::to_chars (libstdc++ 11 on); without it the symbol is absent and
// Python formats the rows.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__cpp_lib_to_chars) && \
    (!defined(_GLIBCXX_RELEASE) || _GLIBCXX_RELEASE >= 11)

namespace {

constexpr int kHead = 13;      // RB log-likelihood, prior, alpha, er[6], pi[4]
constexpr long kMaxField = 32;  // a formatted number and its separator

char* put_text(char* p, const char* s, long n) {
  std::memcpy(p, s, static_cast<size_t>(n));
  return p + n;
}

// repr(float): the shortest digits that read back as `x`, in fixed
// notation for decimal exponents -4 to 15 (".0" after an integral value),
// else d.ddde±XX with at least two exponent digits.
char* put_double(char* p, double x) {
  if (std::isnan(x)) return put_text(p, "nan", 3);
  if (std::signbit(x)) *p++ = '-';
  if (std::isinf(x)) return put_text(p, "inf", 3);
  if (x == 0) return put_text(p, "0.0", 3);
  char sci[32];
  const char* end =
      std::to_chars(sci, sci + sizeof sci, std::fabs(x),
                    std::chars_format::scientific).ptr;
  char digits[24];
  int nd = 0;
  const char* q = sci;
  for (; *q != 'e'; ++q) {
    if (*q != '.') digits[nd++] = *q;
  }
  ++q;  // 'e'
  const bool neg_exp = *q++ == '-';
  int e = 0;
  for (; q < end; ++q) e = e * 10 + (*q - '0');
  if (neg_exp) e = -e;

  if (e < -4 || e > 15) {
    *p++ = digits[0];
    if (nd > 1) {
      *p++ = '.';
      p = put_text(p, digits + 1, nd - 1);
    }
    *p++ = 'e';
    *p++ = e < 0 ? '-' : '+';
    const int a = e < 0 ? -e : e;
    if (a < 10) *p++ = '0';
    return std::to_chars(p, p + 4, a).ptr;
  }
  if (e < 0) {
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -e - 1; ++i) *p++ = '0';
    return put_text(p, digits, nd);
  }
  if (nd <= e + 1) {
    p = put_text(p, digits, nd);
    for (int i = nd; i <= e; ++i) *p++ = '0';
    return put_text(p, ".0", 2);
  }
  p = put_text(p, digits, e + 1);
  *p++ = '.';
  return put_text(p, digits + e + 1, nd - e - 1);
}

// The Newick without its comments: each '[' through the first ']' after
// it is dropped; a '[' that no ']' closes stays, with the rest of the text.
char* put_newick(char* p, const char* s, const char* end) {
  while (s < end) {
    const char* open =
        static_cast<const char*>(std::memchr(s, '[', end - s));
    if (!open) return put_text(p, s, end - s);
    const char* close =
        static_cast<const char*>(std::memchr(open, ']', end - open));
    if (!close) return put_text(p, s, end - s);
    p = put_text(p, s, open - s);
    s = close + 1;
  }
  return p;
}

}  // namespace

// Rows i = 0..n-1: iteration[i], head[i, 0..12], the Newick
// newicks[newick_off[i]:newick_off[i+1]] stripped of comments,
// tail[i, 0..n_tail-1] (sr[1..R], LH log-likelihood, LogWeight), then
// annots[annot_off[i]:annot_off[i+1]], tab-separated, each row ending in
// '\n'.  Returns the bytes written to `out`, or -1 where `out_cap` is too
// small for the block.
extern "C" long lh_format_output_rows(
    long n, long n_tail,
    const int64_t* iteration,      // [n]
    const double* head,            // [n, 13], row-major
    const char* newicks, const int64_t* newick_off,  // [n + 1]
    const double* tail,            // [n, n_tail], row-major
    const char* annots, const int64_t* annot_off,    // [n + 1]
    char* out, long out_cap) {
  char* p = out;
  char* const stop = out + out_cap;
  const long numbers = 1 + kHead + n_tail;
  for (long i = 0; i < n; ++i) {
    const char* nw = newicks + newick_off[i];
    const long nw_len = newick_off[i + 1] - newick_off[i];
    const char* an = annots + annot_off[i];
    const long an_len = annot_off[i + 1] - annot_off[i];
    if (stop - p < numbers * kMaxField + nw_len + an_len + 4) return -1;
    p = std::to_chars(p, p + kMaxField, iteration[i]).ptr;
    for (int k = 0; k < kHead; ++k) {
      *p++ = '\t';
      p = put_double(p, head[i * kHead + k]);
    }
    *p++ = '\t';
    p = put_newick(p, nw, nw + nw_len);
    for (long k = 0; k < n_tail; ++k) {
      *p++ = '\t';
      p = put_double(p, tail[i * n_tail + k]);
    }
    *p++ = '\t';
    p = put_text(p, an, an_len);
    *p++ = '\n';
  }
  return static_cast<long>(p - out);
}

#endif  // floating-point std::to_chars
