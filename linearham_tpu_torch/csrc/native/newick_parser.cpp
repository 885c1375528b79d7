// Batch Newick parser: the native host-side ingestion kernel.
//
// Parses a batch of Newick strings (one per posterior tree sample) into
// the flat padded arrays the pruning kernel consumes: per-tip parent
// slots/branch lengths with tips mapped onto a caller-supplied label
// order, plus post-ordered internal edges.  Node comments ([...]) are
// skipped, missing branch lengths take a default, and unary chains are
// collapsed by summing lengths.
//
// This replaces the per-sample Python parse (linearham_tpu/io/newick.py)
// on the hot path; the reference's equivalent native boundary is libpll's
// pll_utree_parse_newick_string (reference src/PhyloHMM.cpp:421).
//
// C ABI only; bound from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  int first_child = -1;   // linked list of children
  int next_sibling = -1;
  double length = NAN;
  std::string label;
  bool has_children() const { return first_child >= 0; }
};

struct Parser {
  const char* s;
  size_t pos = 0;
  std::vector<Node> nodes;
  std::string error;

  void skip_space_comments() {
    for (;;) {
      while (isspace((unsigned char)s[pos])) pos++;
      if (s[pos] == '[') {
        while (s[pos] && s[pos] != ']') pos++;
        if (s[pos] == ']') pos++;
        continue;
      }
      break;
    }
  }

  int parse_node() {  // returns node index or -1 on error
    int me = (int)nodes.size();
    nodes.emplace_back();
    skip_space_comments();
    if (s[pos] == '(') {
      pos++;
      int prev = -1;
      for (;;) {
        int child = parse_node();
        if (child < 0) return -1;
        if (prev < 0)
          nodes[me].first_child = child;
        else
          nodes[prev].next_sibling = child;
        prev = child;
        skip_space_comments();
        if (s[pos] == ',') { pos++; continue; }
        if (s[pos] == ')') { pos++; break; }
        error = "expected ',' or ')'";
        return -1;
      }
    }
    skip_space_comments();
    // label
    size_t start = pos;
    while (s[pos] && !strchr("(),;:[", s[pos]) &&
           !isspace((unsigned char)s[pos]))
      pos++;
    nodes[me].label.assign(s + start, pos - start);
    skip_space_comments();
    if (s[pos] == ':') {
      pos++;
      skip_space_comments();
      char* end = nullptr;
      nodes[me].length = strtod(s + pos, &end);
      if (end == s + pos) { error = "bad branch length"; return -1; }
      pos = end - s;
      skip_space_comments();
    }
    return me;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; nonzero writes a message into err.
// All output arrays are caller-allocated with per-tree strides max_tips /
// max_edges; labels_cat is the NUL-separated alignment row label order.
int lh_parse_newicks(
    const char** texts, long n_trees, double default_branch_length,
    const char* labels_cat, long n_labels, long max_tips, long max_edges,
    int* n_internal_out,        // [n_trees]
    int* tip_perm,              // [n_trees, max_tips] alignment row per slot
    int* tip_parent,            // [n_trees, max_tips]
    double* tip_length,         // [n_trees, max_tips]
    int* edge_child,            // [n_trees, max_edges]
    int* edge_parent,           // [n_trees, max_edges]
    double* edge_length,        // [n_trees, max_edges]
    char* err, long err_cap) {
  std::unordered_map<std::string, int> label_row;
  {
    const char* p = labels_cat;
    for (long i = 0; i < n_labels; i++) {
      std::string lab(p);
      p += lab.size() + 1;
      label_row.emplace(std::move(lab), (int)i);
    }
  }

  // Trees are independent; parse in parallel (the batch parse is the
  // dominant host cost at 312-seq depth: ~140us/tree single-threaded).
  std::mutex err_mu;
  std::atomic<bool> failed{false};
  auto fail = [&](long t, const std::string& msg) {
    std::lock_guard<std::mutex> lock(err_mu);
    if (!failed.exchange(true))
      snprintf(err, (size_t)err_cap, "tree %ld: %s", t, msg.c_str());
    return false;
  };

  auto parse_tree = [&](long t) -> bool {
    Parser p;
    p.s = texts[t];
    p.nodes.reserve(2 * (size_t)max_tips + 4);
    int root = p.parse_node();
    if (root < 0) return fail(t, p.error);
    p.skip_space_comments();
    if (p.s[p.pos] != ';') return fail(t, "missing ';'");

    // Collapse unary chains (root-side and internal), summing lengths.
    std::vector<int> stack = {root};
    auto collapse = [&](int idx) {
      while (p.nodes[idx].has_children() &&
             p.nodes[p.nodes[idx].first_child].next_sibling < 0) {
        int child = p.nodes[idx].first_child;
        if (!std::isnan(p.nodes[idx].length) ||
            !std::isnan(p.nodes[child].length)) {
          double a = std::isnan(p.nodes[idx].length)
                         ? 0.0 : p.nodes[idx].length;
          double b = std::isnan(p.nodes[child].length)
                         ? 0.0 : p.nodes[child].length;
          p.nodes[child].length = a + b;
        }
        idx = child;
      }
      return idx;
    };
    root = collapse(root);
    for (auto& node : p.nodes) {
      for (int c = node.first_child, prev = -1; c >= 0;
           c = p.nodes[c].next_sibling) {
        int cc = collapse(c);
        if (cc != c) {
          p.nodes[cc].next_sibling = p.nodes[c].next_sibling;
          if (prev < 0)
            node.first_child = cc;
          else
            p.nodes[prev].next_sibling = cc;
          c = cc;
        }
        prev = c;
      }
    }

    if (!p.nodes[root].has_children())
      return fail(t, "tree has no internal node");

    // Post-order: tips in appearance order, internal nodes numbered in
    // completion order (root last).
    long tip_count = 0;
    int internal_count = 0;
    int* t_perm = tip_perm + t * max_tips;
    int* t_parent = tip_parent + t * max_tips;
    double* t_len = tip_length + t * max_tips;
    int* e_child = edge_child + t * max_edges;
    int* e_parent = edge_parent + t * max_edges;
    double* e_len = edge_length + t * max_edges;
    long edge_count = 0;

    struct Frame { int node; int child; bool is_tip_result; int id; };
    // Iterative post-order with explicit result propagation.
    std::string errmsg;
    // (node, next_child_to_visit); results stored per node.
    std::vector<std::pair<int, int>> st;
    std::vector<std::pair<bool, int>> result(p.nodes.size(), {false, -1});
    st.push_back({root, p.nodes[root].first_child});
    while (!st.empty()) {
      auto& top = st.back();
      int node = top.first;
      if (top.second >= 0) {
        int child = top.second;
        top.second = p.nodes[child].next_sibling;
        st.push_back({child, p.nodes[child].first_child});
        continue;
      }
      // all children done (or tip)
      st.pop_back();
      if (!p.nodes[node].has_children()) {
        if (tip_count >= max_tips) return fail(t, "too many tips");
        auto it = label_row.find(p.nodes[node].label);
        if (it == label_row.end())
          return fail(t, "unknown tip label '" + p.nodes[node].label + "'");
        t_perm[tip_count] = it->second;
        t_len[tip_count] = std::isnan(p.nodes[node].length)
                               ? default_branch_length
                               : p.nodes[node].length;
        result[node] = {true, (int)tip_count};
        tip_count++;
        continue;
      }
      int my_id = internal_count++;
      for (int c = p.nodes[node].first_child; c >= 0;
           c = p.nodes[c].next_sibling) {
        auto [is_tip, cid] = result[c];
        double len = std::isnan(p.nodes[c].length)
                         ? default_branch_length : p.nodes[c].length;
        if (is_tip) {
          t_parent[cid] = my_id;
        } else {
          if (edge_count >= max_edges) return fail(t, "too many edges");
          e_child[edge_count] = cid;
          e_parent[edge_count] = my_id;
          e_len[edge_count] = len;
          edge_count++;
        }
      }
      result[node] = {false, my_id};
    }

    if (tip_count != n_labels)
      return fail(t, "tip count " + std::to_string(tip_count) +
                         " != expected " + std::to_string(n_labels));
    n_internal_out[t] = internal_count;
    // Pad remaining edges as no-ops against the sink slot (filled by the
    // Python caller, which knows the batch-wide slot count).
    for (long e = edge_count; e < max_edges; e++) {
      e_child[e] = -1;
      e_parent[e] = -1;
      e_len[e] = 0.0;
    }
    return true;
  };

  unsigned n_thr = std::thread::hardware_concurrency();
  if (n_thr > 8) n_thr = 8;
  if (n_thr <= 1 || n_trees < 256) {
    for (long t = 0; t < n_trees; t++)
      if (!parse_tree(t)) return 1;
    return 0;
  }
  std::atomic<long> next{0};
  auto worker = [&]() {
    for (;;) {
      long start = next.fetch_add(64);
      if (start >= n_trees || failed.load(std::memory_order_relaxed))
        return;
      long end = start + 64 < n_trees ? start + 64 : n_trees;
      for (long t = start; t < end; t++)
        if (!parse_tree(t)) return;
    }
  };
  std::vector<std::thread> threads;
  for (unsigned i = 0; i < n_thr; i++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load() ? 1 : 0;
}

}  // extern "C"
