// Slot-reuse pruning schedule builder (Sethi-Ullman register allocation
// on trees) — the native fast path behind linearham_tpu/io/schedule.py
// (see that module's docstring for the entry format and why: the Pallas
// kernel's VMEM partials scratch shrinks from one-slot-per-internal-node
// to the ~log2(n_tips) peak of live partials, which is what lets the
// site-block width cover a deep family's whole xMSA in one pass).
//
// Per tree this is a linear-time DFS; a 10k-tree ensemble of 313-tip
// trees (~9.4M node visits) builds in ~100 ms, where the pure-Python
// builder takes tens of seconds.  The reference has no analogue (libpll
// allocates one CLV buffer per inner node, src/PhyloHMM.cpp:224-226).
//
// C ABI only; bound from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdio>
#include <vector>

namespace {

struct Frame {
  int node;
  int consumed;   // internal children consumed so far
  int slot;       // this node's live slot (-1 until assigned)
  bool pending;   // a child subtree is in flight; consume on return
};

}  // namespace

extern "C" {

// Returns 0 on success; nonzero writes a message into err.
// Inputs are the TreeBatch arrays (strides n_tips / e_max per tree; real
// edge count per tree is root_slot[t], post-order guarantees this).
// Outputs: schedule entries with stride N = n_tips + e_max per tree;
// unwritten (padding) entries keep penc = -1 for the caller to fill once
// the batch-wide slot count is known.
int lh_build_schedule(
    long n_trees, long n_tips, long e_max,
    const int* tip_perm, const int* tip_parent, const double* tip_length,
    const int* edge_child, const int* edge_parent,
    const double* edge_length, const int* root_slot,
    int* sched_src,      // [T, N]
    int* sched_penc,     // [T, N] parent*4 + first*2 + is_tip; -1 = pad
    double* sched_len,   // [T, N]
    int* sched_root,     // [T]
    int* peak_out,       // [T] peak live slots
    char* err, long err_cap) {
  const long N = n_tips + e_max;

  // Reused per-tree scratch.
  std::vector<int> tip_head, tip_next, ic_head, ic_next, need;
  std::vector<int> ics, free_slots;
  std::vector<Frame> stack;

  for (long t = 0; t < n_trees; t++) {
    const int* t_perm = tip_perm + t * n_tips;
    const int* t_parent = tip_parent + t * n_tips;
    const double* t_len = tip_length + t * n_tips;
    const int* e_child = edge_child + t * e_max;
    const int* e_parent = edge_parent + t * e_max;
    const double* e_len = edge_length + t * e_max;
    const int root = root_slot[t];
    const int I = root + 1;
    const long E = root;  // post-order: exactly root real internal edges

    int* o_src = sched_src + t * N;
    int* o_penc = sched_penc + t * N;
    double* o_len = sched_len + t * N;

    // Children as intrusive linked lists (prepend, so iterate gives
    // reverse insertion order; we sort internal children anyway and tip
    // order does not affect the result beyond which tip carries the
    // first-write flag — match the Python builder by restoring
    // insertion order below).
    tip_head.assign(I, -1);
    tip_next.assign(n_tips, -1);
    for (long i = n_tips - 1; i >= 0; i--) {  // reverse: lists in order
      int p = t_parent[i];
      if (p < 0 || p >= I) {
        snprintf(err, (size_t)err_cap, "tree %ld: bad tip parent %d", t, p);
        return 1;
      }
      tip_next[i] = tip_head[p];
      tip_head[p] = (int)i;
    }
    ic_head.assign(I, -1);
    ic_next.assign(E > 0 ? (size_t)E : 1, -1);
    for (long e = E - 1; e >= 0; e--) {
      int p = e_parent[e];
      if (p < 0 || p >= I || e_child[e] < 0 || e_child[e] >= p) {
        snprintf(err, (size_t)err_cap,
                 "tree %ld: edge %ld not post-ordered", t, e);
        return 1;
      }
      ic_next[e] = ic_head[p];
      ic_head[p] = (int)e;
    }

    // Subtree slot need, in increasing slot order (children come first).
    need.assign(I, 1);
    // Sorted internal-children lists, flattened: per node a [start, end)
    // range into `ics`.
    std::vector<std::pair<int, int>> ic_range(I);
    ics.clear();
    for (int s = 0; s < I; s++) {
      int start = (int)ics.size();
      for (int e = ic_head[s]; e >= 0; e = ic_next[e]) ics.push_back(e);
      int end = (int)ics.size();
      std::stable_sort(ics.begin() + start, ics.begin() + end,
                       [&](int a, int b) {
                         return need[e_child[a]] > need[e_child[b]];
                       });
      ic_range[s] = {start, end};
      int n = 1;
      for (int i = start; i < end; i++) {
        int cn = need[e_child[ics[i]]];
        n = std::max(n, i == start ? cn : 1 + cn);
      }
      need[s] = n;
    }

    long out = 0;
    auto emit = [&](int s, int p, int first, int tip, double ln) {
      o_src[out] = s;
      o_penc[out] = p * 4 + first * 2 + tip;
      o_len[out] = ln;
      out++;
    };

    free_slots.clear();
    int next_slot = 0, live = 0, peak = 0;
    auto alloc = [&]() {
      int s;
      if (!free_slots.empty()) {
        s = free_slots.back();
        free_slots.pop_back();
      } else {
        s = next_slot++;
      }
      live++;
      peak = std::max(peak, live);
      return s;
    };
    auto release = [&](int s) {
      free_slots.push_back(s);
      live--;
    };

    stack.clear();
    stack.push_back({root, 0, -1, false});
    int last = -1;
    while (!stack.empty()) {
      Frame& f = stack.back();
      auto [ic_start, ic_end] = ic_range[f.node];
      int n_ic = ic_end - ic_start;
      if (f.pending) {
        f.pending = false;
        int e = ics[ic_start + f.consumed];
        if (f.consumed == 0) {
          // Heaviest child's slot becomes ours: in-place transform.
          f.slot = last;
          emit(f.slot, f.slot, 1, 0, e_len[e]);
          for (int i = tip_head[f.node]; i >= 0; i = tip_next[i])
            emit(t_perm[i], f.slot, 0, 1, t_len[i]);
        } else {
          emit(last, f.slot, 0, 0, e_len[e]);
          release(last);
        }
        f.consumed++;
      }
      if (f.consumed == 0 && n_ic == 0) {
        // All-tip node: fresh slot, first tip stores.
        f.slot = alloc();
        bool first = true;
        for (int i = tip_head[f.node]; i >= 0; i = tip_next[i]) {
          emit(t_perm[i], f.slot, first ? 1 : 0, 1, t_len[i]);
          first = false;
        }
        last = f.slot;
        stack.pop_back();
        continue;
      }
      if (f.consumed < n_ic) {
        f.pending = true;
        stack.push_back({e_child[ics[ic_start + f.consumed]], 0, -1,
                         false});
        continue;
      }
      last = f.slot;
      stack.pop_back();
    }

    if (out != n_tips + E || live != 1) {
      snprintf(err, (size_t)err_cap,
               "tree %ld: schedule invariant broken (out=%ld live=%d)",
               t, out, live);
      return 1;
    }
    sched_root[t] = last;
    peak_out[t] = peak;
    for (long k = out; k < N; k++) {   // padding entries for the caller
      o_src[k] = 0;
      o_penc[k] = -1;
      o_len[k] = 0.0;
    }
  }
  return 0;
}

}  // extern "C"
