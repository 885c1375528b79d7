// Felsenstein pruning over xMSA columns for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel linearham_tpu/ops/pruning_pallas.py:_kernel
// (launched by _pruning_chunk, wrapped by site_log_likelihoods_pallas).  It
// computes the same function: for every tree of a batch, walk its slot-reuse
// schedule (io/schedule.py) in post order; for each entry form
//
//     P = max(U diag(exp(lam * t * rate)) U^-1, 0)          [R, 4, 4]
//
// take P's column for the tip's code (ones for code >= 4, zeros below 0) or
// the 4-term product with the child slot, store (first=1) or multiply
// (first=0) it into the parent slot, renormalise on every kRenormStride-th
// entry counted from the tree's first, and at the root mix
// log(sum_i pi_i root_i) + scale over the rate categories with a -inf-safe
// logsumexp, minus log R.  Output: per-site log-likelihoods [T, X].  The
// scalar type is a template parameter: float, and double (the H100 has FP64
// at half the FP32 rate).  Codes and schedule indices are int32 in both.
//
// What bounds it on this card.  Per (site, rate) a tree costs 32 FLOP for
// each internal entry (a 4x4 by 4 product), 4 for each non-first entry and
// ~7 for each renormalisation: ~3.9 kFLOP at 100 sequences (99 internal of
// 200 entries), ~56 GFLOP for 4096 trees x 863 sites x 4 rates, against
// ~25 MB of input and output.  The bound is the FP32 (FP64) pipes: ~0.83 ms
// (~1.6 ms) at the data sheet's 67 (34) TFLOP/s.  The products are too
// small for the tensor cores (4 rows; f32 must not round through TF32).
// What holds the walk back is its serial latency: every entry depends on
// the one before, so each warp has one entry's work (~100 instructions for
// its 32 sites) in flight, and shared memory caps a block's partials, so an
// SM holds few warps.  The design cuts the instructions and the latency of
// an entry and keeps everything else off the walk.
//
// What the design does about it.
//   * Warp specialisation.  A block is (tree, tile of BX sites): BX
//     consumer threads, each walking one site, and one producer warp.  The
//     producer fills a ring of kRing stages of kStageOf<T> entries each: the
//     entries' schedule, P (one (entry, rate) per lane: 4 exps, 64 FMAs) and
//     the tip codes of the tile (cp.async from the xMSA rows), and signals
//     each stage on an mbarrier; consumers wait only on the stage they need
//     and release it on a second mbarrier.  No block barrier in the walk.
//   * Register forwarding.  The message just made stays in registers
//     (acc).  Post order makes the next entry's child, or its parent, the
//     slot just written in most entries (a node's own edge follows its last
//     child's message; a node's tips follow its in-place first child), so
//     those reads come from registers, and a store is skipped when the next
//     entry writes the same slot.  Shared memory holds only the partials
//     that wait for a sibling subtree: [n_slots][R][4][BX], thread x on
//     column x (no bank conflicts).
//   * Straight-line entries.  An entry is one of nine cases (tip, internal
//     with the child in registers or in shared memory; parent fresh, in
//     registers or in shared memory), each a branch-free loop over (site,
//     rate) applied to acc in place.  P is stored transposed with a ones
//     and a zeros column, so a tip's message is one 16-byte load a rate.
//   * Exact renormalisation: by the power of two nearest the max, from its
//     exponent bits, with the scale kept as an integer count of ln 2 (no
//     division or log in the walk); a padding entry's all-ones (or
//     one-hot) message scales by exactly 1.
//   * The ragged site edge is masked; no site or tree padding.
//
// The site tile and the stage length are fixed per scalar type (kTile,
// kStageOf), at the values the card was fastest with.  Measured there and
// dropped: two sites a thread, 32- and 128-site f32 tiles, a block barrier
// per stage in place of the producer warp, and loading an entry's operands
// during the entry before it (PERF.md).  The launch is asynchronous on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRenormStride = 4;   // renormalise every 4th entry
constexpr int kRing = 2;           // stages in flight between the warps
// One rate's P in the stage buffer: 6 columns of 4, P's columns j = 0..3
// (P[r][i][j] at [j*4 + i]), then ones (the column of code >= 4, N) and
// zeros (a negative, invalid code), so a tip reads its column unselected.
constexpr int kPCols = 6;
constexpr int kPStride = kPCols * 4;
constexpr double kLn2 = 0.69314718055994530942;

// Sites (and consumer threads) a block.
template <typename T>
constexpr int kTile = sizeof(T) == 8 ? 32 : 64;
// Schedule entries per stage of P and tip codes.
template <typename T>
constexpr int kStageOf = sizeof(T) == 8 ? 4 : 8;

__device__ __forceinline__ float lh_exp(float x) { return expf(x); }
__device__ __forceinline__ double lh_exp(double x) { return exp(x); }
__device__ __forceinline__ float lh_log(float x) { return logf(x); }
__device__ __forceinline__ double lh_log(double x) { return log(x); }
__device__ __forceinline__ float lh_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double lh_max(double a, double b) { return fmax(a, b); }

// Four consecutive scalars of shared memory as one 16-byte-aligned vector.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// e = round(log2(m)) for m > 0: the exponent of m * sqrt(2) (-127 or
// -1023 below the normal range, which keeps 2^-e finite).
__device__ __forceinline__ int nearest_exp2(float m) {
  return ((__float_as_int(m * 1.41421356f) >> 23) & 0xff) - 127;
}
__device__ __forceinline__ int nearest_exp2(double m) {
  return (int)((__double_as_longlong(m * 1.4142135623730951) >> 52) & 0x7ff) -
         1023;
}
// 2^-e, built from its exponent bits.
__device__ __forceinline__ float exp2_neg(float, int e) {
  return __int_as_float((127 - e) << 23);
}
__device__ __forceinline__ double exp2_neg(double, int e) {
  return __longlong_as_double((long long)(1023 - e) << 52);
}

// out[i] = sum_j P[i][j] * v[j], with pm[j*4 + i] = P[i][j].
template <typename T>
__device__ __forceinline__ void matvec(const T pm[16], const T v[4], T out[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = pm[i] * v[0] + pm[4 + i] * v[1] + pm[8 + i] * v[2] + pm[12 + i] * v[3];
}

// 4 bytes global -> shared, asynchronous (completed by cp_async_wait_all).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Dynamic shared memory of one block, in bytes: the scalars (partials, the
// P ring, outer[k][i][j], lam, pi, rates), then the int32 code ring and the
// schedule ring (src, and enc with the next stage's first), then the
// mbarriers.
inline size_t smem_bytes(int n_slots, int n_rates, int elem_bytes) {
  const int bx = elem_bytes == 8 ? kTile<double> : kTile<float>;
  const int kStage = elem_bytes == 8 ? kStageOf<double> : kStageOf<float>;
  const size_t scalars = (size_t)n_slots * n_rates * 4 * bx        // partials
                         + kRing * (size_t)kStage * n_rates * kPStride  // P
                         + 64                                       // outer
                         + 4 + 4                                    // lam, pi
                         + (size_t)n_rates;                         // rates
  const size_t ints = kRing * (size_t)kStage * bx                  // codes
                      + kRing * (size_t)(2 * kStage + 1);           // sched
  const size_t bytes = scalars * elem_bytes + ints * sizeof(int32_t);
  return (bytes + 7) / 8 * 8 + 2 * kRing * sizeof(uint64_t);      // mbarriers
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that outlasts ~2^31 polls traps: a fault ends the launch, never hangs it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (polls == 0x7fffffffu) __trap();
  }
}

template <typename T, int R, int BX>
struct Block {
  static constexpr int kStage = kStageOf<T>;
  static constexpr int PSPT = BX / 32;     // sites a producer lane copies

  T* partials;     // [n_slots][R][4][BX]
  T* pt;           // [kRing][kStage][R][kPCols][4 i], P transposed
  T* outer;        // [4 k][4 i][4 j]
  T* lam;          // [4]
  T* pi;           // [4]
  T* rates;        // [R]
  int32_t* code;   // [kRing][kStage][BX]
  int32_t* src;    // [kRing][kStage]
  int32_t* enc;    // [kRing][kStage + 1]: the stage's, then the next's first
  uint64_t* full;  // [kRing]: the producer filled the stage
  uint64_t* empty; // [kRing]: the consumers are done with it

  __device__ Block(unsigned char* raw, int n_slots) {
    partials = reinterpret_cast<T*>(raw);
    pt = partials + (size_t)n_slots * R * 4 * BX;
    outer = pt + kRing * kStage * R * kPStride;
    lam = outer + 64;
    pi = lam + 4;
    rates = pi + 4;
    code = reinterpret_cast<int32_t*>(rates + R);
    src = code + kRing * kStage * BX;
    enc = src + kRing * kStage;
    const size_t used = reinterpret_cast<unsigned char*>(
                            enc + kRing * (kStage + 1)) - raw;
    full = reinterpret_cast<uint64_t*>(raw + (used + 7) / 8 * 8);
    empty = full + kRing;
  }

  // The producer warp: stage c's schedule, tip codes (cp.async) and P into
  // ring slot s.  Lane d < kStage reads entry c*kStage + d.
  __device__ void produce(int c, int s, const int32_t* __restrict__ codes,
                          const int32_t* __restrict__ g_src,
                          const int32_t* __restrict__ g_penc,
                          const T* __restrict__ g_len, size_t tN, int N,
                          int X, int x0, int lane) const {
    const int k = c * kStage + lane;
    int e = -4, sr = 0;   // past the tree's end: enc -4 (parent -1)
    T len = T(0);
    if (lane <= kStage && k < N) {
      e = g_penc[tN + k];
      sr = g_src[tN + k];
      len = g_len[tN + k];
    }
    if (lane <= kStage) enc[s * (kStage + 1) + lane] = e;
    if (lane < kStage) src[s * kStage + lane] = sr;
    // The tip rows: lane d's tip's row, else row 0 (copied, never read).
    const int my_row = e >= 0 && (e & 1) ? sr : 0;
#pragma unroll
    for (int d = 0; d < kStage; ++d) {
      const int32_t* row =
          codes + (size_t)__shfl_sync(0xffffffffu, my_row, d) * X + x0;
      int32_t* dst = code + (s * kStage + d) * BX;
#pragma unroll
      for (int j = 0; j < PSPT; ++j) {
        const int xl = lane + j * 32;
        if (x0 + xl < X) cp_async4(dst + xl, row + xl);
        else dst[xl] = 4;   // past the ragged edge: N, a message of ones
      }
    }
    // P, one (entry, rate) per lane.
#pragma unroll
    for (int it0 = 0; it0 < kStage * R; it0 += 32) {
      const int it = it0 + lane;
      const int d = (it / R) % kStage, r = it % R;
      const T ld = __shfl_sync(0xffffffffu, len, d);
      if (it >= kStage * R) continue;
      T ex[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ex[kk] = lh_exp(rates[r] * (ld * lam[kk]));
      T p[4][4];   // p[i][j]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = T(0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          T o[4];
          load4(outer + kk * 16 + i * 4, o);
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] += ex[kk] * o[j];
        }
      }
      T* dst = pt + ((s * kStage + d) * R + r) * kPStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) col[i] = lh_max(p[i][j], T(0));
        store4(dst + j * 4, col);
      }
    }
    cp_async_wait_all();
  }
};

// Where an entry's parent value comes from.
enum ParentMode { kFirst, kAcc, kSmem };

// acc[i] = msg[i] (a fresh slot), acc[i] * msg[i] (acc is the parent), or
// parent[i] * msg[i] (the parent waits in shared memory, at stride BX).
template <int Mode, int BX, typename T>
__device__ __forceinline__ void apply(T acc[4], const T msg[4],
                                      const T* parent) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (Mode == kFirst) acc[i] = msg[i];
    else if (Mode == kAcc) acc[i] *= msg[i];
    else acc[i] = parent[i * BX] * msg[i];
  }
}

// A tip entry: msg[r][i] = P[r,i,code], code >= 4 (N) -> ones, < 0 -> zeros
// (the P buffer's columns 4 and 5).
template <int Mode, int BX, typename T, int R>
__device__ __forceinline__ void tip_entry(T (&acc)[R][4], const T* P,
                                          int code, const T* dst) {
  const int col = code < 0 ? 5 : (code > 3 ? 4 : code);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T v[4];
    load4(P + r * kPStride + col * 4, v);
    apply<Mode, BX>(acc[r], v, dst + r * 4 * BX);
  }
}

// An internal entry: msg[r] = P[r] . child[r], the child being acc
// (FwdChild) or a slot in shared memory.
template <int Mode, bool FwdChild, int BX, typename T, int R>
__device__ __forceinline__ void edge_entry(T (&acc)[R][4], const T* P,
                                           const T* child, const T* dst) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T pm[16], ch[4], msg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(P + r * kPStride + j * 4, pm + j * 4);
#pragma unroll
    for (int l = 0; l < 4; ++l)
      ch[l] = FwdChild ? acc[r][l] : child[(r * 4 + l) * BX];
    matvec(pm, ch, msg);
    apply<Mode, BX>(acc[r], msg, dst + r * 4 * BX);
  }
}

template <typename T, int R, int BX>
__global__ void __launch_bounds__(BX + 32) pruning_kernel(
    const int32_t* __restrict__ codes,   // [n_rows, X] xMSA rows
    const int32_t* __restrict__ src,     // [T, N] tip row or child slot
    const int32_t* __restrict__ penc,    // [T, N] slot*4 + first*2 + is_tip
    const T* __restrict__ length,        // [T, N] branch lengths
    const int32_t* __restrict__ root,    // [T] slot of the root partial
    const T* __restrict__ u,             // [T, 4, 4]
    const T* __restrict__ uinv,          // [T, 4, 4]
    const T* __restrict__ lam,           // [T, 4]
    const T* __restrict__ rates,         // [T, R]
    const T* __restrict__ pi,            // [T, 4]
    T* __restrict__ out,                 // [T, X]
    int X, int N, int n_slots) {
  using B = Block<T, R, BX>;
  constexpr int kStage = B::kStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const B blk(smem_raw, n_slots);
  // Threads 0..BX-1 walk one site each; the producer warp follows them.
  const int tx = threadIdx.x;
  const int t = blockIdx.x;
  const int x0 = blockIdx.y * BX;

  // Rank-1 eigen factors outer[k][i][j] = u[i,k] * uinv[k,j], once per tree.
  for (int e = tx; e < 64; e += BX + 32) {
    const int k = e >> 4, i = (e >> 2) & 3, j = e & 3;
    blk.outer[e] = u[t * 16 + i * 4 + k] * uinv[t * 16 + k * 4 + j];
  }
  if (tx < 4) {
    blk.lam[tx] = lam[t * 4 + tx];
    blk.pi[tx] = pi[t * 4 + tx];
  }
  for (int r = tx; r < R; r += BX + 32) blk.rates[r] = rates[t * R + r];
  // The ones and zeros columns of every P in the ring; stages rewrite only
  // columns 0-3.
  for (int e = tx; e < kRing * kStage * R; e += BX + 32) {
    T* q = blk.pt + (size_t)e * kPStride + 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = T(1);
      q[4 + i] = T(0);
    }
  }
  if (tx == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&blk.full[s], 32);
      mbar_init(&blk.empty[s], BX);
    }
  }
  __syncthreads();

  const int n_stages = (N + kStage - 1) / kStage;
  if (tx >= BX) {
    // The producer warp: stages into the ring, each once the consumers
    // have released the slot it reuses.
    for (int c = 0; c < n_stages; ++c) {
      const int s = c % kRing;
      if (c >= kRing) mbar_wait(&blk.empty[s], (c / kRing - 1) & 1);
      blk.produce(c, s, codes, src, penc, length, (size_t)t * N, N, X, x0,
                  tx - BX);
      mbar_arrive(&blk.full[s]);
    }
    return;
  }

  const size_t slot_elems = (size_t)R * 4 * BX;
  T acc[R][4];     // the last entry's message: the value of slot prev_p
  int escale[R];   // log2 of the renormalisation, per rate
#pragma unroll
  for (int r = 0; r < R; ++r) {
    escale[r] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = T(0);
  }
  int prev_p = -1;

  for (int c = 0; c < n_stages; ++c) {
    const int b = c % kRing;
    mbar_wait(&blk.full[b], (c / kRing) & 1);
    const int32_t* s_enc = blk.enc + b * (kStage + 1);
    const int32_t* s_src = blk.src + b * kStage;
    int enc = s_enc[0];
    int src_k = s_src[0];
    const int d_end = min(kStage, N - c * kStage);
    for (int d = 0; d < d_end; ++d) {
      // The next entry's encoding is read one entry ahead; -4 (parent -1)
      // past the end.
      const int enc_next = s_enc[d + 1];
      const int src_next = d + 1 < kStage ? s_src[d + 1] : 0;
      const int k = c * kStage + d;
      const int p = enc >> 2;
      const T* P = blk.pt + (size_t)(b * kStage + d) * R * kPStride;
      T* dst = blk.partials + (size_t)p * slot_elems + tx;
      // The message, applied to acc in place: the parent is a fresh slot
      // (first), acc itself (the slot just written), or shared memory.
      // Each case is one straight-line loop over the rates.
      const int parent = (enc & 2) ? kFirst : (p == prev_p ? kAcc : kSmem);
      if (enc & 1) {
        const int code = blk.code[(b * kStage + d) * BX + tx];
        if (parent == kFirst) tip_entry<kFirst, BX>(acc, P, code, dst);
        else if (parent == kAcc) tip_entry<kAcc, BX>(acc, P, code, dst);
        else tip_entry<kSmem, BX>(acc, P, code, dst);
      } else if (src_k == prev_p) {
        // The child is the slot just written: its value is acc.
        if (parent == kFirst) edge_entry<kFirst, true, BX>(acc, P, dst, dst);
        else if (parent == kAcc) edge_entry<kAcc, true, BX>(acc, P, dst, dst);
        else edge_entry<kSmem, true, BX>(acc, P, dst, dst);
      } else {
        const T* child = blk.partials + (size_t)src_k * slot_elems + tx;
        if (parent == kFirst) edge_entry<kFirst, false, BX>(acc, P, child, dst);
        else if (parent == kAcc) edge_entry<kAcc, false, BX>(acc, P, child, dst);
        else edge_entry<kSmem, false, BX>(acc, P, child, dst);
      }
      if (k % kRenormStride == kRenormStride - 1) {
        // Divide by 2^e, the power of two nearest the max in log scale (1
        // for an all-zero message): exact, and exactly 1 for a sink
        // padding entry's message, whose max is 1 up to rounding.
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T m = lh_max(lh_max(acc[r][0], acc[r][1]),
                             lh_max(acc[r][2], acc[r][3]));
          const int e = m > T(0) ? nearest_exp2(m) : 0;
          const T f = exp2_neg(m, e);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] *= f;
          escale[r] += e;
        }
      }
      // Stored unless the next entry writes slot p again (it takes acc from
      // registers); the last entry always stores.
      if ((enc_next >> 2) != p) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) dst[(r * 4 + i) * BX] = acc[r][i];
      }
      prev_p = p;
      enc = enc_next;
      src_k = src_next;
    }
    mbar_arrive(&blk.empty[b]);
  }

  // Root: stationary mix, then a -inf-safe logsumexp over the rates.  The
  // last entry always stored, so the root slot is current in shared memory.
  const T* rootp = blk.partials + (size_t)root[t] * slot_elems + tx;
  T per_rate[R];
  T mx = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T lik = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) lik += blk.pi[i] * rootp[(r * 4 + i) * BX];
    per_rate[r] = lh_log(lik) + T(escale[r] * kLn2);
    mx = lh_max(mx, per_rate[r]);
  }
  // All-zero sites (conflicting tips across a length-0 edge) give
  // mx = -inf; subtracting 0 instead keeps exp() at 0 so the mix is -inf,
  // not NaN.
  const T safe = isfinite(mx) ? mx : T(0);
  T sum = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) sum += lh_exp(per_rate[r] - safe);
  if (x0 + tx < X) out[(size_t)t * X + x0 + tx] = mx + lh_log(sum) - lh_log(T(R));
}

// Allow the launch's dynamic shared memory and give all of the SM's 228 KB
// to shared memory: the blocks an SM holds are set by their partials.
template <typename T, int R>
cudaError_t configure(size_t smem) {
  auto kernel = pruning_kernel<T, R, kTile<T>>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int R>
int launch(const void* codes, const void* src, const void* penc,
           const void* length, const void* root, const void* u,
           const void* uinv, const void* lam, const void* rates,
           const void* pi, void* out, int n_trees, int N, int X, int n_slots,
           cudaStream_t stream) {
  constexpr int BX = kTile<T>;
  static_assert(BX % 32 == 0, "a tile is whole warps");
  const size_t smem = smem_bytes(n_slots, R, sizeof(T));
  const cudaError_t err = configure<T, R>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_trees, (X + BX - 1) / BX);
  pruning_kernel<T, R, BX><<<grid, BX + 32, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(penc), static_cast<const T*>(length),
      static_cast<const int32_t*>(root), static_cast<const T*>(u),
      static_cast<const T*>(uinv), static_cast<const T*>(lam),
      static_cast<const T*>(rates), static_cast<const T*>(pi),
      static_cast<T*>(out), X, N, n_slots);
  return (int)cudaGetLastError();
}

// Blocks one SM holds at these sizes, or -1 on a CUDA error.
template <typename T, int R>
int blocks_per_sm(int n_slots) {
  const size_t smem = smem_bytes(n_slots, R, sizeof(T));
  int n = 0;
  if (configure<T, R>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pruning_kernel<T, R, kTile<T>>, kTile<T> + 32,
          smem) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int blocks_per_sm_rates(int n_slots, int R) {
  switch (R) {
    case 1: return blocks_per_sm<T, 1>(n_slots);
    case 2: return blocks_per_sm<T, 2>(n_slots);
    case 4: return blocks_per_sm<T, 4>(n_slots);
    case 8: return blocks_per_sm<T, 8>(n_slots);
    default: return -1;
  }
}

template <typename T>
int launch_rates(const void* codes, const void* src, const void* penc,
                 const void* length, const void* root, const void* u,
                 const void* uinv, const void* lam, const void* rates,
                 const void* pi, void* out, int n_trees, int N, int X,
                 int n_slots, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<T, 1>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, n_trees, N, X, n_slots, s);
    case 2: return launch<T, 2>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, n_trees, N, X, n_slots, s);
    case 4: return launch<T, 4>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, n_trees, N, X, n_slots, s);
    case 8: return launch<T, 8>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, n_trees, N, X, n_slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs, for scalars of
// `elem_bytes` (4 or 8) in that type's site tile.  The layout does not
// depend on the schedule's length (n_entries), which the interface keeps.
size_t lh_pruning_smem_bytes(int n_entries, int n_slots, int n_rates,
                             int elem_bytes) {
  (void)n_entries;
  return smem_bytes(n_slots, n_rates, elem_bytes);
}

// The site tile of scalars of `elem_bytes`: sites (and consumer threads)
// a block; one producer warp more.
int lh_pruning_tile(int elem_bytes) {
  return elem_bytes == 8 ? kTile<double> : kTile<float>;
}

// Blocks of the kernel one SM holds at these sizes (occupancy), or -1.
int lh_pruning_blocks_per_sm(int n_slots, int n_rates, int elem_bytes) {
  return elem_bytes == 8 ? blocks_per_sm_rates<double>(n_slots, n_rates)
                         : blocks_per_sm_rates<float>(n_slots, n_rates);
}

// Launch on `stream`; returns a cudaError_t (0 on success).  R must be one
// of 1, 2, 4, 8.  Every floating input and the output are float32
// (lh_pruning_launch) or float64 (lh_pruning_launch_f64).
int lh_pruning_launch(const void* codes, const void* src, const void* penc,
                      const void* length, const void* root, const void* u,
                      const void* uinv, const void* lam, const void* rates,
                      const void* pi, void* out, int n_trees, int N, int X,
                      int n_slots, int R, void* stream) {
  return launch_rates<float>(codes, src, penc, length, root, u, uinv, lam,
                             rates, pi, out, n_trees, N, X, n_slots, R,
                             stream);
}

int lh_pruning_launch_f64(const void* codes, const void* src,
                          const void* penc, const void* length,
                          const void* root, const void* u, const void* uinv,
                          const void* lam, const void* rates, const void* pi,
                          void* out, int n_trees, int N, int X, int n_slots,
                          int R, void* stream) {
  return launch_rates<double>(codes, src, penc, length, root, u, uinv, lam,
                              rates, pi, out, n_trees, N, X, n_slots, R,
                              stream);
}

}  // extern "C"
