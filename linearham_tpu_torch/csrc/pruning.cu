// Felsenstein pruning over xMSA columns for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel linearham_tpu/ops/pruning_pallas.py:_kernel
// (launched by _pruning_chunk, wrapped by site_log_likelihoods_pallas).  It
// computes the same function: for every tree of a batch, walk its slot-reuse
// schedule (linearham_tpu/io/schedule.py) in post order; for each entry form
//
//     P = max(U diag(exp(lam * t * rate)) U^-1, 0)          [R, 4, 4]
//
// take P's column for the tip's code (ones for code >= 4) or the 4-term
// product with the child slot, store (first=1) or multiply (first=0) it into
// the parent slot, max-renormalise on every kRenormStride-th entry, and at
// the root mix log(sum_i pi_i root_i) + scale over the rate categories with a
// -inf-safe logsumexp, minus log R.  Output: per-site log-likelihoods [T, X].
//
// The scalar type is a template parameter: float (the production path) and
// double (the f64 path; the H100 has native FP64 at half the FP32 rate, so
// f64 runs through this kernel too, where the JAX package sends it to a jnp
// path because Mosaic has no f64).  The tip codes and schedule indices are
// int32 in both.
//
// What bounds it on this card.  The work is ~16*R FMAs per (entry, site) on
// data that never needs device memory: the only global traffic is the tip
// codes in (4 B per tip entry and site, shared by every tree and so served
// from L2) and one scalar per site out.  It is therefore bound by the serial
// dependence along the schedule (N ~ 2 * n_tips entries, one after the
// other) and by latency inside each entry, not by HBM bandwidth or FLOPs.
//
// What the design does about it.
//   * One block per (tree, tile of BX sites), one thread per site column:
//     sites are independent, so no data crosses threads except the schedule
//     and P, and the serial walk is spread over T * X/BX blocks.
//   * The live partials [n_slots][R][4][BX] sit in shared memory, laid out so
//     thread x touches only column x (no bank conflicts, no barriers for the
//     partials).  Slot reuse keeps n_slots ~ log2(n_tips), so a 128-wide f32
//     tile needs 64 KB at n_slots=8, R=4 (dynamic shared memory above 48 KB).
//     The f64 instantiation takes a 64-wide tile: 128 wide it needs 128 KB
//     there (one block an SM) and 256 KB at R=8, over a block's 227 KB; 64
//     wide it ran 30 % faster than 128 at T=4096, R=4 on an H100 at 700 W.
//   * The block's schedule (src, penc, length) is staged in shared memory
//     once; P is computed cooperatively per entry into a double buffer, which
//     costs one __syncthreads() per entry.
//   * Each thread keeps its per-rate log scale and the message in registers
//     (R is a template parameter), and prefetches the next tip entry's code
//     one entry ahead to hide the global-load latency behind the current one.
//   * The ragged site edge is masked; no site or tree padding is needed.
//
// The launch is asynchronous on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRenormStride = 4;   // max-renormalise every 4th entry

__device__ __forceinline__ float lh_exp(float x) { return expf(x); }
__device__ __forceinline__ double lh_exp(double x) { return exp(x); }
__device__ __forceinline__ float lh_log(float x) { return logf(x); }
__device__ __forceinline__ double lh_log(double x) { return log(x); }
__device__ __forceinline__ float lh_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double lh_max(double a, double b) { return fmax(a, b); }

// The site tile of each scalar type: 128 in float, 64 in double.
template <typename T>
constexpr int kBlockX = sizeof(T) == 8 ? 64 : 128;

// Dynamic shared memory of one block, in bytes: the scalars (partials, P
// double buffer, outer[k][i][j], lam, pi, rates, lengths) first, then the
// int32 src and penc.
inline size_t smem_bytes(int n_entries, int n_slots, int n_rates,
                         int elem_bytes) {
  const int block_x = elem_bytes == 8 ? kBlockX<double> : kBlockX<float>;
  const size_t scalars = (size_t)n_slots * n_rates * 4 * block_x  // partials
                         + 2 * (size_t)n_rates * 16                 // P x 2
                         + 64                                       // outer
                         + 4 + 4                                    // lam, pi
                         + (size_t)n_rates                          // rates
                         + (size_t)n_entries;                       // length
  return scalars * elem_bytes + 2 * sizeof(int32_t) * (size_t)n_entries;
}

template <typename T, int R, int BX>
__global__ void __launch_bounds__(BX) pruning_kernel(
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x;
  const int t = blockIdx.x;
  const int x = blockIdx.y * BX + tx;
  const bool valid = x < X;

  T* partials = smem;                                    // [n_slots][R][4][BX]
  T* pbuf = partials + (size_t)n_slots * R * 4 * BX;     // [2][R][4][4]
  T* outer = pbuf + 2 * R * 16;                          // [4 k][4 i][4 j]
  T* s_lam = outer + 64;                                 // [4]
  T* s_pi = s_lam + 4;                                   // [4]
  T* s_rates = s_pi + 4;                                 // [R]
  T* s_len = s_rates + R;                                // [N]
  int32_t* s_src = reinterpret_cast<int32_t*>(s_len + N);  // [N]
  int32_t* s_penc = s_src + N;                           // [N]

  const size_t tN = (size_t)t * N;
  for (int k = tx; k < N; k += BX) {
    s_src[k] = src[tN + k];
    s_penc[k] = penc[tN + k];
    s_len[k] = length[tN + k];
  }
  // Rank-1 eigen factors outer[k][i][j] = u[i,k] * uinv[k,j], once per tree.
  for (int e = tx; e < 64; e += BX) {
    const int k = e >> 4, i = (e >> 2) & 3, j = e & 3;
    outer[e] = u[t * 16 + i * 4 + k] * uinv[t * 16 + k * 4 + j];
  }
  if (tx < 4) {
    s_lam[tx] = lam[t * 4 + tx];
    s_pi[tx] = pi[t * 4 + tx];
  }
  for (int r = tx; r < R; r += BX) s_rates[r] = rates[t * R + r];
  __syncthreads();

  T scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r) scale[r] = T(0);

  const size_t slot_elems = (size_t)R * 4 * BX;
  // Tip codes are prefetched one entry ahead.
  int code_next = 4;
  if (N > 0 && (s_penc[0] & 1) && valid) code_next = codes[(size_t)s_src[0] * X + x];

  for (int k = 0; k < N; ++k) {
    T* P = pbuf + (k & 1) * R * 16;
    const T len_k = s_len[k];
    for (int e = tx; e < R * 16; e += BX) {
      const int r = e >> 4, ij = e & 15;
      const T rate = s_rates[r];
      T acc = T(0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc += lh_exp(rate * (len_k * s_lam[kk])) * outer[kk * 16 + ij];
      P[e] = lh_max(acc, T(0));
    }
    // The buffer written here was last read in entry k-2, and entry k-1's
    // barrier separates the two, so one barrier per entry suffices.
    __syncthreads();

    const int enc = s_penc[k];
    const int s = s_src[k];
    const int p = enc >> 2;
    const bool first = (enc >> 1) & 1;
    const bool is_tip = enc & 1;

    const int code = code_next;
    if (k + 1 < N) {
      code_next = 4;
      if ((s_penc[k + 1] & 1) && valid) code_next = codes[(size_t)s_src[k + 1] * X + x];
    }

    T msg[R][4];
    if (is_tip) {
      // msg[r,i] = P[r,i,code]; code >= 4 (N) -> exact ones.  The column
      // index is clamped so no shared load leaves P's buffer.
      const int col = code < 0 ? 0 : (code > 3 ? 3 : code);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T v = P[r * 16 + i * 4 + col];
          msg[r][i] = code >= 4 ? T(1) : (code >= 0 ? v : T(0));
        }
    } else {
      const T* child = partials + (size_t)s * slot_elems;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = child[(r * 4 + j) * BX + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T* Pr = P + r * 16 + i * 4;
          msg[r][i] = Pr[0] * c[0] + Pr[1] * c[1] + Pr[2] * c[2] + Pr[3] * c[3];
        }
      }
    }

    T* dst = partials + (size_t)p * slot_elems;
    if (!first) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[r][i] *= dst[(r * 4 + i) * BX + tx];
    }
    if (k % kRenormStride == kRenormStride - 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T m = lh_max(lh_max(msg[r][0], msg[r][1]), lh_max(msg[r][2], msg[r][3]));
        m = m > T(0) ? m : T(1);
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[r][i] = msg[r][i] / m;
        scale[r] += lh_log(m);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(r * 4 + i) * BX + tx] = msg[r][i];
  }

  // Root: stationary mix, then a -inf-safe logsumexp over the rates.
  const T* rootp = partials + (size_t)root[t] * slot_elems;
  T per_rate[R];
  T mx = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T lik = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) lik += s_pi[i] * rootp[(r * 4 + i) * BX + tx];
    per_rate[r] = lh_log(lik) + scale[r];
    mx = lh_max(mx, per_rate[r]);
  }
  // All-zero sites (conflicting tips across a length-0 edge) give mx = -inf;
  // subtracting 0 instead keeps exp() at 0 so the mix is -inf, not NaN.
  const T safe = isfinite(mx) ? mx : T(0);
  T sum = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) sum += lh_exp(per_rate[r] - safe);
  if (valid) out[(size_t)t * X + x] = mx + lh_log(sum) - lh_log(T(R));
}

template <typename T, int R>
int launch(const void* codes, const void* src, const void* penc,
           const void* length, const void* root, const void* u,
           const void* uinv, const void* lam, const void* rates,
           const void* pi, void* out, int n_trees, int N, int X, int n_slots,
           cudaStream_t stream) {
  constexpr int BX = kBlockX<T>;
  const size_t smem = smem_bytes(N, n_slots, R, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      pruning_kernel<T, R, BX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_trees, (X + BX - 1) / BX);
  pruning_kernel<T, R, BX><<<grid, BX, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(penc), static_cast<const T*>(length),
      static_cast<const int32_t*>(root), static_cast<const T*>(u),
      static_cast<const T*>(uinv), static_cast<const T*>(lam),
      static_cast<const T*>(rates), static_cast<const T*>(pi),
      static_cast<T*>(out), X, N, n_slots);
  return (int)cudaGetLastError();
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
// `elem_bytes` (4 or 8) in that type's site tile.
size_t lh_pruning_smem_bytes(int n_entries, int n_slots, int n_rates,
                             int elem_bytes) {
  return smem_bytes(n_entries, n_slots, n_rates, elem_bytes);
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
