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
// What bounds it on this card.  The work is ~16*R FMAs per (entry, site) on
// data that never needs device memory: the only global traffic is the tip
// codes in (4 B per tip entry and site, shared by every tree and so served
// from L2) and 4 B per site out.  It is therefore bound by the serial
// dependence along the schedule (N ~ 2 * n_tips entries, one after the
// other) and by latency inside each entry, not by HBM bandwidth or FLOPs.
//
// What the design does about it.
//   * One block per (tree, tile of BX sites), one thread per site column:
//     sites are independent, so no data crosses threads except the schedule
//     and P, and the serial walk is spread over T * X/BX blocks.
//   * The live partials [n_slots][R][4][BX] sit in shared memory, laid out so
//     thread x touches only column x (no bank conflicts, no barriers for the
//     partials).  Slot reuse keeps n_slots ~ log2(n_tips), so a 128-wide tile
//     needs 64 KB at n_slots=8, R=4 (dynamic shared memory above 48 KB).
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

constexpr int kBlockX = 128;       // sites per block, one thread each
constexpr int kRenormStride = 4;   // max-renormalise every 4th entry

// Dynamic shared memory layout, in 4-byte words (all members are 4 bytes).
__host__ __device__ inline size_t smem_words(int n_entries, int n_slots,
                                             int n_rates) {
  return (size_t)n_slots * n_rates * 4 * kBlockX  // partials
         + 2 * (size_t)n_rates * 16                // P double buffer
         + 64                                      // outer[k][i][j]
         + 4 + 4                                   // lam, pi
         + (size_t)n_rates                         // rates
         + 3 * (size_t)n_entries;                  // length, src, penc
}

template <int R>
__global__ void __launch_bounds__(kBlockX) pruning_kernel(
    const int32_t* __restrict__ codes,   // [n_rows, X] xMSA rows
    const int32_t* __restrict__ src,     // [T, N] tip row or child slot
    const int32_t* __restrict__ penc,    // [T, N] slot*4 + first*2 + is_tip
    const float* __restrict__ length,    // [T, N] branch lengths
    const int32_t* __restrict__ root,    // [T] slot of the root partial
    const float* __restrict__ u,         // [T, 4, 4]
    const float* __restrict__ uinv,      // [T, 4, 4]
    const float* __restrict__ lam,       // [T, 4]
    const float* __restrict__ rates,     // [T, R]
    const float* __restrict__ pi,        // [T, 4]
    float* __restrict__ out,             // [T, X]
    int X, int N, int n_slots) {
  extern __shared__ float smem[];
  constexpr int bx = kBlockX;
  const int tx = threadIdx.x;
  const int t = blockIdx.x;
  const int x = blockIdx.y * bx + tx;
  const bool valid = x < X;

  float* partials = smem;                              // [n_slots][R][4][bx]
  float* pbuf = partials + (size_t)n_slots * R * 4 * bx;  // [2][R][4][4]
  float* outer = pbuf + 2 * R * 16;                    // [4 k][4 i][4 j]
  float* s_lam = outer + 64;                           // [4]
  float* s_pi = s_lam + 4;                             // [4]
  float* s_rates = s_pi + 4;                           // [R]
  float* s_len = s_rates + R;                          // [N]
  int32_t* s_src = reinterpret_cast<int32_t*>(s_len + N);  // [N]
  int32_t* s_penc = s_src + N;                         // [N]

  const size_t tN = (size_t)t * N;
  for (int k = tx; k < N; k += bx) {
    s_src[k] = src[tN + k];
    s_penc[k] = penc[tN + k];
    s_len[k] = length[tN + k];
  }
  // Rank-1 eigen factors outer[k][i][j] = u[i,k] * uinv[k,j], once per tree.
  for (int e = tx; e < 64; e += bx) {
    const int k = e >> 4, i = (e >> 2) & 3, j = e & 3;
    outer[e] = u[t * 16 + i * 4 + k] * uinv[t * 16 + k * 4 + j];
  }
  if (tx < 4) {
    s_lam[tx] = lam[t * 4 + tx];
    s_pi[tx] = pi[t * 4 + tx];
  }
  for (int r = tx; r < R; r += bx) s_rates[r] = rates[t * R + r];
  __syncthreads();

  float scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r) scale[r] = 0.f;

  const size_t slot_words = (size_t)R * 4 * bx;
  // Tip codes are prefetched one entry ahead.
  int code_next = 4;
  if (N > 0 && (s_penc[0] & 1) && valid) code_next = codes[(size_t)s_src[0] * X + x];

  for (int k = 0; k < N; ++k) {
    float* P = pbuf + (k & 1) * R * 16;
    const float len_k = s_len[k];
    for (int e = tx; e < R * 16; e += bx) {
      const int r = e >> 4, ij = e & 15;
      const float rate = s_rates[r];
      float acc = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        acc += expf(rate * (len_k * s_lam[kk])) * outer[kk * 16 + ij];
      P[e] = fmaxf(acc, 0.f);
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

    float msg[R][4];
    if (is_tip) {
      // msg[r,i] = P[r,i,code]; code >= 4 (N) -> exact ones.  The column
      // index is clamped so no shared load leaves P's buffer.
      const int col = code < 0 ? 0 : (code > 3 ? 3 : code);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = P[r * 16 + i * 4 + col];
          msg[r][i] = code >= 4 ? 1.f : (code >= 0 ? v : 0.f);
        }
    } else {
      const float* child = partials + (size_t)s * slot_words;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = child[(r * 4 + j) * bx + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* Pr = P + r * 16 + i * 4;
          msg[r][i] = Pr[0] * c[0] + Pr[1] * c[1] + Pr[2] * c[2] + Pr[3] * c[3];
        }
      }
    }

    float* dst = partials + (size_t)p * slot_words;
    if (!first) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[r][i] *= dst[(r * 4 + i) * bx + tx];
    }
    if (k % kRenormStride == kRenormStride - 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m = fmaxf(fmaxf(msg[r][0], msg[r][1]), fmaxf(msg[r][2], msg[r][3]));
        m = m > 0.f ? m : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[r][i] = msg[r][i] / m;
        scale[r] += logf(m);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(r * 4 + i) * bx + tx] = msg[r][i];
  }

  // Root: stationary mix, then a -inf-safe logsumexp over the rates.
  const float* rootp = partials + (size_t)root[t] * slot_words;
  float per_rate[R];
  float mx = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float lik = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) lik += s_pi[i] * rootp[(r * 4 + i) * bx + tx];
    per_rate[r] = logf(lik) + scale[r];
    mx = fmaxf(mx, per_rate[r]);
  }
  // All-zero sites (conflicting tips across a length-0 edge) give mx = -inf;
  // subtracting 0 instead keeps exp() at 0 so the mix is -inf, not NaN.
  const float safe = isfinite(mx) ? mx : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) sum += expf(per_rate[r] - safe);
  if (valid) out[(size_t)t * X + x] = mx + logf(sum) - logf((float)R);
}

template <int R>
int launch(const void* codes, const void* src, const void* penc,
           const void* length, const void* root, const void* u,
           const void* uinv, const void* lam, const void* rates,
           const void* pi, void* out, int T, int N, int X, int n_slots,
           cudaStream_t stream) {
  const size_t smem = smem_words(N, n_slots, R) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      pruning_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T, (X + kBlockX - 1) / kBlockX);
  pruning_kernel<R><<<grid, kBlockX, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(penc), static_cast<const float*>(length),
      static_cast<const int32_t*>(root), static_cast<const float*>(u),
      static_cast<const float*>(uinv), static_cast<const float*>(lam),
      static_cast<const float*>(rates), static_cast<const float*>(pi),
      static_cast<float*>(out), X, N, n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t lh_pruning_smem_bytes(int n_entries, int n_slots, int n_rates) {
  return smem_words(n_entries, n_slots, n_rates) * 4;
}

// Launch on `stream`; returns a cudaError_t (0 on success).  R must be one
// of 1, 2, 4, 8.
int lh_pruning_launch(const void* codes, const void* src, const void* penc,
                      const void* length, const void* root, const void* u,
                      const void* uinv, const void* lam, const void* rates,
                      const void* pi, void* out, int T, int N, int X,
                      int n_slots, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<1>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, T, N, X, n_slots, s);
    case 2: return launch<2>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, T, N, X, n_slots, s);
    case 4: return launch<4>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, T, N, X, n_slots, s);
    case 8: return launch<8>(codes, src, penc, length, root, u, uinv, lam, rates, pi, out, T, N, X, n_slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
