// Train-mode BatchNorm (Keras defaults, Flax's fast variance) for Hopper
// (sm_90a): the forward and backward of models/layers.py::KerasBatchNorm in
// training mode.
//
// Replaces no TPU kernel: the JAX package leaves Flax's BatchNorm to XLA's
// fusion (audio_training_tpu/models/layers.py:121-143).  Eager PyTorch has
// no such fusion, and the plain version (KerasBatchNorm.train_plain, CPU
// tensors) streams each activation through device memory about 30 times in
// float32: the f32 copy, the two moments, the broadcast affine on an NCHW
// view of a channels-last tensor, the cast back, and autograd's replay of
// each.
//
// What bounds it on the H100: bytes.  A train-mode BatchNorm needs four
// streaming passes: the forward reads x for the statistics and reads x and
// writes y; the backward reads x and dy for two per-channel sums, then reads
// x and dy and writes dx.  That is 8 element accesses: 16 bytes an element
// in bf16, 24 bytes with an f32 activation (badwinner2's per-mel-row BN at
// the input), against 3.35 TB/s.  The per-channel statistics are a few KB.
//
// What the design does about it.  Every pass streams its tensors once, in
// their own dtype, with f32 arithmetic in registers:
//   * reduce: per-channel sum x and sum x^2 (forward) or sum dy and
//     sum dy (x - mean) (backward); each block writes its partials;
//   * finalize: one warp a channel sums the partials in a fixed order
//     (lane-strided, then a butterfly), then computes the statistics (mean,
//     max(E[x^2] - mean^2, 0), rsqrt(var + eps), Flax's running update) or
//     the parameter gradients;
//   * apply: y = (x - mean) * (rstd * weight) + bias, or
//     dx = w rstd (dy - sum dy / N - (x - mean) k sum dy (x - mean) / N),
//     k = rstd^2 where the variance clamp was inactive and 0 where it was.
// No float atomics: the grid is a function of the shape and the card, and
// each sum is taken in one order, so two runs give the same bits.
//
// Two dense layouts, chosen by the wrapper from the input's strides as an
// (outer, C, inner) view:
//   * rows (inner == 1, channels innermost: a channels-last conv output):
//     a thread owns one 16-byte group of channels (8 bf16 or 4 f32; one
//     channel where C or the address does not allow it) and walks rows, a
//     block's threads spread over a row's groups and over rows;
//   * middle (inner > 1: the per-mel-row BN's (B, 160, 513) view and
//     NCHW-contiguous tensors): the reduce takes a block a (channel, split
//     of outer) and walks its rows of `inner` contiguous values; the apply
//     takes a chunk of consecutive rows at a time, their coefficients
//     computed once into shared memory.  Both carry the column index into
//     the row instead of dividing at each element.
//
// The same file holds the eval-mode conv epilogue (bn_eval_epilogue): the
// conv's bias, the BatchNorm's affine from its running statistics, SiLU or
// LeakyReLU and a residual in one pass, on the two layouts above (the rows
// layout walked flat, each thread on the same channels at every step).  It
// reads the conv's bias-free output once and writes the block's output
// once, 4 bytes an element in bf16 (6 with a residual), where PyTorch's
// eval path runs the bias add, the BatchNorm, the activation and the
// residual add as a pass each.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // every kernel's block (the wrapper's plan)
constexpr int UNROLL = 4;     // rows a thread loads before it adds

using bf16 = __nv_bfloat16;

// VEC elements of T as one load: 16 bytes, or one element when VEC is 1.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ void to_float(const Raw<T, VEC>& r, float* v) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same_v<T, float>) {
      v[0] = r;
    } else {
      v[0] = __bfloat162float(r);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(VEC == 4, "16 bytes of f32");
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = f[k];
  } else {
    static_assert(VEC == 8, "16 bytes of bf16");
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> from_float(const float* v) {
  Raw<T, VEC> r;
  if constexpr (VEC == 1) {
    if constexpr (std::is_same_v<T, float>) {
      r = v[0];
    } else {
      r = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    float* f = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = v[k];
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  return r;
}

// The statistics the forward's finalize writes: mean[C], rstd[C], k[C] and
// the row count N at [3C].
struct Stats {
  const float* p;
  int C;
  __device__ float mean(int c) const { return p[c]; }
  __device__ float rstd(int c) const { return p[C + c]; }
  __device__ float k(int c) const { return p[2 * C + c]; }
  __device__ float count() const { return p[3 * C]; }
};

// One channel's affine: forward y = (x - m) * p + q (q added only with a
// bias, as the plain version adds none); backward dx = p (dy - q - (x - m) r).
struct Coef {
  float m, p, q, r;
};

template <bool BWD>
__device__ __forceinline__ Coef coef(int c, Stats st,
                                     const float* __restrict__ weight,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ sums) {
  Coef k;
  k.m = st.mean(c);
  const float rstd = st.rstd(c);
  k.p = weight ? __fmul_rn(rstd, weight[c]) : rstd;
  if constexpr (BWD) {
    const float n = st.count();
    k.q = __fdiv_rn(sums[c], n);
    k.r = __fdiv_rn(__fmul_rn(st.k(c), sums[st.C + c]), n);
  } else {
    k.q = bias ? bias[c] : 0.0f;
    k.r = 0.0f;
  }
  return k;
}

template <bool BWD>
__device__ __forceinline__ float affine(float x, float g, const Coef& k,
                                        bool has_bias) {
  const float xc = __fsub_rn(x, k.m);
  if constexpr (BWD) {
    return __fmul_rn(k.p, __fsub_rn(__fsub_rn(g, k.q), __fmul_rn(xc, k.r)));
  } else {
    const float y = __fmul_rn(xc, k.p);
    return has_bias ? __fadd_rn(y, k.q) : y;
  }
}

// Forward: a += x, b += x^2.  Backward: a += dy, b += dy (x - mean).
template <bool BWD>
__device__ __forceinline__ void accumulate(float& a, float& b, float x,
                                           float g, float m) {
  if constexpr (BWD) {
    a += g;
    b = fmaf(g, x - m, b);
  } else {
    a += x;
    b = fmaf(x, x, b);
  }
}

// ---- rows layout: (rows, C) with C contiguous -----------------------------
//
// groups = C / VEC channel groups; a block's threads are `lanes` groups of
// a row by `per` rows (lanes = min(groups, THREADS), per = THREADS / lanes),
// and wider rows take chunks of `lanes` groups in turn.  Block b walks rows
// b * per + sub, stepping gridDim.x * per.

struct RowsShape {
  int lanes, per, lane, sub;
  __device__ RowsShape(int groups) {
    lanes = groups < THREADS ? groups : THREADS;
    per = THREADS / lanes;
    lane = threadIdx.x % lanes;
    sub = threadIdx.x / lanes;
  }
};

// partials[(w * C + c) * gridDim.x + block], w = 0 for the first sum.
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(THREADS)
    reduce_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ mean, long long rows, int C,
                       float* __restrict__ partials) {
  using R = Raw<T, VEC>;
  __shared__ float red[THREADS * 2 * VEC];
  const int groups = C / VEC;
  const RowsShape s(groups);
  const long long step = static_cast<long long>(gridDim.x) * s.per;
  for (int g0 = 0; g0 < groups; g0 += s.lanes) {
    const int g = g0 + s.lane;
    const bool on = s.sub < s.per && g < groups;
    float a[VEC], b[VEC], m[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = b[k] = 0.0f;
      m[k] = (BWD && on) ? mean[g * VEC + k] : 0.0f;
    }
    if (on) {
      const R* xr = reinterpret_cast<const R*>(x) + g;
      const R* gr = reinterpret_cast<const R*>(dy) + g;
      long long r = static_cast<long long>(blockIdx.x) * s.per + s.sub;
      for (; r + (UNROLL - 1) * step < rows; r += UNROLL * step) {
        R xv[UNROLL], gv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          xv[u] = xr[(r + u * step) * groups];
          if constexpr (BWD) gv[u] = gr[(r + u * step) * groups];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float xf[VEC], gf[VEC];
          to_float<T, VEC>(xv[u], xf);
          if constexpr (BWD) to_float<T, VEC>(gv[u], gf);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            accumulate<BWD>(a[k], b[k], xf[k], BWD ? gf[k] : 0.0f, m[k]);
        }
      }
      for (; r < rows; r += step) {
        float xf[VEC], gf[VEC];
        to_float<T, VEC>(xr[r * groups], xf);
        if constexpr (BWD) to_float<T, VEC>(gr[r * groups], gf);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          accumulate<BWD>(a[k], b[k], xf[k], BWD ? gf[k] : 0.0f, m[k]);
      }
    }
    __syncthreads();  // the previous chunk's sums are read
    if (on) {
      float* mine = red + (s.sub * s.lanes + s.lane) * 2 * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        mine[k] = a[k];
        mine[VEC + k] = b[k];
      }
    }
    __syncthreads();
    // the block's sum of each (group, sum, channel): its rows in order
    for (int o = threadIdx.x; o < s.lanes * 2 * VEC; o += THREADS) {
      const int ln = o / (2 * VEC), j = o % (2 * VEC);
      const int gg = g0 + ln;
      if (gg >= groups) continue;
      float t = 0.0f;
      for (int q = 0; q < s.per; ++q) t += red[(q * s.lanes + ln) * 2 * VEC + j];
      const int c = gg * VEC + j % VEC;
      partials[(static_cast<long long>(j / VEC) * C + c) * gridDim.x + blockIdx.x] = t;
    }
  }
}

template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(THREADS)
    apply_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ stats,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias,
                      const float* __restrict__ sums, long long rows, int C,
                      T* __restrict__ out) {
  using R = Raw<T, VEC>;
  const int groups = C / VEC;
  const RowsShape s(groups);
  if (s.sub >= s.per) return;
  const long long step = static_cast<long long>(gridDim.x) * s.per;
  const Stats st{stats, C};
  const bool has_bias = bias != nullptr;
  for (int g = s.lane; g < groups; g += s.lanes) {
    Coef k[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) k[v] = coef<BWD>(g * VEC + v, st, weight, bias, sums);
    const R* xr = reinterpret_cast<const R*>(x) + g;
    const R* gr = reinterpret_cast<const R*>(dy) + g;
    R* orow = reinterpret_cast<R*>(out) + g;
    long long r = static_cast<long long>(blockIdx.x) * s.per + s.sub;
    for (; r + (UNROLL - 1) * step < rows; r += UNROLL * step) {
      R xv[UNROLL], gv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        xv[u] = xr[(r + u * step) * groups];
        if constexpr (BWD) gv[u] = gr[(r + u * step) * groups];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float xf[VEC], gf[VEC], o[VEC];
        to_float<T, VEC>(xv[u], xf);
        if constexpr (BWD) to_float<T, VEC>(gv[u], gf);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          o[v] = affine<BWD>(xf[v], BWD ? gf[v] : 0.0f, k[v], has_bias);
        orow[(r + u * step) * groups] = from_float<T, VEC>(o);
      }
    }
    for (; r < rows; r += step) {
      float xf[VEC], gf[VEC], o[VEC];
      to_float<T, VEC>(xr[r * groups], xf);
      if constexpr (BWD) to_float<T, VEC>(gr[r * groups], gf);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        o[v] = affine<BWD>(xf[v], BWD ? gf[v] : 0.0f, k[v], has_bias);
      orow[r * groups] = from_float<T, VEC>(o);
    }
  }
}

// ---- middle layout: (outer, C, inner) -------------------------------------

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return *p;
  } else {
    return __bfloat162float(*p);
  }
}

// The block's sum of (a, b) in a fixed order: a butterfly in each warp, then
// the warps in order.  Valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float warp_sums[THREADS / 32][2];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (threadIdx.x % 32 == 0) {
    warp_sums[threadIdx.x / 32][0] = a;
    warp_sums[threadIdx.x / 32][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) {
      a += warp_sums[w][0];
      b += warp_sums[w][1];
    }
  }
}

// grid C * splits: block (c, s) sums outer rows [s * per, (s + 1) * per) of
// channel c; partials[(w * C + c) * splits + s].  A thread walks the flat
// index j of its block's (row, i) pairs in steps of THREADS, carrying i into
// the row (no division an element).
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
    reduce_mid_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ mean, long long outer, int C,
                      long long inner, int splits,
                      float* __restrict__ partials) {
  const int c = blockIdx.x % C, sp = blockIdx.x / C;
  const long long per = (outer + splits - 1) / splits;
  const long long o0 = sp * per;
  const long long o1 = o0 + per < outer ? o0 + per : outer;
  const long long n = o1 > o0 ? (o1 - o0) * inner : 0;
  const long long d_row = THREADS / inner, d_i = THREADS % inner;
  const long long row_step = static_cast<long long>(C) * inner;
  const float m = BWD ? mean[c] : 0.0f;
  float a = 0.0f, b = 0.0f;
  long long i = threadIdx.x % inner;
  long long e = (o0 + threadIdx.x / inner) * row_step + c * inner + i;
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += THREADS) {
    accumulate<BWD>(a, b, load1(x + e), BWD ? load1(dy + e) : 0.0f, m);
    i += d_i;
    e += d_row * row_step + d_i;
    if (i >= inner) {
      i -= inner;
      e += row_step - inner;
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    partials[static_cast<long long>(c) * splits + sp] = a;
    partials[static_cast<long long>(C + c) * splits + sp] = b;
  }
}

constexpr int CHUNK_MAX = 64;  // rows of the apply's chunk (the wrapper's)

// A block takes `chunk` consecutive (outer, c) rows of `inner` at a time,
// computes their coefficients once into shared memory, and runs flat over
// the chunk's elements, carrying the column into the row.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
    apply_mid_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ stats,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     const float* __restrict__ sums, long long rows, int C,
                     long long inner, int chunk, T* __restrict__ out) {
  __shared__ Coef ks[CHUNK_MAX];
  const Stats st{stats, C};
  const bool has_bias = bias != nullptr;
  const long long d_row = THREADS / inner, d_i = THREADS % inner;
  const long long row0 = threadIdx.x / inner, i0 = threadIdx.x % inner;
  for (long long r0 = static_cast<long long>(blockIdx.x) * chunk; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * chunk) {
    const long long nr = rows - r0 < chunk ? rows - r0 : chunk;
    __syncthreads();  // the previous chunk's coefficients are read
    for (int t = threadIdx.x; t < nr; t += THREADS)
      ks[t] = coef<BWD>(static_cast<int>((r0 + t) % C), st, weight, bias, sums);
    __syncthreads();
    const long long n = nr * inner, base = r0 * inner;
    long long row = row0, i = i0;
#pragma unroll 4
    for (long long j = threadIdx.x; j < n; j += THREADS) {
      const long long e = base + j;
      const float o = affine<BWD>(load1(x + e), BWD ? load1(dy + e) : 0.0f,
                                  ks[row], has_bias);
      if constexpr (std::is_same_v<T, float>) {
        out[e] = o;
      } else {
        out[e] = __float2bfloat16_rn(o);
      }
      i += d_i;
      row += d_row;
      if (i >= inner) {
        i -= inner;
        ++row;
      }
    }
  }
}

// ---- finalize: one warp a channel -----------------------------------------

// The warp's sum of partials[(w * C + c) * n + i] over i, in a fixed order;
// every lane holds it.
__device__ __forceinline__ float warp_partial_sum(const float* __restrict__ p,
                                                  int n, int lane) {
  float t = 0.0f;
  for (int i = lane; i < n; i += 32) t += p[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// sums_only: sums = [sum x, sum x^2, count] for the caller's all-reduce.
// Otherwise the statistics from the partials (or from an all-reduced sums
// tensor, n == 1, the count read at count_ptr) and the running update.
__global__ void __launch_bounds__(THREADS)
    finalize_kernel(const float* __restrict__ partials, int n, int C,
                    int sums_only, float count,
                    const float* __restrict__ count_ptr, float eps, float keep,
                    float take, float* __restrict__ stats,
                    float* __restrict__ running_mean,
                    float* __restrict__ running_var, float* __restrict__ sums) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;
  const float s = warp_partial_sum(partials + static_cast<long long>(c) * n, n, lane);
  const float q = warp_partial_sum(partials + static_cast<long long>(C + c) * n, n, lane);
  if (lane != 0) return;
  if (sums_only) {
    sums[c] = s;
    sums[C + c] = q;
    if (c == 0) sums[2 * C] = count;
    return;
  }
  const float rows = count_ptr ? *count_ptr : count;
  const float mean = __fdiv_rn(s, rows);
  const float d = __fsub_rn(__fdiv_rn(q, rows), __fmul_rn(mean, mean));
  const float var = d < 0.0f ? 0.0f : d;  // clamp_min: a NaN stays NaN
  // 1 / sqrt, each rounded, as torch.rsqrt on the CPU
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  stats[c] = mean;
  stats[C + c] = rstd;
  stats[2 * C + c] = d < 0.0f ? 0.0f : __fmul_rn(rstd, rstd);
  if (c == 0) stats[3 * C] = rows;
  running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(take, mean));
  running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(take, var));
}

// sums = [sum dy, sum dy (x - mean)] (this rank's), dweight = rstd * the
// second, dbias = the first.
__global__ void __launch_bounds__(THREADS)
    finalize_backward_kernel(const float* __restrict__ partials, int n, int C,
                             const float* __restrict__ stats,
                             float* __restrict__ sums,
                             float* __restrict__ dweight,
                             float* __restrict__ dbias) {
  const int c = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;
  const float sg = warp_partial_sum(partials + static_cast<long long>(c) * n, n, lane);
  const float sgx = warp_partial_sum(partials + static_cast<long long>(C + c) * n, n, lane);
  if (lane != 0) return;
  sums[c] = sg;
  sums[C + c] = sgx;
  if (dweight) dweight[c] = __fmul_rn(sgx, stats[C + c]);
  if (dbias) dbias[c] = sg;
}

// ---- eval conv epilogue ---------------------------------------------------
//
// The work after an eval-mode conv in one pass: the conv's bias b, the
// BatchNorm's running-statistics affine (s = weight * rsqrt(var + eps),
// t = bias - mean * s), the activation and the residual r, in f32, rounded
// once to the output's dtype:
//   activation before the affine (FIRST): z = act(x + b) * s + t + r;
//   after it:                             z = act(x * s + t') + r, t' = t + b s.
// The coefficients are computed from the parameters themselves where they
// are needed (no launch for them, nothing cached between calls); x (and r)
// are streamed once and z written once.

enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_LEAKY = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float z, float slope) {
  if constexpr (ACT == ACT_SILU) {
    return __fdividef(z, 1.0f + __expf(-z));  // 0 where exp(-z) overflows
  } else if constexpr (ACT == ACT_LEAKY) {
    return z > 0.0f ? z : z * slope;
  } else {
    return z;
  }
}

struct EpilogueArgs {
  const float* conv_bias;
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps, slope;
};

// One channel's (s, t, b), t folded to t' and b unused after the affine.
struct EpiCoef {
  float s, t, b;
};

template <bool FIRST>
__device__ __forceinline__ EpiCoef epilogue_coef(int c, const EpilogueArgs& a) {
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(a.var[c], a.eps)));
  const float s = a.weight ? __fmul_rn(rstd, a.weight[c]) : rstd;
  const float t = (a.bias ? a.bias[c] : 0.0f) - __fmul_rn(a.mean[c], s);
  const float b = a.conv_bias ? a.conv_bias[c] : 0.0f;
  if constexpr (FIRST) {
    return {s, t, b};
  } else {
    return {s, fmaf(b, s, t), 0.0f};
  }
}

template <int ACT, bool FIRST>
__device__ __forceinline__ float epilogue(float x, const EpiCoef& k,
                                          float slope) {
  if constexpr (FIRST) {
    return fmaf(activate<ACT>(x + k.b, slope), k.s, k.t);
  } else {
    return activate<ACT>(fmaf(x, k.s, k.t), slope);
  }
}

// Rows: (rows, C) with C contiguous, walked flat as n_vec groups of VEC
// channels, a thread from j = block * THREADS + thread in steps of the
// grid's threads.  The wrapper makes that step a multiple of C / VEC, so a
// thread's channels are the same at every step: their coefficients are
// computed once, into registers, and every thread of the grid works on any
// channel count.
template <typename T, int VEC, int ACT, bool FIRST>
__global__ void __launch_bounds__(THREADS)
    epilogue_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         EpilogueArgs a, long long n_vec, int C,
                         T* __restrict__ out) {
  using R = Raw<T, VEC>;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= n_vec) return;
  const int g = static_cast<int>(j % (C / VEC));
  EpiCoef k[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) k[v] = epilogue_coef<FIRST>(g * VEC + v, a);
  const R* xr = reinterpret_cast<const R*>(x);
  const R* rr = reinterpret_cast<const R*>(res);
  R* orow = reinterpret_cast<R*>(out);
  const bool has_res = res != nullptr;
  auto one = [&](const R& xv, const R& rv) {
    float xf[VEC], rf[VEC], o[VEC];
    to_float<T, VEC>(xv, xf);
    if (has_res) to_float<T, VEC>(rv, rf);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      o[v] = epilogue<ACT, FIRST>(xf[v], k[v], a.slope);
      if (has_res) o[v] += rf[v];
    }
    return from_float<T, VEC>(o);
  };
  for (; j + (UNROLL - 1) * step < n_vec; j += UNROLL * step) {
    R xv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = xr[j + u * step];
      rv[u] = has_res ? rr[j + u * step] : xv[u];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) orow[j + u * step] = one(xv[u], rv[u]);
  }
  for (; j < n_vec; j += step) orow[j] = one(xr[j], has_res ? rr[j] : xr[j]);
}

// Middle: (outer, C, inner), inner > 1.  As apply_mid_kernel: a block takes
// `chunk` consecutive (outer, c) rows at a time, their coefficients into
// shared memory, and walks the chunk's elements flat, carrying the column
// into the row.
template <typename T, int ACT, bool FIRST>
__global__ void __launch_bounds__(THREADS)
    epilogue_mid_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        EpilogueArgs a, long long rows, int C,
                        long long inner, int chunk, T* __restrict__ out) {
  __shared__ EpiCoef ks[CHUNK_MAX];
  const long long d_row = THREADS / inner, d_i = THREADS % inner;
  const long long row0 = threadIdx.x / inner, i0 = threadIdx.x % inner;
  for (long long r0 = static_cast<long long>(blockIdx.x) * chunk; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * chunk) {
    const long long nr = rows - r0 < chunk ? rows - r0 : chunk;
    __syncthreads();  // the previous chunk's coefficients are read
    for (int q = threadIdx.x; q < nr; q += THREADS)
      ks[q] = epilogue_coef<FIRST>(static_cast<int>((r0 + q) % C), a);
    __syncthreads();
    const long long n = nr * inner, base = r0 * inner;
    long long row = row0, i = i0;
#pragma unroll 4
    for (long long j = threadIdx.x; j < n; j += THREADS) {
      const long long e = base + j;
      float o = epilogue<ACT, FIRST>(load1(x + e), ks[row], a.slope);
      if (res) o += load1(res + e);
      if constexpr (std::is_same_v<T, float>) {
        out[e] = o;
      } else {
        out[e] = __float2bfloat16_rn(o);
      }
      i += d_i;
      row += d_row;
      if (i >= inner) {
        i -= inner;
        ++row;
      }
    }
  }
}

template <typename T, int VEC, int ACT, bool FIRST>
cudaError_t epilogue_launch(const void* x, const void* res,
                            const EpilogueArgs& a, long long outer, int C,
                            long long inner, int blocks, int chunk,
                            void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (inner == 1) {
    epilogue_rows_kernel<T, VEC, ACT, FIRST><<<blocks, THREADS, 0, stream>>>(
        xt, rt, a, outer * C / VEC, C, ot);
  } else {
    epilogue_mid_kernel<T, ACT, FIRST><<<blocks, THREADS, 0, stream>>>(
        xt, rt, a, outer * C, C, inner, chunk, ot);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t epilogue_by_act(int act, int first, const void* x,
                            const void* res, const EpilogueArgs& a,
                            long long outer, int C, long long inner,
                            int blocks, int chunk, void* out,
                            cudaStream_t s) {
  if (act == ACT_SILU) {
    return first ? epilogue_launch<T, VEC, ACT_SILU, true>(x, res, a, outer, C, inner, blocks, chunk, out, s)
                 : epilogue_launch<T, VEC, ACT_SILU, false>(x, res, a, outer, C, inner, blocks, chunk, out, s);
  }
  if (act == ACT_LEAKY) {
    return first ? epilogue_launch<T, VEC, ACT_LEAKY, true>(x, res, a, outer, C, inner, blocks, chunk, out, s)
                 : epilogue_launch<T, VEC, ACT_LEAKY, false>(x, res, a, outer, C, inner, blocks, chunk, out, s);
  }
  // no activation: both orders are the same function
  return epilogue_launch<T, VEC, ACT_NONE, false>(x, res, a, outer, C, inner, blocks, chunk, out, s);
}

template <typename T, int VEC>
cudaError_t reduce_launch(bool bwd, const void* x, const void* dy,
                          const float* mean, long long outer, int C,
                          long long inner, int blocks, float* partials,
                          cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  if (inner == 1) {
    auto kernel = bwd ? reduce_rows_kernel<T, VEC, true>
                      : reduce_rows_kernel<T, VEC, false>;
    kernel<<<blocks, THREADS, 0, stream>>>(xt, gt, mean, outer, C, partials);
  } else {
    auto kernel = bwd ? reduce_mid_kernel<T, true> : reduce_mid_kernel<T, false>;
    kernel<<<C * blocks, THREADS, 0, stream>>>(xt, gt, mean, outer, C, inner,
                                               blocks, partials);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t apply_launch(bool bwd, const void* x, const void* dy,
                         const float* stats, const float* weight,
                         const float* bias, const float* sums,
                         long long outer, int C, long long inner, int blocks,
                         int chunk, void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* ot = static_cast<T*>(out);
  if (inner == 1) {
    auto kernel = bwd ? apply_rows_kernel<T, VEC, true>
                      : apply_rows_kernel<T, VEC, false>;
    kernel<<<blocks, THREADS, 0, stream>>>(xt, gt, stats, weight, bias, sums,
                                           outer, C, ot);
  } else {
    auto kernel = bwd ? apply_mid_kernel<T, true> : apply_mid_kernel<T, false>;
    kernel<<<blocks, THREADS, 0, stream>>>(xt, gt, stats, weight, bias, sums,
                                           outer * C, C, inner, chunk, ot);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  vec: elements a thread loads at once in
// the rows layout (inner == 1): 1, or 16 bytes' worth (C a multiple of it,
// every pointer 16-byte aligned).  blocks: the partials a channel gets (the
// rows layout's grid; the middle layout's splits of outer, grid C x blocks).
// bwd 0: sum x, sum x^2 of x; bwd 1: sum dy, sum dy (x - mean).
int bn_reduce(int bwd, int dtype, int vec, const void* x, const void* dy,
              const float* mean, long long outer, int C, long long inner,
              int blocks, float* partials, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec == 4 ? reduce_launch<float, 4>(bwd, x, dy, mean, outer, C, inner, blocks, partials, s)
                   : reduce_launch<float, 1>(bwd, x, dy, mean, outer, C, inner, blocks, partials, s);
  } else {
    err = vec == 8 ? reduce_launch<bf16, 8>(bwd, x, dy, mean, outer, C, inner, blocks, partials, s)
                   : reduce_launch<bf16, 1>(bwd, x, dy, mean, outer, C, inner, blocks, partials, s);
  }
  return static_cast<int>(err);
}

// The partials (n a channel) to the statistics, see finalize_kernel.
int bn_finalize(const float* partials, int n, int C, int sums_only,
                float count, const float* count_ptr, float eps, float keep,
                float take, float* stats, float* running_mean,
                float* running_var, float* sums, void* stream) {
  const int grid = (C * 32 + THREADS - 1) / THREADS;
  finalize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n, C, sums_only, count, count_ptr, eps, keep, take, stats,
      running_mean, running_var, sums);
  return static_cast<int>(cudaGetLastError());
}

// dweight / dbias may be null.
int bn_finalize_backward(const float* partials, int n, int C,
                         const float* stats, float* sums, float* dweight,
                         float* dbias, void* stream) {
  const int grid = (C * 32 + THREADS - 1) / THREADS;
  finalize_backward_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      partials, n, C, stats, sums, dweight, dbias);
  return static_cast<int>(cudaGetLastError());
}

// bwd 0: out = y; bwd 1: out = dx from dy and the (all-reduced) sums.
// weight / bias may be null.  blocks: the grid.  chunk: the middle layout's
// rows a block takes at a time (1 to CHUNK_MAX).
int bn_apply(int bwd, int dtype, int vec, const void* x, const void* dy,
             const float* stats, const float* weight, const float* bias,
             const float* sums, long long outer, int C, long long inner,
             int blocks, int chunk, void* out, void* stream) {
  if (inner > 1 && (chunk < 1 || chunk > CHUNK_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec == 4 ? apply_launch<float, 4>(bwd, x, dy, stats, weight, bias, sums, outer, C, inner, blocks, chunk, out, s)
                   : apply_launch<float, 1>(bwd, x, dy, stats, weight, bias, sums, outer, C, inner, blocks, chunk, out, s);
  } else {
    err = vec == 8 ? apply_launch<bf16, 8>(bwd, x, dy, stats, weight, bias, sums, outer, C, inner, blocks, chunk, out, s)
                   : apply_launch<bf16, 1>(bwd, x, dy, stats, weight, bias, sums, outer, C, inner, blocks, chunk, out, s);
  }
  return static_cast<int>(err);
}

// The eval conv epilogue, see epilogue_rows_kernel: out = z of x (and res,
// null for none) in x's (outer, C, inner) layout.  act: 0 none, 1 SiLU,
// 2 LeakyReLU of `slope`; first: the activation before the affine.
// conv_bias, weight and bias may be null; mean and var are the running
// statistics.  vec as bn_apply's (x, res and out 16-byte aligned).
// blocks: the grid, in the rows layout (inner == 1) a multiple of
// C / vec / gcd(C / vec, THREADS) (every thread's channels fixed); chunk as
// bn_apply's.
int bn_eval_epilogue(int dtype, int vec, int act, int first, const void* x,
                     const void* res, const float* conv_bias,
                     const float* mean, const float* var,
                     const float* weight, const float* bias, float eps,
                     float slope, long long outer, int C, long long inner,
                     int blocks, int chunk, void* out, void* stream) {
  if ((inner > 1 && (chunk < 1 || chunk > CHUNK_MAX))
      || (inner == 1 && static_cast<long long>(blocks) * THREADS % (C / vec) != 0)
      || act < 0 || act > ACT_LEAKY)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const EpilogueArgs a{conv_bias, mean, var, weight, bias, eps, slope};
  cudaError_t err;
  if (dtype == 0) {
    err = vec == 4 ? epilogue_by_act<float, 4>(act, first, x, res, a, outer, C, inner, blocks, chunk, out, s)
                   : epilogue_by_act<float, 1>(act, first, x, res, a, outer, C, inner, blocks, chunk, out, s);
  } else {
    err = vec == 8 ? epilogue_by_act<bf16, 8>(act, first, x, res, a, outer, C, inner, blocks, chunk, out, s)
                   : epilogue_by_act<bf16, 1>(act, first, x, res, a, outer, C, inner, blocks, chunk, out, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
