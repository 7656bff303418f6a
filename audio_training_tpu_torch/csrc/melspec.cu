// Fused power spectrum + mel projection for Hopper (sm_90a).
//
// Replaces: audio_training_tpu/ops/pallas/melspec.py::_power_mel_kernel (the
// TPU kernel launched by fused_power_mel).  Same function --
// out[r, m] = sum_f (re^2 + im^2)[r, f] * W[f, m] in fp32, r running over the
// (batch, frame) rows of a time-major STFT -- but not the TPU blocking: no
// padding of T, F and M to 128-multiples by the caller (the ragged rows are
// masked here), no resident copy of the dense weight matrix, and no dense
// product.  The squared modulus is computed while the STFT is staged into
// shared memory, so the power spectrum never reaches device memory.
//
// What bounds it on the H100.  The mel bank is band-sparse: each filter is
// non-zero on one contiguous band of bins, and the bank as a whole on its
// support [lo, hi), the union of the bands.  At the long-recording
// Predictor's n_fft=2048 shape (64 windows x 513 frames x 1025 bins, 160
// mels, FMAX 11000 Hz) the support is about 470 bins and the bank has about
// 940 non-zeros, so the work the data needs is ~0.07 GFLOP, while the bytes
// it must move are the support's complex STFT in (~123 MB) and the mel out
// (21 MB): about 0.045 ms at 3.35 TB/s.  The function is bound by the bytes.
//
// What the design does.  The wrapper builds each filter's band (start,
// length, offset into a flat weight list; ops/mel.py::band_tables) once on
// the host.  A block takes a tile of ROWS rows and stages only the power of
// the support bins in shared memory, each element read once: the complex64
// STFT as float4 loads (two complex values; the pair grid is aligned to 16
// bytes from the tensor's address, and the elements of a pair outside the
// support are dropped), neighbouring threads on neighbouring pairs.  Then
// each thread walks one filter's band for RPT rows of the tile, the weight
// read once for all RPT rows, and the mel tile is stored with neighbouring
// threads on neighbouring mels.  Plain fp32 FMA on CUDA cores, as the JAX
// kernel's Precision.HIGHEST.
//
// Semantics: bins outside every band enter no sum, so a NaN or inf there no
// longer reaches the output (the dense product spread it to every mel, 0 *
// inf = NaN); K1's exact tier behaves the same way.  On finite input the
// result is the dense product's up to the order of the sums.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;  // (batch, frame) rows per block
constexpr int RPT = 8;    // rows per thread in the band walk
constexpr int RG = ROWS / RPT;

// grid ceil(rows / ROWS), blockDim >= 32, dynamic shared memory ROWS x
// support floats.  The STFT element (row, f) is re[e], im[e] with e = row *
// n_freq + f (kInterleaved false: two float tensors) or re[2 e], re[2 e + 1]
// (kInterleaved: a complex64 tensor read in place).  Bands are relative to
// bin 0; lo is the support's first bin.
template <bool kInterleaved>
__global__ void power_mel_kernel(const float* __restrict__ re,
                                 const float* __restrict__ im, int rows,
                                 int n_freq, int lo, int support,
                                 const int* __restrict__ band_start,
                                 const int* __restrict__ band_len,
                                 const int* __restrict__ band_off,
                                 const float* __restrict__ band_w, int n_mels,
                                 float* __restrict__ out) {
  extern __shared__ float power[];  // ROWS x support
  const int row0 = blockIdx.x * ROWS;

  // 1. the power of the support bins of the tile's rows
  if (kInterleaved) {
    // pairs of complex elements on the 16-byte grid: pair p holds the
    // elements 2p - a0 and 2p + 1 - a0 of the tensor
    const int a0 = static_cast<int>((reinterpret_cast<uintptr_t>(re) >> 3) & 1);
    const float4* pairs = reinterpret_cast<const float4*>(re - 2 * a0);
    const int per_row = support / 2 + 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int q = i - r * per_row;
      const int row = row0 + r;
      if (row >= rows) continue;
      const long long first =
          static_cast<long long>(row) * n_freq + lo;  // element of bin lo
      const long long p = ((first + a0) >> 1) + q;
      const int k = static_cast<int>(2 * p - a0 - first);  // bin - lo, >= -1
      if (k >= support) continue;
      const float4 v = __ldg(pairs + p);
      float* dst = power + r * support + k;
      if (k >= 0) dst[0] = v.x * v.x + v.y * v.y;
      if (k + 1 < support) dst[1] = v.z * v.z + v.w * v.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * support; i += blockDim.x) {
      const int r = i / support;
      const int row = row0 + r;
      if (row >= rows) continue;
      const size_t e = static_cast<size_t>(row) * n_freq + lo + (i - r * support);
      const float x = __ldg(re + e);
      const float y = __ldg(im + e);
      power[i] = x * x + y * y;
    }
  }
  __syncthreads();

  // 2. each (filter, row group): the band walk, one weight for RPT rows;
  //    a warp stores 32 neighbouring mels of a row
  for (int i = threadIdx.x; i < n_mels * RG; i += blockDim.x) {
    const int m = i % n_mels;
    const int g = i / n_mels;
    const int len = __ldg(band_len + m);
    const float* w = band_w + __ldg(band_off + m);
    const float* p = power + g * RPT * support + (__ldg(band_start + m) - lo);
    float acc[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = 0.f;
    for (int j = 0; j < len; ++j) {
      const float wj = __ldg(w + j);
#pragma unroll
      for (int k = 0; k < RPT; ++k) acc[k] = fmaf(wj, p[k * support + j], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int row = row0 + g * RPT + k;
      if (row < rows) out[static_cast<size_t>(row) * n_mels + m] = acc[k];
    }
  }
}

}  // namespace

extern "C" {

// stride 2: re points at an interleaved complex64 tensor (im is unused);
// stride 1: re and im are two float tensors.  Bands: n_mels entries of
// start / length / offset into band_w; the support is [lo, lo + support).
int pm_power_mel(const float* re, const float* im, int stride, int rows,
                 int n_freq, int lo, int support, const int* band_start,
                 const int* band_len, const int* band_off, const float* band_w,
                 int n_mels, float* out, void* stream) {
  const size_t smem = sizeof(float) * ROWS * support;
  const int want = (n_mels * RG + 31) / 32 * 32;
  const int threads = want < 1024 ? want : 1024;
  const auto kernel = stride == 2 ? power_mel_kernel<true>
                                  : power_mel_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + ROWS - 1) / ROWS;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      re, im, rows, n_freq, lo, support, band_start, band_len, band_off,
      band_w, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
