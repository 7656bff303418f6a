// Fused power spectrum + mel projection for Hopper (sm_90a).
//
// Replaces: audio_training_tpu/ops/pallas/melspec.py::_power_mel_kernel (the
// TPU kernel launched by fused_power_mel).  Same math --
// out[r, m] = sum_f (re^2 + im^2)[r, f] * W[f, m] in exact fp32, r running
// over the (batch, frame) rows of a time-major STFT -- but not the TPU
// blocking: no padding of T, F and M to 128-multiples by the caller (the
// ragged edges are masked here) and no resident VMEM copy of the whole
// weight matrix.  The squared modulus is computed while the STFT tile is
// staged into shared memory, so the power spectrum never reaches device
// memory.
//
// What bounds it on the H100.  At the long-recording Predictor's n_fft=2048
// shape (64 windows x 513 frames x 1025 bins, 160 mels) the dense product is
// 10.8 GFLOP (0.16 ms at the card's 67 TFLOP/s fp32 peak) while the bytes it
// must move are 269 MB of complex STFT in and 21 MB of mel out (0.087 ms at
// 3.35 TB/s).  The mel bank is band-sparse, though: about 1/160 of W is
// non-zero, so the work the data needs is ~0.2 GFLOP and the function is
// bound by the bytes.  This kernel does the dense product, so in practice
// it is bound by the fp32 FMA rate and shared-memory reads; walking each
// filter's band (as the fused featurizer does) is the next step.
//
// What the design does.  A block computes a 64-row x 160-mel output tile
// (all mels of the production bank, so each STFT element is read from
// device memory once), 256 threads, each 8 rows x 5 mels in registers.  The
// K loop walks 16 frequency bins at a time: the block stages the power of a
// 64 x 16 STFT tile (k-major, padded against bank conflicts) and the 16 x
// 160 weight tile in shared memory, then every thread does 8 x 5 FMAs per
// bin.  Plain fp32 FMA on CUDA cores: no TF32 and no tensor cores, because
// the JAX kernel runs at Precision.HIGHEST.  No cp.async/TMA pipelining yet.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output rows ((batch, frame) pairs) per block
constexpr int BN = 160;       // mels per block
constexpr int BK = 16;        // frequency bins per K step
constexpr int THREADS = 256;  // 8 warps
constexpr int TM = BM / (THREADS / 32);  // 8 rows per thread
constexpr int TN = BN / 32;              // 5 mels per thread
constexpr int AS_STRIDE = BM + 4;        // keeps float4 rows aligned

static_assert(TM == 8 && TN * 32 == BN, "thread tile layout");

// grid (ceil(rows / BM), ceil(n_mels / BN)), THREADS threads.
// The STFT element (r, f) is re[(r * n_freq + f) * stride] and
// im[(r * n_freq + f) * stride]: stride 2 with im = re + 1 reads an
// interleaved complex64 tensor, stride 1 two separate float tensors.
__global__ void __launch_bounds__(THREADS)
power_mel_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 int stride, int rows, int n_freq,
                 const float* __restrict__ w, int n_mels,
                 float* __restrict__ out) {
  __shared__ __align__(16) float a_s[BK][AS_STRIDE];
  __shared__ float b_s[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 31;   // mel lane: mels tx + 32 j
  const int ty = tid >> 5;   // row group: rows ty * TM + i
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_freq; k0 += BK) {
    // 1. power of the 64 x 16 STFT tile; neighbouring threads read
    //    neighbouring bins of one row; zeros past the ragged edges
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK;
      const int k = i - r * BK;
      const int gr = row0 + r;
      const int gk = k0 + k;
      float p = 0.f;
      if (gr < rows && gk < n_freq) {
        const size_t e = (static_cast<size_t>(gr) * n_freq + gk) * stride;
        const float x = re[e];
        const float y = im[e];
        p = x * x + y * y;
      }
      a_s[k][r] = p;
    }
    // 2. the 16 x 160 weight tile, coalesced along mels
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN;
      const int n = i - k * BN;
      const int gk = k0 + k;
      const int gn = col0 + n;
      b_s[k][n] = (gk < n_freq && gn < n_mels)
                      ? w[static_cast<size_t>(gk) * n_mels + gn] : 0.f;
    }
    __syncthreads();

    // 3. 8 x 5 outer products per bin; the warp's A reads are broadcasts
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[k][ty * TM + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 4. store; a warp writes 32 consecutive mels of one row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= rows) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + 32 * j;
      if (gn < n_mels) out[static_cast<size_t>(gr) * n_mels + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int pm_power_mel(const float* re, const float* im, int stride, int rows,
                 int n_freq, const float* w, int n_mels, float* out,
                 void* stream) {
  const dim3 grid((rows + BM - 1) / BM, (n_mels + BN - 1) / BN);
  power_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, stride, rows, n_freq, w, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
