// The megakernel probe's two kernels for Hopper (sm_90a).
//
// Replaces: docs/probes/probe_megakernel.py::dot_kernel (K3, launched by
// bench_dot) and ::shift_kernel (K4, launched by bench_shift).  The TPU probe
// measured the matrix unit's bf16 dot rate at the shapes of candidate conv2
// formulations, and the vector unit's cost of lane shifts, rolls, a stride-3
// max-pool compaction and block copies.  Each grid step of the TPU kernel
// computes the same thing (the inputs do not depend on the step), so the
// output block of every step is the same; the step count only scales the
// work.  This file computes the same outputs with the same work on the card.
//
// ---------------------------------------------------------------------------
// K3, dot_probe_kernel.  Per grid step g, ndots products d_i of shape (m, k)
// x (k, n), bf16 operands, f32 sums:
//   "store": d_i = a[i % 4] . b, stored to slot i % 8 of the step's scratch;
//   "brot":  d_i = a[0] . b[i % 4], stored to slot i % 8;
//   "accum": acc = salt * 1e-30 + sum_i a[i % 4] . b, in that order.
// out[8 g + r, c] = acc[0][r, c] for r < 8, c < min(n, 128): in "store" and
// "brot" the last d_i with i % 8 == 0, in "accum" the sum.
//
// What bounds it.  2 m k n ndots grid operations on the tensor cores: at the
// probe's first shape (64 x 640 x 512, 512 dots, 8 steps) 172 GFLOP, 0.174 ms
// at the 989 TFLOP/s dense bf16 peak; the operands are 1 MB and stay in L2.
// So the operations bound it.
//
// Design.  The products run on the tensor cores as mma.sync m16n8k16 bf16
// (the instruction of the featurizer's tensor-core tiers; wgmma, which alone
// reaches the card's peak, is later work), so the rate this kernel measures
// is the mma.sync rate with operands streamed from L2 through shared memory,
// not the card's wgmma peak.  The TPU held both operands in 100 MB of VMEM;
// here a is (4, m, k) bf16 (327 KB at 64 x 640) and b (k, n) (655 KB), so each
// block stages 64 x 64 chunks of A (rows m, k contiguous) and of B
// (transposed to rows n, k contiguous, so that both fragments are 32-bit
// shared loads) and walks k.  A block computes one 64 x 64 output tile
// (4 warps of 32 x 32, 8 mma per 16-deep k step) for a contiguous chunk of
// the dots, so one grid step's products spread over (m/64)(n/64)(chunks)
// blocks; the wrapper picks the chunk count to give the card about two
// blocks per SM.  Every product is kept live: in "store" and "brot" each
// d_i is written to its slot of a global scratch (g, 8, m, n), as the TPU
// kernel's acc[i % 8] = d; in "accum" each block sums its chunk's d_i in
// registers (acc += d after each dot, the TPU's order) and adds the sum to
// the output (rows < 8, columns < 128) or to a global scratch (g, m, n) with
// atomics, so the chunks' partial sums meet in an order that varies from
// run to run.  The wrapper zero-fills both in "accum".
//
// ---------------------------------------------------------------------------
// K4, shift_probe_kernel.  Per grid step, nops iterations i of y = x +
// ((i % 4) + salt) (f32), then
//   "shift1":  scr[:, :512] = y[:, 1:513]        (an unaligned lane shift)
//   "roll":    scr[:, j] = y[:, (j + 1) % lanes]  (a full roll by -1)
//   "pool3":   scr[:, :169] = max(y[:, 0:507:3], y[:, 1:508:3], y[:, 2:509:3])
//   "copyblk": scr[:192, :128] = y[:192, :128] + 1
// and out[8 g + r, c] = scr[r, c] for r < 8, c < 128, the last iteration's.
// Mosaic could not lower "pool3"; here it is one more strided read.
//
// What bounds it.  The input (m x lanes f32) is read once and the output is
// 4 KB a step, so the bytes take well under a microsecond; the f32 adds and
// maxima (nops x grid x the region's elements) bound it, at the card's 67
// TFLOP/s f32 peak.  In practice the shared-memory traffic bounds it.
//
// Design.  One block takes 8 rows of x for one grid step (grid (m/8,
// steps)), stages them in shared memory, and runs the nops iterations into a
// shared scratch of the same shape.  Both are read and written through
// volatile pointers, so every iteration re-reads x and stores its whole
// region, as the TPU kernel's loop does (no store of an overwritten
// iteration may be dropped, no load hoisted).  Every value is one IEEE f32
// add or max of the same operands as the plain version: the outputs agree
// bitwise.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on the
// stream it is given and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DOT_TILE = 64;          // output rows and columns per block
constexpr int DOT_KC = 64;            // k per staged chunk
constexpr int DOT_THREADS = 128;      // 4 warps, 2 x 2 sub-tiles of 32 x 32
constexpr int DOT_LD = DOT_KC + 8;    // bf16 per shared row (144 bytes)
constexpr int OUT_ROWS = 8;           // the (8, 128) output block of a step
constexpr int OUT_COLS = 128;

enum DotMode { DOT_STORE = 0, DOT_ACCUM = 1, DOT_BROT = 2 };
enum ShiftMode { SHIFT1 = 0, ROLL = 1, POOL3 = 2, COPYBLK = 3 };

// D = A(16x16, row) B(16x8, col) + D, bf16 operands, f32 accumulators (the
// PTX fragment layout of mma.sync.m16n8k16, as in fused_featurizer.cu).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid ((m/64) (n/64), chunks, steps), DOT_THREADS threads.
__global__ void __launch_bounds__(DOT_THREADS)
dot_probe_kernel(float salt, const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b, int m, int k, int n,
                 int ndots, int dots_per_chunk, int mode,
                 float* __restrict__ scratch, float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 as[DOT_TILE][DOT_LD];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 bs[DOT_TILE][DOT_LD];  // [n][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles_n = n / DOT_TILE;
  const int row0 = (blockIdx.x / tiles_n) * DOT_TILE + (warp >> 1) * 32;
  const int col0 = (blockIdx.x % tiles_n) * DOT_TILE + (warp & 1) * 32;
  const int tile_r = (blockIdx.x / tiles_n) * DOT_TILE;
  const int tile_c = (blockIdx.x % tiles_n) * DOT_TILE;
  const int chunk = blockIdx.y;
  const int step = blockIdx.z;
  const int i_begin = chunk * dots_per_chunk;
  const int i_end = min(ndots, i_begin + dots_per_chunk);
  const int i_out = ((ndots - 1) / 8) * 8;  // the dot left in slot 0
  const int out_cols = min(n, OUT_COLS);

  // fragment element c of sub-tile (mi, ni) sits at row row0 + 16 mi + g +
  // 8 (c >> 1), column col0 + 8 ni + 2 t + (c & 1)
  float total[2][4][4];
  const float init = (mode == DOT_ACCUM && chunk == 0) ? salt * 1e-30f : 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) total[mi][ni][c] = init;

  for (int i = i_begin; i < i_end; ++i) {
    const __nv_bfloat16* A =
        a + static_cast<size_t>(mode == DOT_BROT ? 0 : i % 4) * m * k +
        static_cast<size_t>(tile_r) * k;
    const __nv_bfloat16* B =
        b + static_cast<size_t>(mode == DOT_BROT ? i % 4 : 0) * k * n + tile_c;
    float d[2][4][4] = {};
    for (int kc = 0; kc < k; kc += DOT_KC) {
      __syncthreads();  // the previous chunk's fragment loads are done
      // A: 64 rows x 64 k, eight bf16 a thread-load
      for (int v = tid; v < DOT_TILE * DOT_KC / 8; v += DOT_THREADS) {
        const int r = v / (DOT_KC / 8);
        const int c8 = (v % (DOT_KC / 8)) * 8;
        *reinterpret_cast<uint4*>(&as[r][c8]) = __ldg(
            reinterpret_cast<const uint4*>(A + static_cast<size_t>(r) * k + kc + c8));
      }
      // B: 64 k x 64 n, eight bf16 along n a thread-load, stored transposed
      for (int v = tid; v < DOT_KC * DOT_TILE / 8; v += DOT_THREADS) {
        const int kr = v / (DOT_TILE / 8);
        const int n8 = (v % (DOT_TILE / 8)) * 8;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            B + static_cast<size_t>(kc + kr) * n + n8));
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) bs[n8 + j][kr] = e[j];
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < DOT_KC / 16; ++ks) {
        const int kk = 16 * ks + 2 * t;
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = row0 - tile_r + 16 * mi + g;
          af[mi][0] = lds32(&as[r][kk]);
          af[mi][1] = lds32(&as[r + 8][kk]);
          af[mi][2] = lds32(&as[r][kk + 8]);
          af[mi][3] = lds32(&as[r + 8][kk + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = col0 - tile_c + 8 * ni + g;
          bf[ni][0] = lds32(&bs[c][kk]);
          bf[ni][1] = lds32(&bs[c][kk + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(d[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
    }
    // keep d_i: accumulate it ("accum") or store it to its slot (the
    // loops unroll, so that d and total stay in registers)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (mode == DOT_ACCUM) {
            total[mi][ni][c] = __fadd_rn(total[mi][ni][c], d[mi][ni][c]);
            continue;
          }
          const int r = row0 + 16 * mi + g + 8 * (c >> 1);
          const int col = col0 + 8 * ni + 2 * t + (c & 1);
          scratch[((static_cast<size_t>(step) * 8 + i % 8) * m + r) * n + col] =
              d[mi][ni][c];
          if (i == i_out && r < OUT_ROWS && col < out_cols)
            out[(static_cast<size_t>(step) * OUT_ROWS + r) * OUT_COLS + col] =
                d[mi][ni][c];
        }
      }
    }
  }
  if (mode != DOT_ACCUM || i_begin >= i_end) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row0 + 16 * mi + g + 8 * (c >> 1);
        const int col = col0 + 8 * ni + 2 * t + (c & 1);
        float* dst =
            (r < OUT_ROWS && col < out_cols)
                ? out + (static_cast<size_t>(step) * OUT_ROWS + r) * OUT_COLS + col
                : scratch + (static_cast<size_t>(step) * m + r) * n + col;
        atomicAdd(dst, total[mi][ni][c]);
      }
    }
  }
}

constexpr int SHIFT_ROWS = 8;        // rows of x per block
constexpr int SHIFT_THREADS = 256;
constexpr int SHIFT1_WIDTH = 512;    // scr[:, :512] = y[:, 1:513]
constexpr int POOL3_WIDTH = 169;     // 0:507:3
constexpr int COPY_ROWS = 192;       // scr[:192, :128]
constexpr int COPY_WIDTH = 128;

// grid (m / 8, steps), SHIFT_THREADS threads, 2 x 8 x lanes f32 of shared
// memory.
__global__ void __launch_bounds__(SHIFT_THREADS)
shift_probe_kernel(float salt, const float* __restrict__ x, int lanes,
                   int nops, int mode, float* __restrict__ out) {
  extern __shared__ float smem_shift[];
  volatile float* xs = smem_shift;                      // 8 rows of x
  volatile float* scr = smem_shift + SHIFT_ROWS * lanes;  // their scratch
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * SHIFT_ROWS;
  for (int e = tid; e < SHIFT_ROWS * lanes; e += SHIFT_THREADS)
    xs[e] = x[static_cast<size_t>(r0) * lanes + e];
  __syncthreads();

  const int rows =
      mode == COPYBLK ? max(0, min(SHIFT_ROWS, COPY_ROWS - r0)) : SHIFT_ROWS;
  const int width = mode == SHIFT1 ? SHIFT1_WIDTH
                    : mode == ROLL ? lanes
                    : mode == POOL3 ? POOL3_WIDTH
                                    : COPY_WIDTH;
  for (int i = 0; i < nops; ++i) {
    const float c = __fadd_rn(static_cast<float>(i % 4), salt);
    for (int r = 0; r < rows; ++r) {
      volatile float* xr = xs + r * lanes;
      volatile float* sr = scr + r * lanes;
      for (int j = tid; j < width; j += SHIFT_THREADS) {
        float v;
        if (mode == SHIFT1) {
          v = __fadd_rn(xr[j + 1], c);
        } else if (mode == ROLL) {
          v = __fadd_rn(xr[j + 1 == lanes ? 0 : j + 1], c);
        } else if (mode == POOL3) {
          v = fmaxf(fmaxf(__fadd_rn(xr[3 * j], c), __fadd_rn(xr[3 * j + 1], c)),
                    __fadd_rn(xr[3 * j + 2], c));
        } else {
          v = __fadd_rn(__fadd_rn(xr[j], c), 1.0f);
        }
        sr[j] = v;
      }
    }
  }
  __syncthreads();
  if (blockIdx.x != 0) return;
  for (int e = tid; e < OUT_ROWS * OUT_COLS; e += SHIFT_THREADS) {
    const int r = e / OUT_COLS;
    const int c = e % OUT_COLS;
    out[(static_cast<size_t>(blockIdx.y) * OUT_ROWS + r) * OUT_COLS + c] =
        scr[r * lanes + c];
  }
}

}  // namespace

extern "C" {

// a: (4, m, k) bf16; b: (k, n) bf16, or (4, k, n) in "brot"; m, n and k
// multiples of 64, n >= 128; scratch: (steps, 8, m, n) f32, or (steps, m, n)
// f32 zero-filled in "accum"; out: (8 steps, 128) f32, zero-filled in
// "accum".
int probe_dot(float salt, const void* a, const void* b, int m, int k, int n,
              int ndots, int steps, int chunks, int mode, float* scratch,
              float* out, void* stream) {
  const int dots_per_chunk = (ndots + chunks - 1) / chunks;
  const dim3 grid((m / DOT_TILE) * (n / DOT_TILE), chunks, steps);
  dot_probe_kernel<<<grid, DOT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      salt, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), m, k, n, ndots, dots_per_chunk,
      mode, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

// x: (m, lanes) f32, m a multiple of 8; out: (8 steps, 128) f32.
int probe_shift(float salt, const float* x, int m, int lanes, int nops,
                int steps, int mode, float* out, void* stream) {
  const size_t smem = sizeof(float) * 2 * SHIFT_ROWS * lanes;
  cudaError_t err = cudaFuncSetAttribute(
      shift_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / SHIFT_ROWS, steps);
  shift_probe_kernel<<<grid, SHIFT_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      salt, x, lanes, nops, mode, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
