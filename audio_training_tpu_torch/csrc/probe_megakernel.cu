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
// So the operations bound it.  "store" and "brot" also write every d_i
// (537 MB a launch at the first shape) into a scratch that L2 holds.
//
// Design.  Every product runs on the tensor cores as wgmma m64n64k16 (bf16
// in, f32 accumulators in registers), none deduplicated although the dots
// with equal i % 4 are equal: a launch issues ndots grid (m/64) (n/64)
// (k/16) wgmma instructions.  A work unit is (step g, j = i % 4, a 64 x 64
// output tile, a run of the dots i = j (mod 4)).  Its A rows and B columns,
// k-complete ((64 + 64) k bf16: 160 KB at k = 640, 192 KB at 768), are copied
// into shared memory once by 1-D bulk copies completing on one mbarrier,
// and every dot of the unit reads them there; so does the next unit when
// it has the same operands (the operands do not depend on g).  The TPU kept
// both operands in VMEM for the whole launch; shared memory holds one tile
// pair.  The wrapper packs a and b, once a launch, into the order of the
// no-swizzle wgmma descriptor: a tile is 64 rows x k, its 8 x 8 core
// matrices (8 rows of 16 bytes, 128 contiguous bytes) at byte (k/8 index x
// 8 + row/8 index) x 128, so core matrices adjacent along k lie DOT_LBO =
// 1024 bytes apart and along m (n) DOT_SBO = 128 bytes; one k16 step is
// 2048 bytes, and each tile is one contiguous copy.  Both tiles are k-major
// (B is packed transposed, rows n).  No thread writes shared memory that
// wgmma reads (the bulk copies do), so no fence.proxy.async is needed.
// Above k = DOT_KC = 896 the pair does not fit (227 KB a block): there
// dot_probe_kernel<true> walks each dot's k in phases of up to 896, each a
// contiguous run of both packed tiles copied in turn into the same place
// and summed into the same accumulators, so the operands are read again
// for every dot.  No shape of the probe's list takes it; ptxas serializes
// its wgmma instructions (remark C7520: a warpgroup without a dot skips
// them on a divergent path).
//
// The host plans the walk (probes/probe_megakernel.py::dot_plan): the
// ndots grid tiles dot-tiles in the order (j, tile, g, i) are cut into one
// contiguous run per block, one block per SM (persistent), the runs equal
// to within one dot; a run is cut into units where (j, tile, g) changes.
// A block has two warpgroups that take the unit's dots in turn (dot s of
// the unit to warpgroup s % 2), so one warpgroup's epilogue overlaps the
// other's products (above k = 896 both wait at every phase's fill).  Each
// dot: wgmma.fence, k/16 wgmma into 32 registers a thread, commit, wait.  In "store" and "brot" each d_i then goes to its
// slot of a global scratch (g, 8, m, n) as 8-byte stores that fill whole
// 32-byte sectors (the accumulator fragment holds column pairs); in
// "accum" each warpgroup sums its dots of the unit in registers in
// ascending i and adds the sum to the output (rows < 8, columns < 128) or
// to a global scratch (g, m, n) with atomics, so the units' partial sums
// meet in an order that varies from run to run.  The wrapper zero-fills
// both in "accum".
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

#include "hopper_ptx.cuh"

namespace {

constexpr int DOT_TILE = 64;        // rows of an A tile, of a B tile (n)
constexpr int DOT_WG = 128;         // threads of a warpgroup
constexpr int DOT_WGS = 2;          // warpgroups a block
constexpr int DOT_THREADS = DOT_WG * DOT_WGS;
constexpr int DOT_KC = 896;         // most k a fill holds: 2 x 64 x 896 bf16
constexpr uint32_t DOT_LBO = 1024;  // bytes between core matrices along k
constexpr uint32_t DOT_SBO = 128;   // bytes between core matrices along m, n
constexpr uint32_t DOT_K16 = 2 * DOT_LBO;  // bytes of one k16 step of a tile
constexpr int UNIT_INTS = 5;        // (g, j, tile, first dot i, dots)
constexpr int OUT_ROWS = 8;         // the (8, 128) output block of a step
constexpr int OUT_COLS = 128;

enum DotMode { DOT_STORE = 0, DOT_ACCUM = 1, DOT_BROT = 2 };
enum ShiftMode { SHIFT1 = 0, ROLL = 1, POOL3 = 2, COPYBLK = 3 };

// the wgmma shared-memory descriptor of a no-swizzle k-major tile at smem
// address `addr`: the address, DOT_LBO and DOT_SBO in 16-byte units (bits
// 0-13, 16-29, 32-45); base offset 0 and layout type 0 (no swizzle, bits
// 62-63)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(DOT_LBO >> 4) << 16) |
         (static_cast<uint64_t>(DOT_SBO >> 4) << 32);
}

// d (+)= A(64 x 16) B(16 x 64), both from shared memory, k-major (no
// transpose); d is zeroed first unless `accumulate`.  Element r of d sits at
// row 16 (warp % 4) + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) +
// 2 (lane % 4) + r % 2.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving reads or writes of d across a wgmma fence
// or wait
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// one dot's products over k16 k steps of the tiles at a_s, b_s: d = A B,
// or d += A B when `accumulate`
__device__ __forceinline__ void dot_phase(float (&d)[32], uint32_t a_s,
                                          uint32_t b_s, int k16,
                                          bool accumulate) {
  fence_operands(d);
  wgmma_fence();
  for (int ks = 0; ks < k16; ++ks)
    wgmma_64x64(d, wgmma_desc(a_s + ks * DOT_K16),
                wgmma_desc(b_s + ks * DOT_K16), accumulate || ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(d);
}

// grid (blocks), DOT_THREADS threads, (2 x 64 min(k, DOT_KC)) bf16 + one
// mbarrier of dynamic shared memory.  plan: blocks + 1 offsets into the
// unit list, then UNIT_INTS ints a unit; block b walks units plan[b] ..
// plan[b + 1].  ap: a packed, (4, m / 64) tiles of 64 k bf16; bp: b packed,
// ((4,) n / 64) tiles of 64 k bf16 (the B tile of columns 64 t .. 64 t +
// 63).  kPhased: k > DOT_KC, walked in phases (a separate instantiation,
// so that the k-complete walk's code is not shaped by the phases').
template <bool kPhased>
__global__ void __launch_bounds__(DOT_THREADS, 1)
dot_probe_kernel(float salt, const __nv_bfloat16* __restrict__ ap,
                 const __nv_bfloat16* __restrict__ bp, int m, int k, int n,
                 int ndots, int mode, const int* __restrict__ plan,
                 float* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_dot[];
  const int kc = kPhased ? DOT_KC : k;  // k of a phase
  const int phases = (k + kc - 1) / kc;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_dot);
  __nv_bfloat16* bs = as + DOT_TILE * kc;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + DOT_TILE * kc);

  const int tid = threadIdx.x;
  const int wg = tid / DOT_WG;
  const int warp = (tid % DOT_WG) >> 5;  // of the warpgroup
  const int lane = tid & 31;
  const int row0 = 16 * warp + (lane >> 2);  // fragment rows row0, row0 + 8
  const int col0 = 2 * (lane & 3);           // columns col0 + 8 q, + 1
  const int tiles_m = m / DOT_TILE;
  const int tiles_n = n / DOT_TILE;
  const int i_out = ((ndots - 1) / 8) * 8;  // the dot left in slot 0
  const size_t tile_elems = static_cast<size_t>(DOT_TILE) * k;
  const uint32_t a_s = smem_u32(as);
  const uint32_t b_s = smem_u32(bs);

  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int* units = plan + gridDim.x + 1;
  float d[32] = {};    // the dot's accumulators (zeroed by its first wgmma)
  int loaded = -1;     // the operand pair in shared memory (k-complete)
  int loads = 0;       // bulk fills so far
  bool waited = true;  // this thread has seen the last fill complete
  for (int u = plan[blockIdx.x]; u < plan[blockIdx.x + 1]; ++u) {
    const int* unit = units + UNIT_INTS * u;
    const int step = unit[0], j = unit[1], tile = unit[2];
    const int i_first = unit[3], count = unit[4];
    const int tm = tile / tiles_n, tn = tile % tiles_n;
    const int aj = mode == DOT_BROT ? 0 : j;
    const int bj = mode == DOT_BROT ? j : 0;
    const int pair = (aj * tiles_m + tm) * 4 * tiles_n + bj * tiles_n + tn;

    // fill phase h of the unit's tiles (all threads; after every product
    // reading the old tiles has completed)
    auto fill = [&](int h) {
      __syncthreads();
      if (tid == 0) {
        const uint32_t bytes =
            DOT_TILE * min(kc, k - h * kc) * sizeof(__nv_bfloat16);
        const size_t at = static_cast<size_t>(h) * kc * DOT_TILE;
        mbar_expect_tx(full, 2 * bytes);
        bulk_copy(as, ap + (aj * tiles_m + tm) * tile_elems + at, bytes, full);
        bulk_copy(bs, bp + (bj * tiles_n + tn) * tile_elems + at, bytes, full);
      }
      ++loads;
      waited = false;
    };
    auto wait_fill = [&]() {
      if (!waited) {
        mbar_wait(full, (loads - 1) & 1);
        waited = true;
      }
    };

    // rows < 8 are row0 of warp 0, columns < 128 in the first two tiles
    const bool keep_out = tm == 0 && warp == 0 && tn * DOT_TILE < OUT_COLS;
    float total[32];
    const float init =
        (mode == DOT_ACCUM && i_first == 0 && wg == 0) ? salt * 1e-30f : 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) total[r] = init;
    // d_i done: summed in "accum", else to its slot, per q rows row0 and
    // row0 + 8, 8 bytes a thread
    auto finish = [&](int s) {
      const int i = i_first + 4 * s;
      if (mode == DOT_ACCUM) {
#pragma unroll
        for (int r = 0; r < 32; ++r) total[r] = __fadd_rn(total[r], d[r]);
        return;
      }
      float* slot = scratch +
                    (static_cast<size_t>(step) * 8 + i % 8) * m * n +
                    static_cast<size_t>(tm) * DOT_TILE * n + tn * DOT_TILE;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = 8 * q + col0;
        *reinterpret_cast<float2*>(slot + static_cast<size_t>(row0) * n + c) =
            make_float2(d[4 * q], d[4 * q + 1]);
        *reinterpret_cast<float2*>(slot + static_cast<size_t>(row0 + 8) * n +
                                   c) = make_float2(d[4 * q + 2], d[4 * q + 3]);
      }
      if (i == i_out && keep_out) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          *reinterpret_cast<float2*>(
              out + (static_cast<size_t>(step) * OUT_ROWS + row0) * OUT_COLS +
              tn * DOT_TILE + 8 * q + col0) =
              make_float2(d[4 * q], d[4 * q + 1]);
      }
    };

    if (!kPhased) {
      // dot s of the unit to warpgroup s % 2, each at its own pace
      if (pair != loaded) {
        fill(0);
        loaded = pair;
      }
      for (int s = wg; s < count; s += DOT_WGS) {
        wait_fill();
        dot_phase(d, a_s, b_s, k / 16, false);
        finish(s);
      }
    } else {
      // both warpgroups walk the same loops and meet at every phase's fill
      for (int s0 = 0; s0 < count; s0 += DOT_WGS) {
        const int s = s0 + wg;
        for (int h = 0; h < phases; ++h) {
          fill(h);
          if (s >= count) continue;
          wait_fill();
          dot_phase(d, a_s, b_s, min(kc, k - h * kc) / 16, h > 0);
        }
        if (s < count) finish(s);
      }
    }
    if (mode != DOT_ACCUM || wg >= count) continue;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int row = tm * DOT_TILE + row0 + 8 * ((r >> 1) & 1);
      const int col = tn * DOT_TILE + 8 * (r >> 2) + col0 + (r & 1);
      float* dst =
          (row < OUT_ROWS && col < OUT_COLS)
              ? out + (static_cast<size_t>(step) * OUT_ROWS + row) * OUT_COLS +
                    col
              : scratch + (static_cast<size_t>(step) * m + row) * n + col;
      atomicAdd(dst, total[r]);
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

// ap, bp: a (4, m, k) and b ((4,) k, n) bf16 packed as dot_probe_kernel
// reads them; m, n and k multiples of 64, n >= 128; plan: the walk of
// `blocks` blocks; scratch: (steps, 8, m, n) f32, or (steps, m, n) f32
// zero-filled in "accum"; out: (8 steps, 128) f32, zero-filled in "accum".
int probe_dot(float salt, const void* ap, const void* bp, int m, int k, int n,
              int ndots, int blocks, const int* plan, int mode,
              float* scratch, float* out, void* stream) {
  const bool phased = k > DOT_KC;
  const int kc = phased ? DOT_KC : k;
  const int smem = 2 * DOT_TILE * kc * static_cast<int>(sizeof(__nv_bfloat16)) +
                   static_cast<int>(sizeof(uint64_t));
  const auto kernel =
      phased ? dot_probe_kernel<true> : dot_probe_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, DOT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      salt, static_cast<const __nv_bfloat16*>(ap),
      static_cast<const __nv_bfloat16*>(bp), m, k, n, ndots, mode, plan,
      scratch, out);
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
