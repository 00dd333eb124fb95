// Kernel K2 of the port: GF(2^8) Leopard Reed-Solomon extension of lines
// of shares, as an int8 tensor-core product on Hopper (sm_90a).
//
// Replaces the TPU kernel celestia_app_tpu/ops/rs_pallas.py:
// _extend_pass_kernel (pallas_call at :59), and computes what it computes,
// byte for byte: for each line (a row or a column of the square) the k
// data shards of 512 bytes become k parity shards, byte column by byte
// column. The k bytes of column s, unpacked LSB-first (bit 8 * shard + b),
// form a GF(2) vector v of 8k bits; the parity bits are A v mod 2 with
// A = leopard.bit_matrix(k), 8k x 8k.
//
// GEMM view. For a launch over L lines, C^T (L*512 x 8k) = X^T (L*512 x 8k)
// * A^T, in u8 x u8 -> s32 on the tensor cores (wgmma m64n128k32
// .s32.u8.u8). X^T holds one byte column per row, its 8k bits along K; the
// operands are 0/1 and a sum is at most 8k = 1,024, so the product is
// exact. Output bit p of a byte column is C[p] & 1, and bits 8i..8i+7 give
// parity byte i.
//
// Bound: operations. One pass at k = 128 is (8k)^2 * k * 512 = 68.7 G
// multiply-adds against the int8 tensor-core rate; its bytes (8 MB in,
// 8 MB out, the 1 MiB operand) take a fifth of that time at the memory rate.
//
// Design.
// - Why X is the register operand. Unpacked to one byte per bit, X is 8x
//   its packed size. Written to shared memory for wgmma to read, its
//   stores compete with the tensor cores' own shared-memory reads, and a
//   first version built that way ran no faster than the fp16 library
//   product (PERF.md). Here each thread expands the packed bytes straight
//   into its A fragment registers, so the bits never touch memory unpacked.
// - The bit matrix is the shared-memory operand B: built once per
//   (k, device) by ops/rs.py, u8 0/1, rows and K zero-padded to
//   kpad = max(128, 8k), row-major, which is wgmma's K-major B. A block
//   owns 128 output bits (16 parity shards) and keeps their 128 x kpad
//   rows resident in shared memory (128 KiB at k = 128), in 8-row x
//   16-byte core matrices without swizzle, loaded once with cp.async. It
//   walks over N tiles of 256 byte columns (half a share of one line), so
//   the matrix is read from L2 once per block and only X streams. The
//   grid is (tile groups, output-bit tiles), about one block per SM.
// - Raw X ring. Each K step of X (16 data shards x 256 bytes, zeros past
//   k) is copied into one of 6 raw stages with 16-byte cp.async, 4 steps
//   ahead of its use: 256 threads copy a chunk each, and every thread
//   signals the stage's "full" mbarrier through cp.async.mbarrier.arrive;
//   each warp frees a stage on its "empty" mbarrier once it has read its
//   bytes out of it. Rows of a raw stage are 272 bytes apart, so the byte reads
//   below hit distinct banks. There is no separate loader warp: 512
//   threads leave each 128 registers, and a 17th warp would cut that to
//   96, where the compiler spills and serialises the products.
// - Four warpgroups, 64 byte columns each. Per K step a thread
//   reads 16 packed bytes (its 2 columns x 8 shards), turns the nibble it
//   owns of each into 4 bytes of 0/1 with one multiply, and issues four
//   m64n128k32 products with those registers as A. Its 64 s32
//   accumulators hold 2 columns x 16 shards x 2 bits. Two fragment buffers
//   let a thread read the next step's bytes while this step's products
//   run, and the four warpgroups take turns on the tensor cores.
// - Epilogue in the kernel. In the accumulator layout the 8 bits of one
//   output byte sit in the 4 lanes of a quad (2 bits each, registers r and
//   r + 1). Each thread packs its bit pairs of 4 shards into a word, two
//   shfl_xor within the quad complete the bytes, and lane c of the quad
//   stores shards 4c..4c+3 of its 2 columns.
// - Strided lines, written in place. A launch takes one or two line
//   groups, each a source and a destination base with its own line and
//   shard strides (the 512 bytes of a share stay contiguous). ops/rs.py
//   extends a square in two launches straight into the extended square:
//   rows and columns of Q0 into Q1 and Q2, then rows of Q2 into Q3.
// - One kernel for every k in {1, 2, 4, ..., 128}: small squares pad the
//   output bits and K with zero rows and columns of the matrix and are
//   masked at the load and the store.

#include <cstdint>
#include <cuda_runtime.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int kBits = 128;      // output bits per block: 16 parity shards
constexpr int kCols = 256;      // byte columns per N tile: half a share
constexpr int kBK = 128;        // K per step: 16 data shards of 8 bits
constexpr int kWarpgroups = 4;  // 64 byte columns each
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRaw = 6;         // raw X stages
constexpr int kAhead = 4;       // steps a stage is filled ahead of its use
constexpr int kRawPitch = kCols + 16;            // bytes between shard rows of a stage
constexpr int kRawTile = 16 * kRawPitch;
constexpr int kMaxK = 128;
constexpr int kMaxGroups = 2;
constexpr int kBarBytes = 8 * 2 * kRaw;
constexpr int kMaxSmem = kBits * 8 * kMaxK + kRaw * kRawTile + kBarBytes;

static_assert(kMaxSmem <= 232448, "shared memory over the 227 KiB a block may use");

struct LineGroup {
  const uint8_t* src;
  uint8_t* dst;
  long long src_line, src_shard, dst_line, dst_shard;  // byte strides
  int lines;
};

struct Params {
  LineGroup g[kMaxGroups];
  const uint8_t* operand;  // (kpad, kpad) u8 0/1, row-major
  int k;
  int kpad;
  int tiles;  // N tiles over both groups, 2 per line
};

struct Tile {
  const uint8_t* src;  // byte column 0 of the tile, data shard 0
  uint8_t* dst;        // byte column 0 of the tile, parity shard 0
  long long src_shard, dst_shard;
};

__device__ __forceinline__ Tile locate(const Params& p, int t) {
  const bool second = t >= 2 * p.g[0].lines;
  if (second) t -= 2 * p.g[0].lines;
  const int line = t >> 1;
  const int col = (t & 1) * kCols;
  Tile r;
  r.src_shard = second ? p.g[1].src_shard : p.g[0].src_shard;
  r.dst_shard = second ? p.g[1].dst_shard : p.g[0].dst_shard;
  r.src = (second ? p.g[1].src : p.g[0].src) + line * (second ? p.g[1].src_line : p.g[0].src_line) + col;
  r.dst = (second ? p.g[1].dst : p.g[0].dst) + line * (second ? p.g[1].dst_line : p.g[0].dst_line) + col;
  return r;
}

// Thread tid's part of filling raw stage `stage` with K step s: the copy
// of data shards 16j..16j+15 (zeros past k) x 256 bytes of the step's N
// tile is 256 16-byte cp.async, one for each of threads 0..255. Every
// thread then arrives on the stage's "full" barrier once its copies land.
__device__ __forceinline__ void fill_stage(const Params& p, int tile, int j, int tid, uint8_t* raw,
                                           uint32_t full) {
  if (tid < 256) {
    const Tile tl = locate(p, tile);
    const int shard = tid >> 4, col = (tid & 15) * 16;
    const bool valid = 16 * j + shard < p.k;
    const uint8_t* src = tl.src + col + (valid ? static_cast<long long>(16 * j + shard) * tl.src_shard : 0);
    sm90::cp_async16_zfill(sm90::smem_addr(raw + shard * kRawPitch + col), src, valid);
  }
  sm90::cp_async_arrive_noinc(full);
}

// Low 4 bits of x -> 4 bytes of 0/1, bit b in byte b.
__device__ __forceinline__ uint32_t spread4(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// The two bits of one output byte that a thread holds, in bits 0 and 1.
__device__ __forceinline__ uint32_t bit_pair(uint32_t lo, uint32_t hi) {
  return (lo & 1u) | ((hi & 1u) << 1);
}

__global__ void __launch_bounds__(kThreads, 1) rs_extend_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* b_s = smem;                     // 128 x kpad matrix rows, core-matrix layout
  uint8_t* raw_s = smem + kBits * p.kpad;  // kRaw x (16 x kRawPitch)
  const uint32_t full0 = sm90::smem_addr(raw_s + kRaw * kRawTile);  // kRaw mbarriers
  const uint32_t empty0 = full0 + 8 * kRaw;                         // kRaw mbarriers
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int ntile = blockIdx.y;
  const int ksteps = p.kpad / kBK;
  const int b_sbo = 8 * p.kpad;  // bytes between 8-row groups of the matrix
  // N tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the host makes
  // gridDim.x <= tiles, so every block has at least one.
  const int my_tiles = (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int steps = my_tiles * ksteps;
  auto tile_of = [&](int s) { return blockIdx.x + (s / ksteps) * gridDim.x; };

  // The block's 128 rows of the matrix, resident for the whole launch.
  const int chunks = p.kpad / 16;
  const uint8_t* b_g = p.operand + static_cast<size_t>(ntile) * kBits * p.kpad;
  for (int idx = tid; idx < kBits * chunks; idx += kThreads) {
    const int n = idx / chunks, c = idx % chunks;
    sm90::cp_async16(sm90::smem_addr(b_s + (n >> 3) * b_sbo + c * 128 + (n & 7) * 16),
                     b_g + static_cast<size_t>(n) * p.kpad + c * 16);
  }
  sm90::cp_async_commit();
  if (tid == 0) {
    for (int i = 0; i < kRaw; ++i) {
      sm90::mbar_init(full0 + 8 * i, kThreads);
      sm90::mbar_init(empty0 + 8 * i, kThreads / 32);
    }
    sm90::mbar_init_fence();
  }
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  for (int s = 0; s < kAhead && s < steps; ++s)
    fill_stage(p, tile_of(s), s % ksteps, tid, raw_s + s * kRawTile, full0 + 8 * s);

  // Warpgroup wg: byte columns 64wg..64wg+63 of the tile. This
  // thread's A rows are columns col and col + 8; its K bytes 4c..4c+3
  // (and 16 more) of each 32-bit slice are nibble c % 2 of data shards
  // 4 * slice + c / 2 (and + 2).
  const int c = lane & 3;
  const int col = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int nib = 4 * (c & 1);
  const uint8_t* my_raw = raw_s + (c >> 1) * kRawPitch + col;
  const uint32_t b_base = sm90::smem_addr(b_s);
  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0u;

  // Step s, first half: start the fill of the raw stage kAhead steps on,
  // wait for step s's stage and read this thread's A fragments from it.
  auto prepare = [&](int s, uint32_t (&a)[16]) {
    const int ahead = s + kAhead;
    if (ahead < steps) {
      // The stage of step `ahead` was last read by step ahead - kRaw: wait
      // until every warp has freed it (its first use passes at once).
      const int st = ahead % kRaw;
      sm90::mbar_wait(empty0 + 8 * st, ((ahead / kRaw) & 1) ^ 1);
      fill_stage(p, tile_of(ahead), ahead % ksteps, tid, raw_s + st * kRawTile, full0 + 8 * st);
    }
    const int stage = s % kRaw;
    sm90::mbar_wait(full0 + 8 * stage, (s / kRaw) & 1);
    const uint8_t* raw = my_raw + stage * kRawTile;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const uint8_t* lo = raw + 4 * sl * kRawPitch;  // shard 4 * sl + c / 2
      const uint8_t* hi = lo + 2 * kRawPitch;        // shard 4 * sl + 2 + c / 2
      a[4 * sl + 0] = spread4((lo[0] >> nib) & 15u);
      a[4 * sl + 1] = spread4((lo[8] >> nib) & 15u);
      a[4 * sl + 2] = spread4((hi[0] >> nib) & 15u);
      a[4 * sl + 3] = spread4((hi[8] >> nib) & 15u);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * stage);
  };

  // Step s, second half: the four products, issued without waiting.
  auto issue = [&](int s, const uint32_t (&a)[16]) {
    const int j = s % ksteps;
    sm90::wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const uint64_t db = sm90::smem_desc(b_base + (8 * j + 2 * sl) * 128, 128, b_sbo);
      sm90::wgmma_m64n128k32_u8_rs(acc, a[4 * sl], a[4 * sl + 1], a[4 * sl + 2], a[4 * sl + 3], db,
                                   (j | sl) != 0);
    }
    sm90::wgmma_commit();
  };

  // After the products of step s: at the end of a tile, the epilogue.
  // acc[4i + 2h + b] holds bit 2c + b of the block's parity shard i at
  // column col + 8h.
  auto finish = [&](int s) {
    sm90::wgmma_wait<0>();
    if (s % ksteps != ksteps - 1) return;
    const Tile tl = locate(p, tile_of(s));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t mine = 0u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t w = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * (4 * g + q) + 2 * h;
          w |= bit_pair(acc[r], acc[r + 1]) << (8 * q);
        }
        w <<= 2 * c;
        w |= __shfl_xor_sync(0xffffffffu, w, 1);
        w |= __shfl_xor_sync(0xffffffffu, w, 2);
        if (g == c) mine = w;  // parity shards 4c..4c+3
      }
      uint8_t* out = tl.dst + col + 8 * h;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int shard = kBits / 8 * ntile + 4 * c + q;
        if (shard < p.k) out[shard * tl.dst_shard] = static_cast<uint8_t>(mine >> (8 * q));
      }
    }
  };

  // Two fragment buffers: the next step's fragments are read while this
  // step's products run.
  uint32_t a0[16], a1[16];
  prepare(0, a0);
  for (int s = 0; s < steps; s += 2) {
    issue(s, a0);
    if (s + 1 < steps) prepare(s + 1, a1);
    finish(s);
    if (s + 1 == steps) break;
    issue(s + 1, a1);
    if (s + 2 < steps) prepare(s + 2, a0);
    finish(s + 1);
  }
}

int device_sms(int dev) {
  static int sms[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    if (cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
    if (cudaFuncSetAttribute(rs_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
        cudaSuccess) {
      sms[dev] = 0;
      return -1;
    }
  }
  return sms[dev];
}

}  // namespace

// groups: ngroups x 7 int64 {src, dst, src_line, src_shard, dst_line,
// dst_shard, lines}, strides in bytes, in host memory. operand: (kpad,
// kpad) u8 0/1 on the device, kpad = max(128, 8k). Launches on `stream`
// (of the current device) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int rs_extend_lines(const long long* groups, int ngroups, const void* operand, int k,
                               void* stream) {
  if (k < 1 || k > kMaxK || (k & (k - 1)) != 0 || ngroups < 1 || ngroups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.operand = static_cast<const uint8_t*>(operand);
  p.k = k;
  p.kpad = 8 * k > kBits ? 8 * k : kBits;
  for (int g = 0; g < ngroups; ++g) {
    const long long* d = groups + 7 * g;
    if (d[6] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.g[g] = LineGroup{reinterpret_cast<const uint8_t*>(d[0]), reinterpret_cast<uint8_t*>(d[1]),
                       d[2], d[3], d[4], d[5], static_cast<int>(d[6])};
    p.tiles += 2 * p.g[g].lines;
  }
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  const int sms = device_sms(dev);
  if (sms < 0) return static_cast<int>(cudaGetLastError());
  const int ntiles = p.kpad / kBits;
  int ngrid = sms / ntiles;
  if (ngrid < 1) ngrid = 1;
  if (ngrid > p.tiles) ngrid = p.tiles;
  const int smem = kBits * p.kpad + kRaw * kRawTile + kBarBytes;
  rs_extend_kernel<<<dim3(ngrid, ntiles), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
