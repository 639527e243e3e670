// Per-cluster float sums on Hopper (sm_90a):
//
//   out[j, f] = sum over { i : lab_i = j } of y[i, f]      (j < k, f < d)
//
// for y (n, d) row-major in f32 or bf16, accumulated in f32; labels < 0 or
// >= k add nothing.  Replaces the TPU kernel label_segment_matmul
// (cdrs_tpu/ops/pallas_kernels.py:534, _kernel_seg / _build_seg), which takes
// the same sums as a one-hot product on the MXU, tile by tile.
//
// Deterministic: no float atomics.  Every float add has a place fixed by
// the labels and the shape alone (ops/seg_sum.label_segment_sum_ordered
// makes the same adds in the same order in PyTorch), so the same inputs
// give the same bits on every launch and on every card.
//
// What bounds it on this card: y and the labels are read once and each
// element is added once, so its bound is the read of y.  The design puts
// the rows in cluster order first, so that every sum is a stream and no
// block holds a (k, d) table:
//
// 1. seg_sum_hist: one read of the labels (16-byte loads past 2^18 rows)
//    counts every 8-bit digit of the valid ones in shared memory (a warp
//    whose 32 labels share a digit adds once), then adds its counts into
//    one of 8 copies of the call's histograms (integer atomics), zeroes the
//    look-back words and resets the tile counters.
// 2. seg_sum_pass, once a digit (one pass for k <= 256, two for k <=
//    65,536, ...): a stable LSD counting sort of the valid labels and their
//    row ids, labels outside [0, k) dropped in the first pass.  A block
//    takes the next tile of 4096 keys (2048 up to 2^18 rows; an atomic
//    ticket, so every tile before it is running or done) and ranks them in
//    order: a warp 256 keys, 32 at a time, a key's rank among its lanes
//    from nine ballots (a peer mask, as __match_any_sync gives, without its
//    cost when the digits differ), the keys before it from a per-(warp,
//    digit) count.  It publishes its digit counts, puts its keys in digit
//    order in shared memory, takes each digit's offset in the sorted order
//    from the histogram and a decoupled look-back over the tiles before (16
//    tiles' 8-byte words read at once), and writes each digit's keys as one
//    run.  Integers only: every position is a
//    function of the labels.
// 3. seg_sum_rows / seg_sum_cols: the sorted order is cut into chunks of
//    `piece` positions (ops/seg_sum.plan); a piece is a cluster's run in a
//    chunk, so none holds more than `piece` rows.  A warp sums a chunk,
//    reading each row through its id, in one of two lane layouts fixed by d:
//    * rows (d < 32): a lane a position, 32 positions a step; each lane
//      keeps d running sums of the run still open.  A step whose 32 keys
//      all continue that run adds each lane's row into its sums.  Any
//      other step closes the open run (its lanes of the step added, then a
//      fixed shuffle tree), sums the runs that begin and end inside the
//      step by a segmented inclusive scan over the lanes (offsets 1, 2, 4,
//      8, 16), and opens the run at lane 31.
//    * cols (d >= 32): a row a step, lanes across features (V elements a
//      lane, one vector load: a warp reads a whole 128-feature f32 row a
//      load), a running sum a lane; 8 to 32 rows loaded before their adds;
//      column blocks of 32 V features where d is wider.
//    A run whose cluster lies inside the chunk writes its output row; the
//    run a chunk shares with the chunk before writes partial slot 0, the
//    one it shares with the chunk after slot 1, and the chunk records where
//    such a chain of pieces begins and ends.  Clusters with no row get a
//    zero row from the warp holding the position after their gap.  The
//    first block also zeroes the histograms for the next call.
// 4. seg_sum_fold: for each cluster that spans chunks, its head chunk's
//    slot 1 plus the slot 0 of each chunk after it, added in chunk order: a
//    warp a (chain, 32 features) up to 128 chunks, a block past that.
//
// So a call is passes + 3 launches.  A cluster that holds most rows is
// many chunks on many SMs, and only its fold grows (one partial a chunk).
// The sort adds about 16 bytes a row a pass of integer traffic.
// Offsets into y are 64-bit: n * d may pass 2^31 (n < 2^31, k * d < 2^31).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadix = 256;
constexpr int kMaxPasses = 4;
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
// Keys a thread: 8 (tiles of 4096), or 4 (tiles of 2048) up to kSmallN
// rows, where more tiles keep more SMs busy.
constexpr int kSortItems = 8;
constexpr int64_t kSmallN = (int64_t)1 << 18;
constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 4;
constexpr int kHistBlocksMax = 528;
constexpr int kHistCopies = 8;                        // histograms the blocks add into
constexpr int kSumWarps = 4;                          // chunks a block
constexpr int kLook = 16;                             // look-back words read at once
constexpr int kFoldWarps = 8;
constexpr int kFoldBlocksMax = 1056;
constexpr int kFoldLong = 128;                        // a longer chain is a block's
constexpr int kFoldRows = 128;                        // partials a block stages at once
constexpr int kFoldLongMax = 16;                      // long chains a block takes
constexpr int kRowsBelow = 32;                        // ops/seg_sum.ROWS_BELOW
// Look-back words: flags in the top two bits, a count below; 0 = not ready.
using Word = unsigned long long;
constexpr Word kAgg = 1ull << 62, kInc = kAgg << 1, kCount = kAgg - 1;
__device__ __forceinline__ Word vload(const Word* p) {
  return *(const volatile Word*)p;
}
__device__ __forceinline__ void vstore(Word* p, Word v) {
  *(volatile Word*)p = v;
}

// Keys a sort tile, sort tiles, and chunks of `piece` positions, for n rows.
inline int64_t sort_tile(int64_t n) {
  return (int64_t)kSortThreads * (n <= kSmallN ? kSortItems / 2 : kSortItems);
}
inline int64_t tiles_of(int64_t n) { return n > 0 ? (n + sort_tile(n) - 1) / sort_tile(n) : 1; }
inline int64_t chunks_of(int64_t n, int piece) { return n > 0 ? (n + piece - 1) / piece : 1; }

// Where each part of a call's scratch lies, in bytes from its start (each
// part 256-byte aligned): the counters (kHistCopies copies of the passes'
// histograms, a tile counter a pass, the valid rows), zero before the
// first call (each call leaves its histograms zero); the look-back words,
// passes * tiles * 256; the sort's keys and ids twice, n ints each; a
// chain head a chunk; two partial rows of d floats a chunk.
struct Layout {
  int64_t status, keys, keys_stride, heads, part, bytes;
};
inline Layout layout_of(int64_t n, int d, int piece, int passes) {
  auto up = [](int64_t b) { return (b + 255) / 256 * 256; };
  const int64_t chunks = chunks_of(n, piece);
  Layout l;
  l.status = up(((int64_t)passes * (kHistCopies * kRadix + 1) + 1) * 4);
  l.keys = l.status + up((int64_t)passes * tiles_of(n) * kRadix * (int64_t)sizeof(Word));
  l.keys_stride = up(n * 4);
  l.heads = l.keys + 4 * l.keys_stride;
  l.part = l.heads + up(chunks * 4);
  l.bytes = l.part + up(chunks * 2 * d * 4);
  return l;
}

// V elements of T at p (aligned to their size) as floats.  bf16 -> f32 is
// the bits shifted up, exact.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 1) {
      v[0] = __ldg((const float*)p);
    } else if constexpr (V == 2) {
      const float2 a = __ldg((const float2*)p);
      v[0] = a.x; v[1] = a.y;
    } else {
      static_assert(V == 4, "f32 loads of 1, 2 or 4 elements");
      const float4 a = __ldg((const float4*)p);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
  } else {
    if constexpr (V == 1) {
      v[0] = __uint_as_float((unsigned)__ldg((const unsigned short*)p) << 16);
    } else {
      unsigned w[V / 2];
      if constexpr (V == 2) {
        w[0] = __ldg((const unsigned*)p);
      } else if constexpr (V == 4) {
        const uint2 a = __ldg((const uint2*)p);
        w[0] = a.x; w[1] = a.y;
      } else {
        static_assert(V == 8, "bf16 loads of 1, 2, 4 or 8 elements");
        const uint4 a = __ldg((const uint4*)p);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      }
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *(float4*)(p + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  } else if constexpr (V == 2) {
    *(float2*)p = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The lanes of this warp whose g equals this lane's (g < 512), by nine
// ballots: what __match_any_sync gives, without its cost when the values
// differ.
__device__ __forceinline__ unsigned peers(int g) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bal = __ballot_sync(kFull, (g >> b) & 1);
    m &= ((g >> b) & 1) ? bal : ~bal;
  }
  return m;
}

// ---------------------------------------------------------------- sort --

__global__ void __launch_bounds__(kHistThreads)
seg_sum_hist(const int* __restrict__ lab, int64_t n, int k, int passes, unsigned* __restrict__ hist,
             unsigned* __restrict__ ctr, Word* __restrict__ status, int64_t words) {
  __shared__ unsigned sh[kMaxPasses * kRadix];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < passes * kRadix; e += kHistThreads) sh[e] = 0;
  const int64_t gt = (int64_t)blockIdx.x * kHistThreads + tid;
  const int64_t stride = (int64_t)gridDim.x * kHistThreads;
  for (int64_t e = gt; e < words; e += stride) status[e] = 0;
  if (blockIdx.x == 0 && tid < passes) ctr[tid] = 0;
  __syncthreads();
  // Past kSmallN labels each warp takes kHistUnroll runs of 128 labels a
  // round (a 16-byte load a lane), the loads first; the rest (all of them
  // up to kSmallN, where more threads with fewer labels each finish first,
  // or where the labels are not 16-byte aligned) one a lane.
  const int64_t n4 = ((uintptr_t)lab & 15) == 0 && n > kSmallN ? n / 4 : 0;   // int4s
  const int4* lab4 = (const int4*)lab;
  auto count = [&](int key) {
    const bool ok = key >= 0 && key < k;
    for (int p = 0; p < passes; ++p) {
      const int g = ok ? (key >> (8 * p)) & (kRadix - 1) : kRadix;
      if (__all_sync(kFull, g == __shfl_sync(kFull, g, 0))) {   // one digit: one add
        if (lane == 0 && g < kRadix) atomicAdd(sh + p * kRadix + g, 32u);
      } else if (g < kRadix) {
        atomicAdd(sh + p * kRadix + g, 1u);
      }
    }
  };
  for (int64_t base = (gt - lane) * kHistUnroll; base < n4; base += stride * kHistUnroll) {
    int4 v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t i = base + u * 32 + lane;
      v[u] = i < n4 ? __ldg(lab4 + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      count(v[u].x);
      count(v[u].y);
      count(v[u].z);
      count(v[u].w);
    }
  }
  for (int64_t base = 4 * n4 + gt - lane; base < n; base += stride) {
    const int64_t i = base + lane;
    count(i < n ? __ldg(lab + i) : -1);
  }
  __syncthreads();
  unsigned* mine = hist + (blockIdx.x % kHistCopies) * passes * kRadix;
  for (int e = tid; e < passes * kRadix; e += kHistThreads)
    if (sh[e]) atomicAdd(mine + e, sh[e]);
}

// One stable counting-sort pass over the digit at `shift`.  FIRST: the
// input is the labels (n of them; ids are the row numbers, labels outside
// [0, k) dropped); otherwise the previous pass's keys and ids (as many as
// the histogram counts).  The tile's keys are put in digit order in shared
// memory before the look-back (which then holds no key in registers), so
// that the writes of a warp are runs of one digit; two blocks an SM.  Tiles
// of 512 ITEMS keys.  hist: this pass's histogram in each of kHistCopies
// copies.
template <bool FIRST, int ITEMS>
__global__ void __launch_bounds__(kSortThreads, 2)
seg_sum_pass(const int* __restrict__ kin, const int* __restrict__ iin, int64_t n, int k, int shift,
             const unsigned* __restrict__ hist, int hist_stride, unsigned* __restrict__ ctr,
             Word* __restrict__ status, int* __restrict__ kout, int* __restrict__ iout,
             unsigned* __restrict__ nvp) {
  extern __shared__ int2 s_items[];                      // (key, id) at their place in the tile
  __shared__ unsigned short s_cnt[kSortWarps][kRadix];   // a warp's keys of a digit, then
                                                         // its offset
  __shared__ unsigned s_base[kRadix];   // a digit's place in the output: digits below, tiles before
  __shared__ unsigned s_loc[kRadix];    // a digit's place in the tile
  __shared__ unsigned s_wsum[kRadix / 32];
  __shared__ unsigned s_tile, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ctr, 1u);
  unsigned h = 0, incl = 0;
  if (tid < kRadix) {   // the digits' starts in the sorted order: a scan of the histogram
#pragma unroll
    for (int c = 0; c < kHistCopies; ++c) h += hist[c * hist_stride + tid];
    incl = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_wsum[warp] = incl;
  }
  for (int e = tid; e < kSortWarps * kRadix / 2; e += kSortThreads) ((unsigned*)s_cnt)[e] = 0;
  __syncthreads();
  if (tid < kRadix) {
    unsigned start = incl - h;
    for (int w = 0; w < warp; ++w) start += s_wsum[w];
    s_base[tid] = start;
    if (tid == kRadix - 1) s_total = start + h;
  }
  __syncthreads();
  const unsigned t = s_tile;
  const int64_t len = FIRST ? n : (int64_t)s_total;
  if (t == 0 && tid == 0) *nvp = s_total;
  const int64_t t0 = (int64_t)t * kSortThreads * ITEMS;
  if (t0 >= len) return;   // past the keys: no tile after this one has any

  {
    int key[ITEMS], id[ITEMS];
    unsigned rank[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int64_t i = t0 + warp * (32 * ITEMS) + r * 32 + lane;
      const bool in = i < len;
      const int kk = in ? __ldg(kin + i) : -1;
      key[r] = FIRST ? (in && kk >= 0 && kk < k ? kk : -1) : kk;
      id[r] = FIRST ? (int)i : (in ? __ldg(iin + i) : 0);
    }
    // Ranks in order: round r of warp w holds keys w * 256 + 32 r + lane.
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int g = key[r] >= 0 ? (key[r] >> shift) & (kRadix - 1) : kRadix;
      const unsigned m = peers(g);
      const unsigned before = m & ((1u << lane) - 1u);
      const unsigned base = g < kRadix ? s_cnt[warp][g] : 0u;
      __syncwarp();
      if (g < kRadix && before == 0) s_cnt[warp][g] = (unsigned short)(base + __popc(m));
      __syncwarp();
      rank[r] = base + __popc(before);
    }
    __syncthreads();
    if (tid < kRadix) {
      unsigned cnt = 0;   // this digit's keys in the tile; s_cnt becomes each warp's offset
      for (int w = 0; w < kSortWarps; ++w) {
        const unsigned c = s_cnt[w][tid];
        s_cnt[w][tid] = (unsigned short)cnt;
        cnt += c;
      }
      vstore(status + (int64_t)t * kRadix + tid, (t == 0 ? kInc : kAgg) | cnt);
      unsigned loc = cnt;   // the digits' places in the tile: a scan of the counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(kFull, loc, o);
        if (lane >= o) loc += x;
      }
      s_loc[tid] = loc - cnt;   // (within the warp; the warps before are added below)
      if (lane == 31) s_wsum[warp] = loc;
    }
    __syncthreads();
    if (tid < kRadix) {
      unsigned off = 0;
      for (int w = 0; w < warp; ++w) off += s_wsum[w];
      s_loc[tid] += off;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (key[r] >= 0) {
        const int g = (key[r] >> shift) & (kRadix - 1);
        s_items[s_loc[g] + s_cnt[warp][g] + rank[r]] = make_int2(key[r], id[r]);
      }
    }
  }
  if (tid < kRadix && t > 0) {
    // Decoupled look-back: the digit's keys in the tiles before, kLook
    // tiles' words read at once; then this tile's inclusive count.
    Word prefix = 0;
    for (int64_t tt = (int64_t)t - 1;;) {
      Word w[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u)
        w[u] = tt - u >= 0 ? vload(status + (tt - u) * kRadix + tid) : kInc;
      int u = 0;
      bool done = false;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (done || w[q] == 0) break;
        prefix += w[q] & kCount;
        done = (w[q] & kInc) != 0;
        u = q + 1;
      }
      if (done) break;
      tt -= u;   // from the first word not ready yet
    }
    Word* mine = status + (int64_t)t * kRadix + tid;
    vstore(mine, kInc | (prefix + (vload(mine) & kCount)));
    s_base[tid] += (unsigned)prefix;
  }
  __syncthreads();
  unsigned total = 0;   // the tile's keys
  for (int w = 0; w < kRadix / 32; ++w) total += s_wsum[w];
  for (unsigned i = tid; i < total; i += kSortThreads) {
    const int2 it = s_items[i];
    const int g = (it.x >> shift) & (kRadix - 1);
    const unsigned pos = s_base[g] - s_loc[g] + i;
    kout[pos] = it.x;
    iout[pos] = it.y;
  }
}

// ---------------------------------------------------------------- sums --

struct SumArgs {
  const void* y;
  const int* skey;       // sorted keys
  const int* sid;        // their row ids
  const unsigned* nv;    // valid rows
  int d, k, piece, colblocks;
  float* part;           // (chunks, 2, d)
  float* out;            // (k, d)
  unsigned* hist;        // zeroed here for the next call
  int hist_words;
  int* heads;            // by chunk, the cluster whose chain of pieces it begins (-1: none)
  int* ends;             // by cluster, the chunk its chain ends in (where it has one)
};

// Zero rows [lo, hi) of out over features [col0, col0 + w), every lane: a
// run of whole rows as one block (16-byte stores between its ends), else
// row by row.
__device__ __forceinline__ void zero_rows(float* out, int64_t lo, int64_t hi, int d, int col0,
                                          int w) {
  const int lane = threadIdx.x & 31;
  if (w == d) {
    float* p = out + lo * d;
    const int64_t cells = (hi - lo) * d;
    const int64_t head = ((16 - ((uintptr_t)p & 15)) & 15) / 4 < cells
                             ? ((16 - ((uintptr_t)p & 15)) & 15) / 4 : cells;
    const int64_t quads = (cells - head) / 4;
    if (lane < head) p[lane] = 0.f;
    for (int64_t e = lane; e < quads; e += 32)
      *(float4*)(p + head + 4 * e) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t e = head + 4 * quads + lane; e < cells; e += 32) p[e] = 0.f;
    return;
  }
  for (int64_t r = lo; r < hi; ++r)
    for (int f = lane; f < w; f += 32) out[r * d + col0 + f] = 0.f;
}

// The clusters with no row just before this lane's position i (key `key`,
// the key before it `prev`) and, at the last valid position, after it get
// zero rows: prev + 1 .. key - 1, and key + 1 .. k - 1.  Lanes with such
// clusters are taken in turn, the whole warp writing.
__device__ __forceinline__ void zero_gaps(bool in, int64_t i, int key, int prev, int64_t nv, int k,
                                          float* out, int d, int col0, int w) {
  const int lo1 = prev + 1, hi1 = key, lo2 = key + 1;
  const int hi2 = in && i == nv - 1 ? k : lo2;
  unsigned m = __ballot_sync(kFull, in && (hi1 > lo1 || hi2 > lo2));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const int a1 = __shfl_sync(kFull, lo1, src), b1 = __shfl_sync(kFull, hi1, src);
    const int a2 = __shfl_sync(kFull, lo2, src), b2 = __shfl_sync(kFull, hi2, src);
    if (b1 > a1) zero_rows(out, a1, b1, d, col0, w);
    if (b2 > a2) zero_rows(out, a2, b2, d, col0, w);
  }
}

// Where the run of cluster j in chunk c goes: the partial slot it shares
// with the chunk before (0) or after (1), else its output row.
__device__ __forceinline__ float* dest(const SumArgs& a, int64_t c, int j, int head, int tail) {
  if (j == head) return a.part + (c * 2) * a.d;
  if (j == tail) return a.part + (c * 2 + 1) * a.d;
  return a.out + (int64_t)j * a.d;
}

struct Chunk {
  int64_t c0, c1;   // positions [c0, c1)
  int head, tail;   // the keys shared with the chunk before / after (-1: none)
};

__device__ __forceinline__ Chunk chunk_of(const SumArgs& a, int64_t c, int64_t nv) {
  Chunk ch;
  ch.c0 = c * a.piece;
  ch.c1 = ch.c0 + a.piece < nv ? ch.c0 + a.piece : nv;
  const int* sk = a.skey;
  ch.head = ch.c0 > 0 && sk[ch.c0 - 1] == sk[ch.c0] ? sk[ch.c0] : -1;
  ch.tail = ch.c1 < nv && sk[ch.c1 - 1] == sk[ch.c1] ? sk[ch.c1 - 1] : -1;
  return ch;
}

// For the fold: the cluster whose chain of pieces chunk c begins (its run
// continues into the next chunk and began in c), and the chunk where the
// chain of the cluster continued from the chunk before ends.  One lane.
__device__ __forceinline__ void mark(const SumArgs& a, int64_t c, const Chunk& ch) {
  a.heads[c] = ch.tail >= 0 && ch.tail != ch.head ? ch.tail : -1;
  if (ch.head >= 0 && ch.head != ch.tail) a.ends[ch.head] = (int)c;
}

// d < 32: a lane a position (see the header).  Chunk c of the nv sorted
// positions (c * piece < nv), by one warp: MAXD >= d values a lane, loaded
// V at a time, B steps at once.
template <typename T, int MAXD, int V>
__device__ __forceinline__ void rows_chunk(const SumArgs& a, int64_t c, int64_t nv) {
  constexpr int B = MAXD <= 8 ? 4 : MAXD <= 16 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int d = a.d;
  const Chunk ch = chunk_of(a, c, nv);
  if (lane == 0) mark(a, c, ch);
  const T* y = (const T*)a.y;
  int last = ch.c0 > 0 ? a.skey[ch.c0 - 1] : -1;   // the key before the step
  float acc[MAXD];
#pragma unroll
  for (int f = 0; f < MAXD; ++f) acc[f] = 0.f;
  int ck = -2;   // the open run's key (-2: none)
  for (int64_t s0 = ch.c0; s0 < ch.c1; s0 += 32 * B) {
    int key[B], id[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int64_t i = s0 + 32 * b + lane;
      key[b] = i < ch.c1 ? a.skey[i] : -1;
      id[b] = i < ch.c1 ? a.sid[i] : 0;
    }
    float v[B][MAXD];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const T* r = y + (int64_t)id[b] * d;
#pragma unroll
      for (int f = 0; f < MAXD; f += V) {
        if (f < d && key[b] >= 0) {
          load_vec<T, V>(r + f, &v[b][f]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[b][f + e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (s0 + 32 * b >= ch.c1) break;
      const int kk = key[b];
      int prev = __shfl_up_sync(kFull, kk, 1);
      if (lane == 0) prev = last;
      last = __shfl_sync(kFull, kk, 31);
      zero_gaps(kk >= 0, s0 + 32 * b + lane, kk, prev, nv, a.k, a.out, d, 0, d);
      const bool uni = __all_sync(kFull, kk == ck);
      if (uni && ck >= 0) {   // the open run goes on through every lane
#pragma unroll
        for (int f = 0; f < MAXD; ++f)
          if (f < d) acc[f] = acc[f] + v[b][f];
        continue;
      }
      if (ck >= 0) {   // close the open run: its lanes of this step, then the tree
        float t[MAXD];
#pragma unroll
        for (int f = 0; f < MAXD; ++f) t[f] = kk == ck ? acc[f] + v[b][f] : acc[f];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int f = 0; f < MAXD; ++f)
            if (f < d) t[f] = t[f] + __shfl_down_sync(kFull, t[f], o);
        }
        if (lane == 0) {
          float* p = dest(a, c, ck, ch.head, ch.tail);
#pragma unroll
          for (int f = 0; f < MAXD; ++f)
            if (f < d) p[f] = t[f];
        }
      }
      // The runs that begin and end in this step: a segmented inclusive scan.
      float sc[MAXD];
#pragma unroll
      for (int f = 0; f < MAXD; ++f) sc[f] = v[b][f];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int uk = __shfl_up_sync(kFull, kk, o);
        const bool joined = lane >= o && uk == kk;
#pragma unroll
        for (int f = 0; f < MAXD; ++f) {
          if (f < d) {
            const float up = __shfl_up_sync(kFull, sc[f], o);
            if (joined) sc[f] = up + sc[f];
          }
        }
      }
      const int knext = __shfl_down_sync(kFull, kk, 1);
      if (lane < 31 && kk >= 0 && kk != ck && knext != kk) {
        float* p = dest(a, c, kk, ch.head, ch.tail);
#pragma unroll
        for (int f = 0; f < MAXD; ++f)
          if (f < d) p[f] = sc[f];
      }
      const int k31 = __shfl_sync(kFull, kk, 31);   // the run at lane 31 stays open
#pragma unroll
      for (int f = 0; f < MAXD; ++f) acc[f] = kk == k31 ? v[b][f] : 0.f;
      ck = k31;
    }
  }
  if (ck >= 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int f = 0; f < MAXD; ++f)
        if (f < d) acc[f] = acc[f] + __shfl_down_sync(kFull, acc[f], o);
    }
    if (lane == 0) {
      float* p = dest(a, c, ck, ch.head, ch.tail);
#pragma unroll
      for (int f = 0; f < MAXD; ++f)
        if (f < d) p[f] = acc[f];
    }
  }
}

// d < 32: a lane a position (see the header), a warp a chunk.
template <typename T, int MAXD, int V>
__global__ void __launch_bounds__(kSumWarps * 32)
seg_sum_rows(SumArgs a) {
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < a.hist_words; e += blockDim.x) a.hist[e] = 0;
  const int64_t nv = *a.nv;
  const int64_t c = (int64_t)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (nv == 0) {
    if (c == 0) zero_rows(a.out, 0, a.k, a.d, 0, a.d);
    return;
  }
  if (c * a.piece < nv) rows_chunk<T, MAXD, V>(a, c, nv);
}

// d >= 32: a row a step, lane l of column block b holding features
// 32 V b + V l .. + V (see the header).
template <typename T, int V>
__global__ void __launch_bounds__(kSumWarps * 32)
seg_sum_cols(SumArgs a) {
  constexpr int B = V == 8 ? 8 : V == 4 ? 16 : 32 / V;   // rows loaded at once
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < a.hist_words; e += blockDim.x) a.hist[e] = 0;
  const int64_t nv = *a.nv;
  const int64_t item = (int64_t)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int64_t c = item / a.colblocks;
  const int d = a.d;
  const int col0 = (int)(item % a.colblocks) * 32 * V;
  const int w = d - col0 < 32 * V ? d - col0 : 32 * V;
  if (nv == 0) {
    if (c == 0) zero_rows(a.out, 0, a.k, d, col0, w);
    return;
  }
  if (c * a.piece >= nv) return;
  const Chunk ch = chunk_of(a, c, nv);
  if (lane == 0 && col0 == 0) mark(a, c, ch);
  const T* y = (const T*)a.y;
  const int f = col0 + lane * V;
  const bool live = f < d;
  int last = ch.c0 > 0 ? a.skey[ch.c0 - 1] : -1;
  float t[V];
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = 0.f;
  int ck = -2;
  for (int64_t s0 = ch.c0; s0 < ch.c1; s0 += 32) {
    const int64_t i = s0 + lane;
    const bool in = i < ch.c1;
    const int key = in ? a.skey[i] : -1;
    const int id = in ? a.sid[i] : 0;
    int prev = __shfl_up_sync(kFull, key, 1);
    if (lane == 0) prev = last;
    last = __shfl_sync(kFull, key, 31);
    zero_gaps(in, i, key, prev, nv, a.k, a.out, d, col0, w);
    const int m = ch.c1 - s0 < 32 ? (int)(ch.c1 - s0) : 32;
    for (int q0 = 0; q0 < m; q0 += B) {
      float v[B][V];
      int kq[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int q = q0 + u;
        const int idq = __shfl_sync(kFull, id, q & 31);
        kq[u] = __shfl_sync(kFull, key, q & 31);
        if (q < m && live) {
          load_vec<T, V>(y + (int64_t)idq * d + f, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (q0 + u >= m) break;
        if (kq[u] == ck) {
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = t[e] + v[u][e];
        } else {
          if (ck >= 0 && live) store_vec<V>(dest(a, c, ck, ch.head, ch.tail) + f, t);
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] = v[u][e];
          ck = kq[u];
        }
      }
    }
  }
  if (ck >= 0 && live) store_vec<V>(dest(a, c, ck, ch.head, ch.tail) + f, t);
}

// Cluster j's chain of pieces from chunk c (slot 1) through the q chunks
// after it (slot 0), in chunk order, over features col0 .. col0 + 31: a
// warp, 32 partials loaded at a time before their adds.
__device__ __forceinline__ void fold_warp(const float* part, float* out, int d, int64_t c, int j,
                                          int64_t q, int col0) {
  const int col = col0 + (threadIdx.x & 31);
  const bool live = col < d;
  float t = live ? __ldcg(part + (c * 2 + 1) * d + col) : 0.f;
  for (int64_t i0 = 1; i0 <= q; i0 += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u)
      v[u] = i0 + u <= q && live ? __ldcg(part + (c + i0 + u) * 2 * d + col) : 0.f;
#pragma unroll
    for (int u = 0; u < 32; ++u)
      if (i0 + u <= q) t = t + v[u];
  }
  if (live) out[(int64_t)j * d + col] = t;
}

// The clusters that span chunks, a (chunk, 32 features) a task: where the
// chunk begins a cluster's chain, the cluster's run there (slot 1), then in
// chunk order its run in each chunk after, to the one it ends in (slot 0).
// Block b's warps take tasks b, b + G, b + 2 G, ... (G blocks), each warp
// on its own, so that the first tasks land on distinct blocks.  A chain of
// at most kFoldLong chunks is its warp's (fold_warp); a longer one is taken
// by the whole block once its warps are done (kFoldRows partials staged at
// a time by every warp, added by the first), or by its warp where the
// block already holds kFoldLongMax of them.
__global__ void __launch_bounds__(kFoldWarps * 32)
seg_sum_fold(const unsigned* __restrict__ nvp, int piece, const int* __restrict__ heads,
             const int* __restrict__ ends, int d, const float* __restrict__ part,
             float* __restrict__ out) {
  __shared__ float stage[kFoldRows][32];
  __shared__ long long s_long[kFoldLongMax];
  __shared__ int s_nlong;
  constexpr int kPer = kFoldRows / kFoldWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (d + 31) / 32;
  const int64_t tasks = ((int64_t)*nvp + piece - 1) / piece * groups;
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();
  for (int64_t task = blockIdx.x + (int64_t)warp * gridDim.x; task < tasks;
       task += (int64_t)gridDim.x * kFoldWarps) {
    const int j = heads[task / groups];
    if (j < 0) continue;
    const int64_t c = task / groups;
    const int64_t q = ends[j] - c;   // the chunks after c that hold the cluster
    int slot = kFoldLongMax;
    if (q > kFoldLong && lane == 0) slot = atomicAdd(&s_nlong, 1);
    slot = __shfl_sync(kFull, slot, 0);
    if (slot < kFoldLongMax) s_long[slot] = task;   // the block's, below
    else fold_warp(part, out, d, c, j, q, (int)(task % groups) * 32);
  }
  __syncthreads();
  const int nlong = s_nlong < kFoldLongMax ? s_nlong : kFoldLongMax;
  for (int l = 0; l < nlong; ++l) {
    const int64_t lt = s_long[l];
    const int64_t c = lt / groups;
    const int j = heads[c];
    const int64_t q = ends[j] - c;
    const int col = (int)(lt % groups) * 32 + lane;
    const bool live = col < d;
    float t = warp == 0 && live ? __ldcg(part + (c * 2 + 1) * d + col) : 0.f;
    for (int64_t i0 = 1; i0 <= q; i0 += kFoldRows) {
      const int m = q - i0 + 1 < kFoldRows ? (int)(q - i0 + 1) : kFoldRows;
      float tmp[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int r = warp + u * kFoldWarps;
        tmp[u] = r < m && live ? __ldcg(part + (c + i0 + r) * 2 * d + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) stage[warp + u * kFoldWarps][lane] = tmp[u];
      __syncthreads();
      if (warp == 0) {
#pragma unroll 8
        for (int r = 0; r < m; ++r) t = t + stage[r][lane];
      }
      __syncthreads();
    }
    if (warp == 0 && live) out[(int64_t)j * d + col] = t;
  }
}

template <typename T, int M>
void launch_rows(const SumArgs& a, unsigned blocks, bool wide, cudaStream_t s) {
  if (wide) seg_sum_rows<T, M, 16 / sizeof(T)><<<blocks, kSumWarps * 32, 0, s>>>(a);
  else seg_sum_rows<T, M, 1><<<blocks, kSumWarps * 32, 0, s>>>(a);
}

template <typename T>
cudaError_t launch_sums(const SumArgs& base, int64_t chunks, cudaStream_t s) {
  constexpr int esz = (int)sizeof(T);
  SumArgs a = base;
  const int d = a.d;
  const uintptr_t align = (uintptr_t)a.y;
  if (d < kRowsBelow) {
    const unsigned blocks = (unsigned)((chunks + kSumWarps - 1) / kSumWarps);
    const bool wide = (d * esz) % 16 == 0 && (align & 15) == 0;   // 16-byte loads
    if (d <= 8) launch_rows<T, 8>(a, blocks, wide, s);
    else if (d <= 16) launch_rows<T, 16>(a, blocks, wide, s);
    else launch_rows<T, 32>(a, blocks, wide, s);
    return cudaGetLastError();
  }
  // The narrowest vector (at most 16 bytes) that covers d with 32 lanes,
  // where d and y's alignment allow it.
  int v = 1;
  while (v * 2 * esz <= 16 && v * 32 < d && d % (v * 2) == 0 && (align % (v * 2 * esz)) == 0)
    v *= 2;
  a.colblocks = (d + 32 * v - 1) / (32 * v);
  const int64_t blocks = (chunks * a.colblocks + kSumWarps - 1) / kSumWarps;
  if (blocks >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  if (v == 1) seg_sum_cols<T, 1><<<(unsigned)blocks, kSumWarps * 32, 0, s>>>(a);
  else if (v == 2) seg_sum_cols<T, 2><<<(unsigned)blocks, kSumWarps * 32, 0, s>>>(a);
  else if (v == 4) seg_sum_cols<T, 4><<<(unsigned)blocks, kSumWarps * 32, 0, s>>>(a);
  else if constexpr (esz == 2) seg_sum_cols<T, 8><<<(unsigned)blocks, kSumWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool FIRST, int ITEMS>
cudaError_t launch_pass(int64_t tiles, cudaStream_t s, const int* kin, const int* iin, int64_t n,
                        int k, int shift, const unsigned* hist, int hist_stride, unsigned* ctr,
                        Word* status, int* kout, int* iout, unsigned* nv) {
  static size_t smem_set[32] = {};
  constexpr size_t smem = (size_t)kSortThreads * ITEMS * sizeof(int2);
  cudaError_t err = cdrs::set_smem_once(seg_sum_pass<FIRST, ITEMS>, smem, smem_set);
  if (err != cudaSuccess) return err;
  seg_sum_pass<FIRST, ITEMS><<<(unsigned)tiles, kSortThreads, smem, s>>>(
      kin, iin, n, k, shift, hist, hist_stride, ctr, status, kout, iout, nv);
  return cudaGetLastError();
}

template <bool FIRST>
cudaError_t launch_pass(int64_t tiles, cudaStream_t s, const int* kin, const int* iin, int64_t n,
                        int k, int shift, const unsigned* hist, int hist_stride, unsigned* ctr,
                        Word* status, int* kout, int* iout, unsigned* nv) {
  if (n <= kSmallN)
    return launch_pass<FIRST, kSortItems / 2>(tiles, s, kin, iin, n, k, shift, hist, hist_stride,
                                              ctr, status, kout, iout, nv);
  return launch_pass<FIRST, kSortItems>(tiles, s, kin, iin, n, k, shift, hist, hist_stride, ctr,
                                        status, kout, iout, nv);
}

}  // namespace

extern "C" {

// Bytes of scratch a call of n rows of d features, chunks of `piece`
// positions and `passes` sort passes needs (Layout above); -1 for shapes
// cdrs_seg_sum refuses.
int64_t cdrs_seg_sum_scratch_bytes(int64_t n, int d, int piece, int passes) {
  if (n < 0 || n >= ((int64_t)1 << 31) || d < 1 || piece < 32 || piece % 32 || passes < 1 ||
      passes > kMaxPasses)
    return -1;
  return layout_of(n, d, piece, passes).bytes;
}

// y (n, d) row-major f32 (bf16 == 0) or bf16; lab (n,) int32; out (k, d)
// f32, written in full.  piece: positions a chunk (a multiple of 32);
// passes: 8-bit digits sorted (8 * passes >= the bits of k - 1).  scratch:
// at least cdrs_seg_sum_scratch_bytes(n, d, piece, passes) bytes, 256-byte
// aligned, its first part zero before the first call of these passes
// (each call leaves it so); ends, k ints.  passes + 3 launches on
// `stream`.  Returns a cudaError_t code (0 = launched).
int cdrs_seg_sum(const void* y, int bf16, const void* lab, int64_t n, int d, int k, int piece,
                 int passes, void* scratch, int64_t scratch_bytes, void* ends, void* out,
                 void* stream) {
  const int64_t need = cdrs_seg_sum_scratch_bytes(n, d, piece, passes);
  if (need < 0 || k < 1 || (int64_t)k * d >= ((int64_t)1 << 31) || scratch_bytes < need ||
      ((uintptr_t)scratch & 255) || (k > 1 && 8 * passes < 32 - __builtin_clz((unsigned)(k - 1))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout_of(n, d, piece, passes);
  char* base = (char*)scratch;
  unsigned* hist = (unsigned*)base;   // kHistCopies copies of passes * 256
  unsigned* ctr = hist + kHistCopies * passes * kRadix;
  unsigned* nv = ctr + passes;
  Word* status = (Word*)(base + l.status);
  int* ks[2] = {(int*)(base + l.keys), (int*)(base + l.keys + 2 * l.keys_stride)};
  int* is[2] = {(int*)(base + l.keys + l.keys_stride), (int*)(base + l.keys + 3 * l.keys_stride)};
  const int64_t tiles = tiles_of(n);
  const int64_t chunks = chunks_of(n, piece);
  const int64_t hb = (n + kHistThreads * 4 - 1) / (kHistThreads * 4);   // an int4 a thread
  seg_sum_hist<<<(unsigned)(hb < 1 ? 1 : hb > kHistBlocksMax ? kHistBlocksMax : hb),
                 kHistThreads, 0, s>>>((const int*)lab, n, k, passes, hist, ctr, status,
                                       passes * tiles * kRadix);
  cudaError_t err = cudaGetLastError();
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    const int* kin = p == 0 ? (const int*)lab : ks[(p - 1) & 1];
    const int* iin = p == 0 ? nullptr : is[(p - 1) & 1];
    const unsigned* h = hist + p * kRadix;
    const int hs = passes * kRadix;
    Word* st = status + p * tiles * kRadix;
    err = p == 0 ? launch_pass<true>(tiles, s, kin, iin, n, k, 0, h, hs, ctr, st, ks[0], is[0], nv)
                 : launch_pass<false>(tiles, s, kin, iin, n, k, 8 * p, h, hs, ctr + p, st,
                                      ks[p & 1], is[p & 1], nv);
  }
  if (err != cudaSuccess) return (int)err;
  const SumArgs a{y, ks[(passes - 1) & 1], is[(passes - 1) & 1], nv, d, k, piece, 1,
                  (float*)(base + l.part), (float*)out, hist, kHistCopies * passes * kRadix,
                  (int*)(base + l.heads), (int*)ends};
  err = bf16 ? launch_sums<__nv_bfloat16>(a, chunks, s) : launch_sums<float>(a, chunks, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t fb = (chunks * ((d + 31) / 32) + kFoldWarps - 1) / kFoldWarps;
  seg_sum_fold<<<(unsigned)(fb < kFoldBlocksMax ? fb : kFoldBlocksMax), kFoldWarps * 32, 0, s>>>(
      nv, piece, (const int*)(base + l.heads), (const int*)ends, d, (const float*)(base + l.part),
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
