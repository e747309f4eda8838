// K5: attention with decomposed relative positions, Segment Anything's
// image-encoder attention, for Hopper:
//   out = softmax(q . k^T / sqrt(D) + rel_h[kh] + rel_w[kw]) . v
// over an h x w map of S = h w tokens, where query (i, j) and key (kh, kw)
// get rel_h = q(i, j) . Rh[i - kh + h - 1] and rel_w = q(i, j) . Rw[j - kw
// + w - 1] from the unscaled q and the block's (2h - 1, 64), (2w - 1, 64)
// tables. No JAX counterpart (the JAX package's encoders are CLIP's, K3).
// The arithmetic is ops/kernels/relpos_attention.py's plain version:
//   the terms accumulated in f32 and rounded to bf16;
//   logits = (q . k) in f32 times 1/sqrt(D), plus (rel_h + rel_w) in f32;
//   an online softmax in f32 over key tiles; e = exp(logit - running max)
//   rounded to bf16 before P . V, the row sum of the f32 e divided at the
//   end; P . V accumulated in f32; output in bf16.
//
// What bounds it on an H100 (perfbench/configs/sam_vitb.py k5_counts): at
// micro-batch 8 a global call (8 x 4,096 tokens, 12 heads) is 418.7 GFLOP
// against 201 MB, so the tensor cores, 0.42 ms; a windowed call (200
// windows x 196 tokens) is 25.3 GFLOP against 241 MB, so the bytes, 0.072
// ms. S reaches 4,096, past what a block holds, so the design is flash
// attention: a block owns the queries of consumer warpgroups of 64 (3 at
// the global maps, 2 at the windows) of one (image, head), and walks the
// keys in tiles of 64 through a ring of kStages shared-memory stages that
// one producer thread keeps full with TMA loads (full / empty mbarriers),
// so the warpgroups run apart and one's softmax overlaps another's
// products. At the global maps 3 warpgroups took a call 1.495 -> 1.238 ms
// against 2 (4: 1.695); at the windows 2 beat 3 and 4 (0.275 against 0.452,
// 0.300; H100 80GB HBM3, CUDA events). Q . K^T is wgmma
// m64n64k16 (both operands K-major); P is rounded in registers, where it
// has the layout of wgmma's A operand, and P . V is wgmma with V as an
// MN-major B, as in K3 (csrc/attention.cu). No (S, S) tensor exists
// anywhere. The relative terms are made in the block, before the key loop,
// from its own queries, on the tensor cores, in one of two modes:
//   * row tiles (w = 64, the global blocks): a warpgroup's 64 queries are
//     one query row i and a key tile is one key row kh. Q . Rh[i .. i + 63]^T
//     gives rel_h for every key row (column h - 1 - kh), kept in shared
//     memory and read once a tile; Q . Rw[0 .. 127]^T gives q . Rw[r] for
//     every r, and each thread picks out, once, the 32 rel_w values of its
//     accumulator positions (row j, key column kw: r = j - kw + 63), which
//     serve every key tile from registers;
//   * small maps (h, w <= 32, the 14 x 14 windows): Q . [Rh; Rw]^T (one
//     m64n128 product of both tables) kept in shared memory, and each logit
//     adds the two entries its query and key pick (a key's (kh, kw) from a
//     table made once a block).
// The tables are copied into the swizzled layout by the consumers; the
// padded rows (past 2h - 1) are zeros. Queries and keys past S read as
// zeros (TMA's out-of-bounds fill); keys past S are masked to -inf and
// queries past S are not written.
//
// The window map (SAM's windowed blocks, `window_relpos_attention`): the
// small-map mode over the ws x ws windows of an unpadded h x w map, read
// and written in place, so the caller's pad, partition, unpartition and
// crop copies do not exist. TMA reads the map through 5-D tensor maps
// (d, head, column, row, batch) one window row a box, and a box must land
// 1024-byte aligned (128-byte swizzle), so a tile holds whole window rows,
// each at a pitch of 8, 16 or 32 slots (`slot_pitch`): at ws = 14, 4 rows
// of 16 slots, 14 keys and 2 masked, and the window's 196 keys in 4 tiles,
// as the partitioned call's 196 keys in 64-key tiles. A block takes two
// tiles of one window's real query rows (inside the map), as wide as its
// real part, so an (image, head) of the 64 x 64 map in windows of 14 gets
// 41 blocks against the padded map's 50 (edge windows 14 x 8 and 8 x 14
// and the 8 x 8 corner take one). Keys past the map (the pad, which SAM
// zero-pads after norm1, so that its k and v are the qkv bias) land as
// TMA's zeros; in a window with a pad the producer warp then writes
// bias_k[head] and bias_v[head] over them, fences the tile for wgmma's
// proxy and announces it, so each pad key has the bias as k and v and its
// own (kh, kw) terms. Each real query's output row is written once, at its
// map position, into a contiguous (B, h w, H, 64) tensor. The keys meet
// the online softmax in other tiles than the partitioned call's, so the
// two agree to rounding, not bit for bit.
//
// Without tables (SAM 2's Hiera, whose attention adds no relative
// positions, at head dim 56): out = softmax(q . k^T / sqrt(56)) . v in the
// row-tile mode (the global 64 x 64 maps) and in the window map (windows of
// 8, 14 and 7), the same pipeline with no table loads, no products of Q
// with the tables and no terms, so neither their shared memory. The rows
// of 56 land by TMA in the 64-wide tiles, whose columns 56 .. 63 read as
// zeros (the tensor maps' head dim is 56), so Q . K^T sums nothing more and
// P . V's last 8 columns are zeros that the output, 56 columns a row, does
// not write; the pad keys' bias rows are 56 wide, their last 8 columns
// zeros too.
#include "common.cuh"
#include "hopper.cuh"

namespace istpu {
namespace {

constexpr int kHeadDim = 64;                     // a tile's columns; the head dim with tables
constexpr int kPlainHeadDim = 56;                // the head dim without tables
constexpr int kTile = 64;                        // queries a warpgroup, keys a tile
constexpr int kStages = 3;                       // K and V tiles in flight
constexpr uint32_t kBox = kTile * kHeadDim * 2;  // one 64 x 64 bf16 tile
constexpr int kRowSide = 64;                     // w of the row-tile mode
constexpr int kMaxSide = 32;                     // h and w of the small-map mode
constexpr int kMaxSmallKeys = kMaxSide * kMaxSide;
constexpr int kRowConsumers = 3;                 // consumer warpgroups a block, row tiles
constexpr int kSmallConsumers = 2;               // and small maps

// Threads of a block of `consumers` warpgroups and one producer warp.
constexpr int block_threads(int consumers) { return 128 * consumers + 32; }

// Q of each warpgroup, the K and V stages, two tiles a warpgroup of tables
// and then of terms (with tables), the small maps' key table, the mbarriers
// (full, empty, Q's, and the window map's landed).
constexpr size_t smem_bytes(int consumers, bool tables) {
  return 1024 + kBox * ((tables ? 3 : 1) * consumers + 2 * kStages) +
         kMaxSmallKeys * sizeof(int) + (3 * kStages + 1) * sizeof(uint64_t);
}

// A small map's key-table entry: kh | kw << 16, or kMasked for a slot that
// holds no key of the map (past S, or past the window's side).
constexpr int kMasked = static_cast<int>(0x80000000u);

// Element (r, c) of a warpgroup's 64 x 128 bf16 terms, each row rotated by
// 8 (r % 8) columns, so a warp's stores of 8 rows hit distinct banks.
__device__ __forceinline__ int term_at(int r, int c) {
  return r * 128 + ((c + 8 * (r & 7)) & 127);
}

// What the window map reads besides its tensor maps: the k and v rows of a
// pad token (contiguous (H, 64)) and the map's sides. The partitioned
// modes pass no rows and their own map as h x w.
struct WindowMap {
  const bf16* bias_k;
  const bf16* bias_v;
  int h, w;
};

// Slots a window row of `cols` keys or queries takes in a 64-row tile: a
// power of two from 8, so that each row starts 1024-byte aligned, where a
// 128-byte-swizzled TMA box must land; and the window rows a tile holds.
__host__ __device__ inline int slot_pitch(int cols) {
  return cols <= 8 ? 8 : cols <= 16 ? 16 : 32;
}
__host__ __device__ inline int rows_a_tile(int cols) { return kTile / slot_pitch(cols); }

// Blocks of a window whose real part (inside the map) is rh x rw: each
// takes kSmallConsumers tiles of rows_a_tile(rw) of its real rows.
__host__ __device__ inline int window_blocks(int rh, int rw) {
  const int rows = kSmallConsumers * rows_a_tile(rw);
  return (rh + rows - 1) / rows;
}

// Windows down and across an h x w map, and the real rows and columns of
// the last ones.
struct MapSplit {
  int nwy, nwx, rh_last, rw_last;
};
__host__ __device__ inline MapSplit map_split(int h, int w, int ws) {
  const int nwy = (h + ws - 1) / ws, nwx = (w + ws - 1) / ws;
  return {nwy, nwx, h - (nwy - 1) * ws, w - (nwx - 1) * ws};
}

// Blocks of one row of windows whose real rows are rh.
__host__ __device__ inline int window_row_blocks(const MapSplit& m, int rh, int ws) {
  return (m.nwx - 1) * window_blocks(rh, ws) + window_blocks(rh, m.rw_last);
}

// Blocks of one (image, head) of an h x w map in ws x ws windows.
__host__ __device__ inline int window_map_blocks(int h, int w, int ws) {
  const MapSplit m = map_split(h, w, ws);
  return (m.nwy - 1) * window_row_blocks(m, ws, ws) + window_row_blocks(m, m.rh_last, ws);
}

// What block `idx` of an (image, head) takes: window (wy, wx), whose real
// part is rh x rw, from its window row row0 on.
struct WindowTile {
  int wy, wx, rh, rw, row0;
};
__device__ __forceinline__ WindowTile window_tile(int idx, int h, int w, int ws) {
  const MapSplit m = map_split(h, w, ws);
  const int full = window_row_blocks(m, ws, ws);
  WindowTile t;
  t.wy = min(idx / full, m.nwy - 1);
  t.rh = t.wy < m.nwy - 1 ? ws : m.rh_last;
  idx -= t.wy * full;
  const int per = window_blocks(t.rh, ws);
  t.wx = min(idx / per, m.nwx - 1);
  t.rw = t.wx < m.nwx - 1 ? ws : m.rw_last;
  t.row0 = (idx - t.wx * per) * kSmallConsumers * rows_a_tile(t.rw);
  return t;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Rows r0 .. r0 + 63 of a contiguous (rows, 64) bf16 table into a swizzled
// 64 x 64 tile (hopper.cuh's layout); rows outside [0, rows) are zeros.
__device__ __forceinline__ void load_table_tile(unsigned char* dst, const bf16* tab, int rows,
                                                int r0, int tid, int nthreads) {
  for (int ch = tid; ch < kTile * 8; ch += nthreads) {
    const int r = ch >> 3, cc = ch & 7, gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < rows) val = *reinterpret_cast<const uint4*>(tab + gr * kHeadDim + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * 128 + ((cc ^ (r & 7)) << 4)) = val;
  }
}

// S = mh mw tokens a map (a window of side mh = mw, in the window map,
// whose tensor maps are map_row_map's: tq and tk, tv in boxes of ws
// columns, tq_last of the last window column's real width); D the head dim
// of q, k, v, the bias rows and the output (kHeadDim with tables,
// kPlainHeadDim without).
template <bool kRowTiles, int kConsumers, bool kWindowMap, bool kTables>
__global__ void __launch_bounds__(block_threads(kConsumers), kConsumers == 2 ? 2 : 1)
relpos_attention_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tq_last,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const WindowMap wm,
                        const bf16* __restrict__ rel_h, const bf16* __restrict__ rel_w,
                        bf16* __restrict__ o, int S, int H, int mh, int mw, int D,
                        float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_1024(smem_raw);
  unsigned char* Ks = Qs + kConsumers * kBox;
  unsigned char* Vs = Ks + kStages * kBox;
  unsigned char* tabs = Vs + kStages * kBox;  // the tables, then the terms
  int* key_hw = reinterpret_cast<int*>(tabs + (kTables ? 2 * kConsumers * kBox : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(key_hw + kMaxSmallKeys);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  uint64_t* landed = qbar + 1;  // the window map's K and V, before the pad keys' patch

  const int b = blockIdx.z, head = blockIdx.y, bx = blockIdx.x;
  const int tid = threadIdx.x;
  // The window map: this block's window and rows; keys in tiles of rk
  // window rows pk slots apart, queries in tiles of rq rows pq apart.
  const WindowTile wt = kWindowMap ? window_tile(bx, wm.h, wm.w, mw) : WindowTile{};
  const int rk = rows_a_tile(mw), pk = slot_pitch(mw);
  const int rq = rows_a_tile(wt.rw), pq = slot_pitch(wt.rw);
  const bool has_pad = kWindowMap && (wt.rh < mh || wt.rw < mw);
  const int q0 = kWindowMap ? 0 : bx * kTile * kConsumers;  // the partitioned modes' queries
  const int n_tiles = kWindowMap ? (mh + rk - 1) / rk : (S + kTile - 1) / kTile;

  if (kWindowMap) {  // key slots no box writes (past the window's side) stay zeros
    for (int i = tid; i < 2 * kStages * kBox / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(Ks)[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], has_pad ? 32 : 1);  // the patching warp's lanes, or TMA's one
      mbar_init(&empty[st], 128 * kConsumers);
      mbar_init(&landed[st], 1);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {  // the producer: Q once, then K and V through the ring
    const int lane = tid - 128 * kConsumers;
    if (kWindowMap) {
      // Coordinates run innermost first: (d, head, map column, map row,
      // batch). Q: rq window rows a warpgroup, each as wide as the window's
      // real part; K and V: rk window rows a tile, each the window's side
      // (the pad reads zeros), and where the window has a pad, the warp
      // writes the bias rows over the pad keys once a tile has landed,
      // fences them for wgmma's proxy and then announces the tile.
      const int x0 = wt.wx * mw, y0 = wt.wy * mh;
      uint64_t* land = has_pad ? landed : full;
      const auto load_tile = [&](int t) {
        const int st = t % kStages;
        mbar_arrive_expect_tx(&land[st], 2 * rk * mw * 128);
        for (int i = 0; i < rk; ++i) {
          tma_load_5d(Ks + st * kBox + i * pk * 128, &tk, &land[st], 0, head, x0, y0 + t * rk + i,
                      b);
          tma_load_5d(Vs + st * kBox + i * pk * 128, &tv, &land[st], 0, head, x0, y0 + t * rk + i,
                      b);
        }
      };
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, kConsumers * rq * wt.rw * 128);
        for (int i = 0; i < kConsumers * rq; ++i)
          tma_load_5d(Qs + i * pq * 128, wt.rw == mw ? &tq : &tq_last, qbar, 0, head, x0,
                      y0 + wt.row0 + i, b);
      }
      if (!has_pad) {
        if (lane == 0)
          for (int t = 0; t < n_tiles; ++t) {
            if (t >= kStages) mbar_wait(&empty[t % kStages], ((t / kStages) - 1) & 1);
            load_tile(t);
          }
      } else {
        const int c = lane & 7;  // columns 8 c .. 8 c + 7; zeros past D
        uint4 pad_k = make_uint4(0u, 0u, 0u, 0u), pad_v = pad_k;
        if (c * 8 < D) {
          pad_k = *reinterpret_cast<const uint4*>(wm.bias_k + head * D + c * 8);
          pad_v = *reinterpret_cast<const uint4*>(wm.bias_v + head * D + c * 8);
        }
        if (lane == 0)
          for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile(t);
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % kStages;
          mbar_wait(&landed[st], (t / kStages) & 1);
          for (int slot = lane >> 3; slot < kTile; slot += 4) {
            const int kh = t * rk + slot / pk, kw = slot % pk;
            if (kh < mh && kw < mw && (kh >= wt.rh || kw >= wt.rw)) {
              const uint32_t off = slot * 128 + ((c ^ (slot & 7)) << 4);
              *reinterpret_cast<uint4*>(Ks + st * kBox + off) = pad_k;
              *reinterpret_cast<uint4*>(Vs + st * kBox + off) = pad_v;
            }
          }
          fence_proxy_async();
          mbar_arrive(&full[st]);
          if (t >= 1 && t - 1 + kStages < n_tiles) {  // refill the stage tile t - 1 held
            mbar_wait(&empty[(t - 1) % kStages], ((t - 1) / kStages) & 1);
            if (lane == 0) load_tile(t - 1 + kStages);
          }
        }
      }
    } else if (lane == 0) {
      // Coordinates run innermost first: (d, head, token, batch).
      mbar_arrive_expect_tx(qbar, kBox * kConsumers);
      for (int c = 0; c < kConsumers; ++c)
        tma_load_4d(Qs + c * kBox, &tq, qbar, 0, head, q0 + c * kTile, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * kBox);
        tma_load_4d(Ks + st * kBox, &tk, &full[st], 0, head, t * kTile, b);
        tma_load_4d(Vs + st * kBox, &tv, &full[st], 0, head, t * kTile, b);
      }
    }
    return;
  }

  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;     // this thread's rows r0 and r0 + 8 of its warpgroup's tile
  const int m0 = q0 + wg * kTile;   // the tile's first query
  unsigned char* Qw = Qs + wg * kBox;
  bf16* terms = reinterpret_cast<bf16*>(tabs + wg * 2 * kBox);  // 64 x 128 a warpgroup

  // The tables into tiles: row tiles, Rh rows i .. i + 63 (a tile a
  // warpgroup) and Rw rows 0 .. 127 (the next two tiles); small maps, Rh
  // and Rw rows 0 .. 63 (tiles 0 and 1), and each key's (kh, kw).
  if (kTables && kRowTiles) {
    load_table_tile(tabs + wg * kBox, rel_h, 2 * mh - 1, m0 / kRowSide, wtid, 128);
    if (wg < 2)
      load_table_tile(tabs + (kConsumers + wg) * kBox, rel_w, 2 * mw - 1, wg * kTile, wtid, 128);
  } else if (kTables && wg < 2) {
    load_table_tile(tabs + wg * kBox, wg == 0 ? rel_h : rel_w, 2 * (wg == 0 ? mh : mw) - 1, 0,
                    wtid, 128);
  }
  if (!kRowTiles) {
    for (int n = tid; n < n_tiles * kTile; n += 128 * kConsumers) {
      const int kh = kWindowMap ? (n / kTile) * rk + (n % kTile) / pk : n / mw;
      const int kw = kWindowMap ? n % pk : n % mw;
      const bool key = kWindowMap ? kh < mh && kw < mw : n < S;
      key_hw[n] = key ? kh | (kw << 16) : kMasked;
    }
  }
  fence_proxy_async();
  named_barrier_sync(1, 128 * kConsumers);

  mbar_wait(qbar, 0);
  uint32_t rel_w_pairs[16];
  if (kTables) {
    // prod[4 j + e] is (row r0 + 8 (e / 2), column 8 j + 2 t4 + e % 2) of
    // Q . [two table tiles: Rw's (row tiles), or Rh's and Rw's]^T, 128
    // columns; rel_h_prod the same of Q . (its Rh tile)^T (row tiles).
    float prod[64], rel_h_prod[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) prod[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) rel_h_prod[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      wgmma_m64n128k16_ss(prod, kmajor_desc(Qw + 32 * kk),
                          kmajor_desc(tabs + (kRowTiles ? kConsumers : 0) * kBox + 32 * kk));
      if (kRowTiles)
        wgmma_m64n64k16_ss(rel_h_prod, kmajor_desc(Qw + 32 * kk),
                           kmajor_desc(tabs + wg * kBox + 32 * kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(prod);
    if (kRowTiles) fence_regs(rel_h_prod);
    named_barrier_sync(1, 128 * kConsumers);  // every warpgroup is done with the tables

#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + 8 * hf, c = 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(terms + term_at(r, c)) =
            pack_bf16(prod[4 * j + 2 * hf], prod[4 * j + 2 * hf + 1]);
      }
    named_barrier_sync(2 + wg, 128);

    // Row tiles: rel_w of (row r0 + 8 hf, key column 8 j + 2 t4 + e) is
    // terms[row][row - column + 63]; two bf16 a register, [2 j + hf].
    if (kRowTiles) {
      const uint16_t* bits = reinterpret_cast<const uint16_t*>(terms);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 8 * hf, c = 8 * j + 2 * t4;
          rel_w_pairs[2 * j + hf] =
              static_cast<uint32_t>(bits[term_at(r, r - c + kRowSide - 1)]) |
              (static_cast<uint32_t>(bits[term_at(r, r - c + kRowSide - 2)]) << 16);
        }
      named_barrier_sync(2 + wg, 128);
      // rel_h of key row kh is column h - 1 - kh of rel_h_prod.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(terms + term_at(r0 + 8 * hf, 8 * j + 2 * t4)) =
              pack_bf16(rel_h_prod[4 * j + 2 * hf], rel_h_prod[4 * j + 2 * hf + 1]);
      named_barrier_sync(2 + wg, 128);
    }
  }
  // Small maps: each of this thread's two queries' (i, j) in its map or
  // window; query slots past it take a row and column the tables hold.
  int qi[2], qj[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + r0 + 8 * hf, r = r0 + 8 * hf;
    qi[hf] = min(kWindowMap ? wt.row0 + wg * rq + r / pq : m / mw, mh - 1);
    qj[hf] = min(kWindowMap ? r % pq : m % mw, mw - 1);
  }

  const float neg_inf = __int_as_float(0xff800000);
  const float log2e = 1.4426950408889634f;
  float acc[32], row_max[2] = {neg_inf, neg_inf}, row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(&full[st], (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(Qw + 32 * kk), kmajor_desc(Ks + st * kBox + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Logits: s[4 j + e] is row r0 + 8 (e / 2), key 64 kt + 8 j + 2 t4 + e % 2.
    if (kRowTiles && !kTables) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale;
    } else if (kRowTiles) {
      float rh[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rh[hf] = __bfloat162float(terms[term_at(r0 + 8 * hf, mh - 1 - kt)]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t pair = rel_w_pairs[2 * j + (e >> 1)];
          const float rw = bf16_bits_to_float((e & 1) ? pair >> 16 : pair & 0xffffu);
          s[4 * j + e] = s[4 * j + e] * scale + (rh[e >> 1] + rw);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int n = kt * kTile + 8 * j + 2 * t4 + e1;
          const int hw = key_hw[n], kh = hw & 0xffff, kw = (hw >> 16) & 0x7fff;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            const float term =
                kTables ? __bfloat162float(terms[term_at(r, qi[hf] + mh - 1 - kh)]) +
                              __bfloat162float(terms[term_at(r, kTile + qj[hf] + mw - 1 - kw)])
                        : 0.f;
            float& l = s[4 * j + 2 * hf + e1];
            l = hw != kMasked ? l * scale + term : neg_inf;
          }
        }
    }

    // Online softmax: the new running max over the quad, the rescale of
    // what came before, e in f32 summed unrounded.
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], shift[2], tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = exp2f((row_max[hf] - mx[hf]) * log2e);
      shift[hf] = mx[hf] * log2e;
      row_max[hf] = mx[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], log2e, -shift[hf]));
      tile_sum[hf] += s[i];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) row_sum[hf] = row_sum[hf] * alpha[hf] + tile_sum[hf];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // e in bf16 as the A fragments of P . V: k-step kk covers keys
    // 16 kk .. 16 kk + 15 of the tile, the 8-key blocks 2 kk and 2 kk + 1.
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int lo = 8 * kk, hi = 8 * kk + 4;
      p[kk][0] = pack_bf16(s[lo], s[lo + 1]);
      p[kk][1] = pack_bf16(s[lo + 2], s[lo + 3]);
      p[kk][2] = pack_bf16(s[hi], s[hi + 1]);
      p[kk][3] = pack_bf16(s[hi + 2], s[hi + 3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs(acc, p[kk], mnmajor_desc(Vs + st * kBox + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);  // this stage's K and V are read
  }

  // Output: a fresh contiguous (B, h w, H, D) tensor over the map (the
  // partitioned modes' own), acc over the row sum; a query's token is
  // its row-major place in the map (in the partitioned modes, m itself),
  // and only real queries are written.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row_sum[hf] += __shfl_xor_sync(0xffffffffu, row_sum[hf], 1);
    row_sum[hf] += __shfl_xor_sync(0xffffffffu, row_sum[hf], 2);
  }
  const long long row_stride = static_cast<long long>(H) * D;
  bf16* ob = o + (static_cast<long long>(b) * wm.h * wm.w * H + head) * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + r0 + 8 * hf, r = r0 + 8 * hf;
    const int i = wt.row0 + wg * rq + r / pq, j = r % pq;
    if (kWindowMap ? i >= wt.rh || j >= wt.rw : m >= S) continue;
    const float inv = 1.f / row_sum[hf];
    const long long tok =
        kWindowMap ? static_cast<long long>(wt.wy * mh + i) * wm.w + wt.wx * mw + j : m;
    bf16* orow = ob + tok * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * hf] * inv, acc[4 * j + 2 * hf + 1] * inv);
  }
}

template <bool kRowTiles, int kConsumers, bool kWindowMap, bool kTables>
cudaError_t launch_relpos(const CUtensorMap& tq, const CUtensorMap& tq_last,
                          const CUtensorMap& tk, const CUtensorMap& tv, const WindowMap& wm,
                          const bf16* rh, const bf16* rw, bf16* o, int B, int S, int H, int mh,
                          int mw, int D, int q_tiles, int smem, cudaStream_t stream) {
  auto* kernel = relpos_attention_kernel<kRowTiles, kConsumers, kWindowMap, kTables>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q_tiles, H, B);
  kernel<<<grid, block_threads(kConsumers), smem, stream>>>(
      tq, tq_last, tk, tv, wm, rh, rw, o, S, H, mh, mw, D, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace istpu

extern "C" {

// q, k, v: bf16 (B, S, H, D) with the given element strides (D contiguous,
// the others multiples of 8); rel_h, rel_w: contiguous bf16 (2 mh - 1, D)
// and (2 mw - 1, D), 16-byte aligned, D = 64, or both null: no tables,
// D = 56, row tiles only; o: contiguous bf16 (B, S, H, D); S = mh mw. The
// cut is the caller's plan (ops/kernels/relpos_attention.py relpos_plan):
// row_tiles (mw = 64, mh <= 64) or small maps (mh, mw <= 32), `consumers`
// warpgroups of 64 queries a block (kRowConsumers or kSmallConsumers),
// q_tiles blocks and smem bytes of shared memory a block; a plan that does
// not cover the call is refused. Returns a cudaError_t.
int istpu_relpos_attention_bf16(const void* q, const void* k, const void* v, const void* rel_h,
                                const void* rel_w, void* o, int B, int S, int H, int D, int mh,
                                int mw, long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh, long long vsb,
                                long long vss, long long vsh, int row_tiles, int consumers,
                                int q_tiles, int smem, int device, void* stream) {
  using namespace istpu;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool tables = rel_h != nullptr;
  const bool shape_ok =
      row_tiles ? (mw == kRowSide && mh >= 1 && mh <= kRowSide)
                : (tables && mh >= 1 && mw >= 1 && mh <= kMaxSide && mw <= kMaxSide);
  if (tables != (rel_w != nullptr) || D != (tables ? kHeadDim : kPlainHeadDim) || B <= 0 ||
      H <= 0 || S != mh * mw || !shape_ok ||
      consumers != (row_tiles ? kRowConsumers : kSmallConsumers) ||
      q_tiles * kTile * consumers < S ||
      static_cast<size_t>(smem) < smem_bytes(consumers, tables))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if ((err = head_tile_map(&tq, q, B, S, H, qsb, qss, qsh, D)) != cudaSuccess) return err;
  if ((err = head_tile_map(&tk, k, B, S, H, ksb, kss, ksh, D)) != cudaSuccess) return err;
  if ((err = head_tile_map(&tv, v, B, S, H, vsb, vss, vsh, D)) != cudaSuccess) return err;
  const auto* rh = static_cast<const bf16*>(rel_h);
  const auto* rw = static_cast<const bf16*>(rel_w);
  auto* op = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  const WindowMap own = {nullptr, nullptr, mh, mw};  // the output is the call's own map
  if (!tables)
    return launch_relpos<true, kRowConsumers, false, false>(tq, tq, tk, tv, own, rh, rw, op, B,
                                                            S, H, mh, mw, D, q_tiles, smem, s);
  if (row_tiles)
    return launch_relpos<true, kRowConsumers, false, true>(tq, tq, tk, tv, own, rh, rw, op, B, S,
                                                           H, mh, mw, D, q_tiles, smem, s);
  return launch_relpos<false, kSmallConsumers, false, true>(tq, tq, tk, tv, own, rh, rw, op, B,
                                                            S, H, mh, mw, D, q_tiles, smem, s);
}

// The window map: q, k, v bf16 (B, h w, H, D) over an unpadded h x w map
// with the given element strides (D contiguous, the others multiples of
// 8, 16-byte aligned); bias_k, bias_v: contiguous bf16 (H, D), the k and v
// a pad token takes; rel_h, rel_w: contiguous bf16 (2 ws - 1, D), D = 64,
// or both null: no tables, D = 56; o: contiguous bf16 (B, h w, H, D);
// 1 <= ws <= 32. q_tiles must be the blocks an (image, head) needs
// (ops/kernels/relpos_attention.py window_plan; window_map_blocks here).
// Returns a cudaError_t.
int istpu_relpos_window_bf16(const void* q, const void* k, const void* v, const void* bias_k,
                             const void* bias_v, const void* rel_h, const void* rel_w, void* o,
                             int B, int h, int w, int H, int D, int ws, long long qsb,
                             long long qss, long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss, long long vsh,
                             int q_tiles, int smem, int device, void* stream) {
  using namespace istpu;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool tables = rel_h != nullptr;
  if (tables != (rel_w != nullptr) || D != (tables ? kHeadDim : kPlainHeadDim) || B <= 0 ||
      H <= 0 || h <= 0 || w <= 0 || ws <= 0 || ws > kMaxSide ||
      q_tiles != window_map_blocks(h, w, ws) ||
      static_cast<size_t>(smem) < smem_bytes(kSmallConsumers, tables))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tq_last, tk, tv;
  const int rw_last = map_split(h, w, ws).rw_last;
  if ((err = map_row_map(&tq, q, B, h, w, H, qsb, qss, qsh, ws, D)) != cudaSuccess) return err;
  if ((err = map_row_map(&tq_last, q, B, h, w, H, qsb, qss, qsh, rw_last, D)) != cudaSuccess)
    return err;
  if ((err = map_row_map(&tk, k, B, h, w, H, ksb, kss, ksh, ws, D)) != cudaSuccess) return err;
  if ((err = map_row_map(&tv, v, B, h, w, H, vsb, vss, vsh, ws, D)) != cudaSuccess) return err;
  const WindowMap wm = {static_cast<const bf16*>(bias_k), static_cast<const bf16*>(bias_v), h, w};
  const auto* rh = static_cast<const bf16*>(rel_h);
  const auto* rw = static_cast<const bf16*>(rel_w);
  auto* op = static_cast<bf16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (!tables)
    return launch_relpos<false, kSmallConsumers, true, false>(
        tq, tq_last, tk, tv, wm, rh, rw, op, B, ws * ws, H, ws, ws, D, q_tiles, smem, s);
  return launch_relpos<false, kSmallConsumers, true, true>(
      tq, tq_last, tk, tv, wm, rh, rw, op, B, ws * ws, H, ws, ws, D, q_tiles, smem, s);
}

}  // extern "C"
