// The window program's search for Hopper, sm_90a: hit compaction, the exact
// plateau collapse, packet slicing, the CRC-16 and Reed-Solomon gates and
// the same-block duplicate collapse, written straight into the packed result
// buffer (ops/spec.py result_layout).
//
// It replaces no TPU kernel: the JAX package's search is jnp
// (rtlamr_tpu/ops/frontend.py search_slice), and the port ran it as plain
// PyTorch (ops/search.py search_slice, which stays as the CPU path and the
// version this one is held to, byte for byte). On the card that was several
// hundred launches a search, replayed from a CUDA graph, led by cub sorts
// used as compaction and by doubling passes over the whole stream.
//
// What bounds it on the card: neither bytes nor operations. At the live
// cell's spec (all four types, chip length 72, 16-block windows) a search
// reads a 131,072-byte mask and writes a 152,800-byte buffer, some 0.09 us
// at 3.35 TB/s; the candidates are a few hundred. What remains is the cost
// of a launch and of the few dependent steps a candidate needs, so the
// design is a few launches with every step inside them:
//
// - Pass 1 (search_count_kernel, a CTA a tile of 8,192 positions, a thread
//   32 of them): the hit words of each group by one multiply a 4-byte word,
//   each tile's counts (rows with a hit, hit positions, each group's hits and
//   plateau survivors) and, for the look-ahead, each group's first hit at or
//   past its fit. A tile with no hit stops after its counts. The plateau
//   test reads directly: a hit at q of a group that also hits at q - 1 in
//   the same block is dropped when no read of the packet from q - 1 (S reads
//   at the stride) meets an edge (a sample unequal to the next, or the
//   stream's last sample or past it), so the packet from q equals the one
//   from q - 1 (ops/search.py _edge_span_streams). A warp takes 32
//   consecutive candidates at once, so each read of the stream is
//   coalesced, in units of 64 reads spread over the CTA's warps, 16 loads in
//   flight a lane, and stops at the first edge.
// - Pass 2 (search_slice_kernel, a CTA a tile): a tile with hits sums the
//   earlier tiles' counts, so every rank is known without a sort: the rows
//   with a hit (the first gather_rows kept), the hit positions (the first
//   k_any), each group's hits (the first gather_hits) and its plateau
//   survivors (the first slice rows). Each is a prefix in position order, so
//   when a tile includes anything every earlier tile is wholly included and
//   its counts are the ranks' offsets. The tile's survivors are dealt out
//   over the CTA's warps, a warp a survivor at a time (a block-wide scan of
//   each thread's survivors finds the thread and bit of survivor e): a lane
//   a packed byte (8 reads at the stride) and an R900 digit, then a lane a
//   parser's gates (CRC-16 a byte a step, from a 256-entry table of each
//   check built in shared memory; the RS syndromes by table).
// - Pass 3 (search_finish_kernel, a CTA a group): the counts with the
//   overflow rule, the rows past the survivors (the packet at position 0,
//   as the plain version fills them), the duplicate collapse against the
//   previous row, and the look-ahead's guards.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define TILE (THREADS * 32)  // positions a CTA of passes 1 and 2
#define MAX_GROUPS 8
#define MAX_VALIDATORS 16
#define MAX_CRCS 16
#define MAX_RANGES 4
#define MAX_BYTES 128         // packed bytes of a row
#define R900_DIGITS 42
#define RS_SYMBOLS 21
#define M_UNIT 64             // strided reads a unit of the plateau test
#define M_BATCH 16            // of them in flight a lane
#define FULL 0xffffffffu

// Fields of the per-tile counts, each n_tiles ints (ops/search.py
// TILE_FIELDS): written by pass 1 but F_INCL, which pass 2 writes.
#define F_ROWS 0
#define F_POS 1
#define F_BIT 2                             // + group
#define F_KEEP (F_BIT + MAX_GROUPS)         // + group
#define F_GUARD (F_KEEP + MAX_GROUPS)       // + group
#define F_INCL (F_GUARD + MAX_GROUPS)       // + group
#define N_FIELDS (F_INCL + MAX_GROUPS)

// The layout matches ops/search.py _SearchArgs.
struct Group {
  int symbols, nbytes, r900, gated, v0, n_validators, fit;
  int idx_off, keep_off, pvalid_off, bytes_off, syms_off;
};
struct Validator {
  int rs, crc0, n_crcs;
};
struct Crc {
  int init, poly, residue, n_ranges;
  int lo[MAX_RANGES], hi[MAX_RANGES];
};
struct SearchArgs {
  int w;          // positions searched: the mask's rows x 128
  int n_tiles;
  int n_bits;     // bit stream
  int n_q6;       // R900 digit stream, 0 without
  int sl, cl4, base, bs;  // symbol length, R900 digit stride, first digit past a hit, block
  int n_groups, gather_rows, k_any, k_gather, k_slice;
  int max_span;   // longest plateau test
  int guards_off; // byte offset of the (G,) int32 guards, -1: none
  int n_crcs;     // CRC checks in c
  Group g[MAX_GROUPS];
  Validator v[MAX_VALIDATORS];
  Crc c[MAX_CRCS];
};

// 4 bits: bit j set where byte j of x has bit 0 set.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// The lowest n set bits of x.
__device__ __forceinline__ uint32_t lowest_bits(uint32_t x, int n) {
  if (n <= 0) return 0;
  if (n >= __popc(x)) return x;
  uint32_t out = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t b = x & (0u - x);
    out |= b;
    x ^= b;
  }
  return out;
}

__device__ __forceinline__ int clamp32(int x) { return x < 0 ? 0 : (x > 32 ? 32 : x); }

// A thread's 32 positions [q0, q0 + 32): each group's hit word, the word of
// positions with any mask bit, and each group's plateau candidates: a hit
// whose position before holds the group's hit too, in the same block.
template <int NG>
struct Chunk {
  uint32_t bit[NG], cand[NG], hit;
};

template <int NG>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ mask,
                                           const SearchArgs& a, int q0, Chunk<NG>& c) {
  c.hit = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) c.bit[g] = c.cand[g] = 0;
  if (q0 >= a.w) return;
  const uint4 v0 = *reinterpret_cast<const uint4*>(mask + q0);
  const uint4 v1 = *reinterpret_cast<const uint4*>(mask + q0 + 16);
  const uint32_t words[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t any = words[k] | (words[k] >> 4);
    any |= any >> 2;
    any |= any >> 1;
    c.hit |= nibble(any) << (4 * k);
#pragma unroll
    for (int g = 0; g < NG; ++g) c.bit[g] |= nibble(words[k] >> g) << (4 * k);
  }
  const uint32_t prev = q0 > 0 ? mask[q0 - 1] : 0u;
  uint32_t start = 0;  // positions that begin a block (q = 0 among them)
  for (int i = (a.bs - q0 % a.bs) % a.bs; i < 32; i += a.bs) start |= 1u << i;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    c.cand[g] = c.bit[g] & ((c.bit[g] << 1) | ((prev >> g) & 1u)) & ~start;
}

// Whether a read at p + m * stride, m0 <= m < m1, meets an edge (n >= 2).
// A batch's loads are unconditional (clamped into the stream), so all of
// them are in flight at once.
__device__ __forceinline__ bool edge_in(const uint8_t* __restrict__ s, int n, int p, int stride,
                                        int m0, int m1) {
  for (int m = m0; m < m1; m += M_BATCH) {
    bool e = false;
#pragma unroll
    for (int k = 0; k < M_BATCH; ++k) {
      const int x = p + (m + k) * stride;
      const int xc = min(x, n - 2);
      const bool diff = s[xc] != s[xc + 1];
      e |= m + k < m1 && (x >= n - 1 || diff);
    }
    if (e) return true;
  }
  return false;
}

// Sums (and, for k >= n_sum, minimums) of v over the CTA, into out.
template <int N>
__device__ __forceinline__ void block_reduce(int (&v)[N], int n_sum, int (*red)[N], int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int y = __shfl_xor_sync(FULL, v[k], d);
      v[k] = k < n_sum ? v[k] + y : min(v[k], y);
    }
    if (lane == 0) red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int k = threadIdx.x;
    int x = red[0][k];
    for (int i = 1; i < WARPS; ++i) x = k < n_sum ? x + red[i][k] : min(x, red[i][k]);
    out[k] = x;
  }
  __syncthreads();
}

// Exclusive prefix sums of v over the CTA's threads in order.
template <int N>
__device__ __forceinline__ void block_exclusive_scan(int (&v)[N], int (*red)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    inc[k] = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc[k], d);
      if (lane >= d) inc[k] += y;
    }
    if (lane == 31) red[warp][k] = inc[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int off = 0;
    for (int i = 0; i < warp; ++i) off += red[i][k];
    v[k] = inc[k] - v[k] + off;
  }
  __syncthreads();
}

// Each CRC check's byte table, T[x]: the register (x << 8) after 8 MSB-first
// steps of its polynomial.
__device__ __forceinline__ void build_crc_tables(const SearchArgs& a, uint16_t (*tab)[256]) {
  for (int x = threadIdx.x; x < a.n_crcs * 256; x += THREADS) {
    const uint32_t poly = (uint32_t)a.c[x >> 8].poly;
    uint32_t r = (uint32_t)(x & 255) << 8;
#pragma unroll
    for (int s = 0; s < 8; ++s) r = ((r << 1) ^ ((r & 0x8000u) ? poly : 0u)) & 0xFFFFu;
    tab[x >> 8][x & 255] = (uint16_t)r;
  }
}

// One parser's gates on a row: every CRC-16 over its byte ranges (MSB first,
// a byte a table step: crc/crc.go:49-55) at its residue, and the R900 digit
// pairs in range with all five GF(32) syndromes zero (r900/r900.go:199-221),
// read from the (21, 32) table of ops/search.py _r900_rs_tables.
__device__ bool validate(const SearchArgs& a, int vi, const uint8_t* bytes, const uint8_t* syms,
                         const int* __restrict__ rs, const uint16_t (*tab)[256]) {
  const Validator& v = a.v[vi];
  for (int i = 0; i < v.n_crcs; ++i) {
    const Crc& c = a.c[v.crc0 + i];
    const uint16_t* t = tab[v.crc0 + i];
    uint32_t crc = (uint32_t)c.init;
    for (int r = 0; r < c.n_ranges; ++r)
      for (int b = c.lo[r]; b < c.hi[r]; ++b)
        crc = ((crc << 8) ^ t[((crc >> 8) ^ bytes[b]) & 0xFFu]) & 0xFFFFu;
    if (crc != (uint32_t)c.residue) return false;
  }
  if (v.rs) {
    uint32_t syn = 0;
    bool in_range = true;
    for (int i = 0; i < RS_SYMBOLS; ++i) {
      const int s = (int)syms[2 * i] * 6 + (int)syms[2 * i + 1];
      in_range &= s <= 31;
      syn ^= (uint32_t)rs[i * 32 + (s & 31)];
    }
    if (!in_range || syn != 0) return false;
  }
  return true;
}

// A warp's slice of group g's packet at q into buf: the MSB-first packed
// bytes at stride SL (decode.go:353-375), the stray low bits of a partial
// last byte cleared, and at buf + MAX_BYTES the R900 digits at stride 4 CL
// from q + PreambleLength - SymbolLength (r900/r900.go:187-193); zeros past
// each stream's end. Returns the parsers' validity bits (0 ungated).
__device__ uint32_t gather_row(const SearchArgs& a, const uint8_t* __restrict__ bits,
                               const uint8_t* __restrict__ q6, const int* __restrict__ rs,
                               const uint16_t (*tab)[256], int q, int g, int lane, uint8_t* buf) {
  const Group& gr = a.g[g];
  for (int b = lane; b < gr.nbytes; b += 32) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = q + (8 * b + k) * a.sl;
      v |= ((x < a.n_bits ? (uint32_t)bits[x] : 0u) << (7 - k)) & 0xFFu;
    }
    if (b == gr.nbytes - 1) v &= (0xFFu << (8 * gr.nbytes - gr.symbols)) & 0xFFu;
    buf[b] = (uint8_t)v;
  }
  if (gr.r900)
    for (int j = lane; j < R900_DIGITS; j += 32) {
      const int x = q + a.base + j * a.cl4;
      buf[MAX_BYTES + j] = x < a.n_q6 ? q6[x] : 0;
    }
  __syncwarp();
  const bool ok = gr.gated && lane < gr.n_validators &&
                  validate(a, gr.v0 + lane, buf, buf + MAX_BYTES, rs, tab);
  return __ballot_sync(FULL, ok);
}

template <int NG>
__global__ void __launch_bounds__(THREADS)
search_count_kernel(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ bits,
                    const uint8_t* __restrict__ q6, int* __restrict__ tiles,
                    uint32_t* __restrict__ dropw, const __grid_constant__ SearchArgs a) {
  constexpr int NV = 2 + 3 * NG;  // rows, positions, hits, survivors (sums); guards (mins)
  __shared__ int n_items;
  __shared__ uint32_t items[THREADS * NG], cands[THREADS * NG], edges[THREADS * NG];
  __shared__ int red[WARPS][NV];
  __shared__ int tot[NV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = blockIdx.x;
  const int nt = a.n_tiles;
  const int q0 = t * TILE + tid * 32;
  Chunk<NG> c;
  load_chunk<NG>(mask, a, q0, c);
  if (!__syncthreads_or(c.hit != 0)) {
    if (tid < F_INCL) tiles[tid * nt + t] = tid >= F_GUARD ? a.w : 0;
    return;
  }
  if (tid == 0) n_items = 0;
  __syncthreads();
  int item[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    item[g] = -1;
    if (c.cand[g]) {
      item[g] = atomicAdd(&n_items, 1);
      items[item[g]] = (uint32_t)(tid * MAX_GROUPS + g);
      cands[item[g]] = c.cand[g];
      edges[item[g]] = 0;
    }
  }
  __syncthreads();
  // The plateau tests, a lane a candidate of the item's 32 positions.
  const int per_item = (a.max_span + M_UNIT - 1) / M_UNIT;
  const int units = n_items * per_item;
  for (int u = warp; u < units; u += WARPS) {
    const int it = u / per_item, m0 = (u % per_item) * M_UNIT;
    const int owner = items[it] / MAX_GROUPS, g = items[it] % MAX_GROUPS;
    const Group& gr = a.g[g];
    const int span = gr.r900 ? R900_DIGITS : gr.symbols;
    if (m0 >= span) continue;  // the same for the whole warp
    const int m1 = min(span, m0 + M_UNIT);
    const int p = t * TILE + owner * 32 + lane - 1;
    bool e = false;
    if ((cands[it] >> lane) & 1u)
      e = gr.r900 ? edge_in(q6, a.n_q6, p + a.base, a.cl4, m0, m1)
                  : edge_in(bits, a.n_bits, p, a.sl, m0, m1);
    const uint32_t found = __ballot_sync(FULL, e);
    if (lane == 0 && found) atomicOr(&edges[it], found);
  }
  __syncthreads();
  int v[NV];
  uint32_t rowhit = c.hit;
  rowhit |= __shfl_xor_sync(FULL, rowhit, 1);
  rowhit |= __shfl_xor_sync(FULL, rowhit, 2);
  v[0] = (lane & 3) == 0 && rowhit != 0;
  v[1] = __popc(c.hit);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const uint32_t drop = item[g] >= 0 ? c.cand[g] & ~edges[item[g]] : 0u;
    if (c.cand[g]) dropw[(size_t)g * nt * THREADS + (size_t)t * THREADS + tid] = drop;
    v[2 + g] = __popc(c.bit[g]);
    v[2 + NG + g] = __popc(c.bit[g] & ~drop);
    const int fit = a.g[g].fit - q0;
    const uint32_t past = fit <= 0 ? FULL : (fit >= 32 ? 0u : ~((1u << fit) - 1u));
    const uint32_t at = c.bit[g] & past;
    v[2 + 2 * NG + g] = at ? q0 + __ffs(at) - 1 : a.w;
  }
  block_reduce<NV>(v, 2 + 2 * NG, red, tot);
  if (tid < N_FIELDS) {
    int x = 0;
    if (tid == F_ROWS) x = tot[0];
    else if (tid == F_POS) x = tot[1];
    else if (tid < F_KEEP) x = tid - F_BIT < NG ? tot[2 + tid - F_BIT] : 0;
    else if (tid < F_GUARD) x = tid - F_KEEP < NG ? tot[2 + NG + tid - F_KEEP] : 0;
    else if (tid < F_INCL) x = tid - F_GUARD < NG ? tot[2 + 2 * NG + tid - F_GUARD] : a.w;
    if (tid < F_INCL) tiles[tid * nt + t] = x;
  }
}

template <int NG>
__global__ void __launch_bounds__(THREADS)
search_slice_kernel(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ bits,
                    const uint8_t* __restrict__ q6, int* __restrict__ tiles,
                    const uint32_t* __restrict__ dropw, uint8_t* __restrict__ out,
                    const int* __restrict__ rs, const __grid_constant__ SearchArgs a) {
  constexpr int NV = 2 + 2 * NG;  // rows, positions, hits, survivors
  __shared__ int red[WARPS][NV];
  __shared__ int base[NV];
  __shared__ int red_incl[WARPS][NG];
  __shared__ uint32_t s_emit[NG][THREADS], s_listed[NG][THREADS];
  __shared__ int s_r0[NG][THREADS];
  __shared__ int s_off[THREADS + 1];
  __shared__ int red1[WARPS][1];
  __shared__ uint16_t crc_tab[MAX_CRCS][256];
  __shared__ __align__(16) uint8_t wbuf[WARPS][MAX_BYTES + 64];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = blockIdx.x;
  const int nt = a.n_tiles;
  if (tiles[F_POS * nt + t] == 0) {
    if (tid < NG) tiles[(F_INCL + tid) * nt + t] = 0;
    return;
  }
  // Ranks' offsets: the earlier tiles' counts.
  int v[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0;
  for (int u = tid; u < t; u += THREADS) {
    v[0] += tiles[F_ROWS * nt + u];
    v[1] += tiles[F_POS * nt + u];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      v[2 + g] += tiles[(F_BIT + g) * nt + u];
      v[2 + NG + g] += tiles[(F_KEEP + g) * nt + u];
    }
  }
  block_reduce<NV>(v, NV, red, base);
  if (base[0] >= a.gather_rows || base[1] >= a.k_any) {
    if (tid < NG) tiles[(F_INCL + tid) * nt + t] = 0;
    return;
  }
  const int q0 = t * TILE + tid * 32;
  Chunk<NG> c;
  load_chunk<NG>(mask, a, q0, c);
  uint32_t keep[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g)
    keep[g] = c.bit[g] &
              ~(c.cand[g] ? dropw[(size_t)g * nt * THREADS + (size_t)t * THREADS + tid] : 0u);
  uint32_t rowhit = c.hit;
  rowhit |= __shfl_xor_sync(FULL, rowhit, 1);
  rowhit |= __shfl_xor_sync(FULL, rowhit, 2);
  v[0] = (lane & 3) == 0 && rowhit != 0;
  v[1] = __popc(c.hit);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    v[2 + g] = __popc(c.bit[g]);
    v[2 + NG + g] = __popc(keep[g]);
  }
  block_exclusive_scan<NV>(v, red);
  // A row's rank: the rows with a hit before it (its first thread's prefix).
  const int row_rank = base[0] + __shfl_sync(FULL, v[0], lane & ~3);
  uint32_t incl = 0;
  if (row_rank < a.gather_rows) incl = lowest_bits(c.hit, clamp32(a.k_any - base[1] - v[1]));
  uint32_t listed[NG], emit[NG];
  int r0[NG], inc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    listed[g] = lowest_bits(c.bit[g] & incl, clamp32(a.k_gather - base[2 + g] - v[2 + g])) &
                keep[g];
    r0[g] = base[2 + NG + g] + v[2 + NG + g];
    emit[g] = lowest_bits(listed[g], clamp32(a.k_slice - r0[g]));
    inc[g] = __popc(listed[g]);
  }
  // Slice each survivor, spread over the warps: survivor e of the tile (in
  // thread order) belongs to the last thread whose offset is at most e.
  int n_emit[1] = {0};
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    s_emit[g][tid] = emit[g];
    s_listed[g][tid] = listed[g];
    s_r0[g][tid] = r0[g];
    n_emit[0] += __popc(emit[g]);
  }
  const int mine = n_emit[0];
  block_exclusive_scan<1>(n_emit, red1);
  s_off[tid] = n_emit[0];
  if (tid == THREADS - 1) s_off[THREADS] = n_emit[0] + mine;
  build_crc_tables(a, crc_tab);
  __syncthreads();
  uint8_t* buf = wbuf[warp];
  for (int e = warp; e < s_off[THREADS]; e += WARPS) {
    int lo = 0, hi = THREADS - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= e) lo = mid; else hi = mid - 1;
    }
    int k = e - s_off[lo], g = 0;
    uint32_t word = 0;
    for (int gg = 0; gg < NG; ++gg) {
      const int n = __popc(s_emit[gg][lo]);
      if (k < n) {
        g = gg;
        word = s_emit[gg][lo];
        break;
      }
      k -= n;
    }
    for (; k > 0; --k) word &= word - 1u;
    const int i = __ffs(word) - 1;
    const int q = t * TILE + lo * 32 + i;
    const int r = s_r0[g][lo] + __popc(s_listed[g][lo] & ((1u << i) - 1u));
    const uint32_t pv = gather_row(a, bits, q6, rs, crc_tab, q, g, lane, buf);
    const Group& gr = a.g[g];
    for (int b = lane; b < gr.nbytes; b += 32) out[gr.bytes_off + r * gr.nbytes + b] = buf[b];
    if (gr.r900)
      for (int j = lane; j < R900_DIGITS; j += 32)
        out[gr.syms_off + r * R900_DIGITS + j] = buf[MAX_BYTES + j];
    if (lane == 0) {
      *reinterpret_cast<int*>(out + gr.idx_off + 4 * r) = q;
      out[gr.pvalid_off + r] = (uint8_t)(pv & 0xFFu);
    }
    __syncwarp();
  }
  // What this tile adds to each group's list of survivors.
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int x = inc[g];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
    if (lane == 0) red_incl[warp][g] = x;
  }
  __syncthreads();
  if (tid < NG) {
    int x = 0;
    for (int i = 0; i < WARPS; ++i) x += red_incl[i][tid];
    tiles[(F_INCL + tid) * nt + t] = x;
  }
}

__global__ void __launch_bounds__(THREADS)
search_finish_kernel(const uint8_t* __restrict__ bits, const uint8_t* __restrict__ q6,
                     const int* __restrict__ tiles, uint8_t* __restrict__ out,
                     const int* __restrict__ rs, const __grid_constant__ SearchArgs a) {
  __shared__ int red[WARPS][6];
  __shared__ int tot[6];
  __shared__ __align__(16) uint8_t fill[MAX_BYTES + 64];
  __shared__ uint32_t fill_pv;
  __shared__ uint16_t crc_tab[MAX_CRCS][256];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = blockIdx.x;
  const int nt = a.n_tiles;
  const Group& gr = a.g[g];
  int v[6] = {0, 0, 0, 0, 0, a.w};  // rows, positions, hits, survivors listed, kept; guard
  for (int u = tid; u < nt; u += THREADS) {
    v[0] += tiles[F_ROWS * nt + u];
    v[1] += tiles[F_POS * nt + u];
    v[2] += tiles[(F_BIT + g) * nt + u];
    v[3] += tiles[(F_INCL + g) * nt + u];
    v[5] = min(v[5], tiles[(F_GUARD + g) * nt + u]);
  }
  block_reduce<6>(v, 5, red, tot);
  const int rows = tot[0], positions = tot[1], hits = tot[2], listed = tot[3], guard = tot[5];
  const int s = min(a.k_slice, listed);
  const int k = a.k_slice;
  // Rows past the survivors hold the packet at position 0.
  build_crc_tables(a, crc_tab);
  __syncthreads();
  if (s < k && warp == 0) {
    const uint32_t pv = gather_row(a, bits, q6, rs, crc_tab, 0, g, lane, fill);
    if (lane == 0) fill_pv = pv & 0xFFu;
  }
  __syncthreads();
  for (int j = s + tid; j < k; j += THREADS) {
    *reinterpret_cast<int*>(out + gr.idx_off + 4 * j) = a.w;
    out[gr.keep_off + j] = 0;
    out[gr.pvalid_off + j] = (uint8_t)fill_pv;
  }
  for (int e = s * gr.nbytes + tid; e < k * gr.nbytes; e += THREADS)
    out[gr.bytes_off + e] = fill[e % gr.nbytes];
  if (gr.r900)
    for (int e = s * R900_DIGITS + tid; e < k * R900_DIGITS; e += THREADS)
      out[gr.syms_off + e] = fill[MAX_BYTES + e % R900_DIGITS];
  // A survivor is kept when it passes a parser's gates and its content
  // differs from the previous row's, or that lies in another block.
  int kept = 0;
  const int len = gr.r900 ? R900_DIGITS : gr.nbytes;
  const int key_off = gr.r900 ? gr.syms_off : gr.bytes_off;
  for (int j = tid; j < s; j += THREADS) {
    bool ok = !gr.gated || out[gr.pvalid_off + j] != 0;
    if (ok && j > 0) {
      const int qa = *reinterpret_cast<const int*>(out + gr.idx_off + 4 * j);
      const int qb = *reinterpret_cast<const int*>(out + gr.idx_off + 4 * (j - 1));
      if (qa / a.bs == qb / a.bs) {
        const uint8_t* ra = out + key_off + j * len;
        bool same = true;
        for (int b = 0; b < len && same; ++b) same = ra[b] == ra[b - len];
        ok = !same;
      }
    }
    out[gr.keep_off + j] = ok;
    kept += ok;
  }
  int kv[6] = {kept, 0, 0, 0, 0, 0};
  block_reduce<6>(kv, 6, red, tot);
  if (tid == 0) {
    const bool over = rows > a.gather_rows || positions > a.k_any || listed > a.k_slice;
    int* counts = reinterpret_cast<int*>(out) + 2 * g;
    counts[0] = over ? a.k_gather + 1 : hits;
    counts[1] = tot[0];
    if (a.guards_off >= 0)  // (G,) int32 little-endian at a byte offset
      for (int b = 0; b < 4; ++b) out[a.guards_off + 4 * g + b] = (uint8_t)(guard >> (8 * b));
  }
}

template <int NG>
static int launch(const void* mask, const void* bits, const void* q6, void* tiles, void* dropw,
                  void* out, const void* rs, const SearchArgs& a, cudaStream_t stream) {
  search_count_kernel<NG><<<a.n_tiles, THREADS, 0, stream>>>(
      (const uint8_t*)mask, (const uint8_t*)bits, (const uint8_t*)q6, (int*)tiles,
      (uint32_t*)dropw, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  search_slice_kernel<NG><<<a.n_tiles, THREADS, 0, stream>>>(
      (const uint8_t*)mask, (const uint8_t*)bits, (const uint8_t*)q6, (int*)tiles,
      (const uint32_t*)dropw, (uint8_t*)out, (const int*)rs, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  search_finish_kernel<<<a.n_groups, THREADS, 0, stream>>>(
      (const uint8_t*)bits, (const uint8_t*)q6, (const int*)tiles, (uint8_t*)out,
      (const int*)rs, a);
  return (int)cudaGetLastError();
}

// Launch the search's three kernels on `stream`. `mask` is the (w/128, 128)
// preamble mask (16-byte aligned), `bits` and `q6` the streams (q6 NULL
// when no group wants R900 digits), `tiles` N_FIELDS x n_tiles ints and
// `dropw` n_groups x n_tiles x THREADS words of scratch, `out` the packed
// buffer (4-byte aligned), `rs` the (21, 32) int32 syndrome table. Returns 0
// or a CUDA error code: cudaErrorInvalidValue for arguments the kernels do
// not take, else that of a launch. `args` is a host struct, read before
// the call returns.
extern "C" int rtlamr_search(const void* mask, const void* bits, const void* q6, void* tiles,
                             void* dropw, void* out, const void* rs, const SearchArgs* args,
                             void* stream) {
  const SearchArgs a = *args;
  bool ok = a.n_groups >= 1 && a.n_groups <= MAX_GROUPS && a.w > 0 && a.w % 128 == 0 &&
            a.n_tiles == (a.w + TILE - 1) / TILE && a.w <= a.n_bits && a.sl > 0 && a.bs > 0 &&
            a.k_slice >= 0 && a.k_slice <= a.k_gather && a.max_span > 0 &&
            a.n_crcs >= 0 && a.n_crcs <= MAX_CRCS && a.n_q6 != 1 &&
            ((uintptr_t)mask & 15) == 0 && ((uintptr_t)out & 3) == 0 && rs != nullptr;
  for (int g = 0; ok && g < a.n_groups; ++g) {
    const Group& gr = a.g[g];
    ok = gr.nbytes >= 1 && gr.nbytes <= MAX_BYTES && gr.symbols <= 8 * gr.nbytes &&
         gr.symbols > 8 * (gr.nbytes - 1) && (!gr.r900 || (q6 != nullptr && a.n_q6 > 0)) &&
         (!gr.gated || (gr.v0 >= 0 && gr.n_validators <= 8 &&
                        gr.v0 + gr.n_validators <= MAX_VALIDATORS)) &&
         gr.idx_off % 4 == 0;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.n_groups) {
    case 1: return launch<1>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 2: return launch<2>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 3: return launch<3>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 4: return launch<4>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 5: return launch<5>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 6: return launch<6>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    case 7: return launch<7>(mask, bits, q6, tiles, dropw, out, rs, a, s);
    default: return launch<8>(mask, bits, q6, tiles, dropw, out, rs, a, s);
  }
}
