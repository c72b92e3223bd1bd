// Fused decode stencil (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel rtlamr_tpu/ops/pallas_frontend.py::_kernel (the
// Pallas body called through frontend_pallas_staged). One pass over the
// staged u16 window computes, per search position q:
//
//   mag[s]   = (255 - 2 I)^2 + (255 - 2 Q)^2 of staged sample s (I low byte),
//              zeroed below halo_staged on the stream's first window
//   W(x)     = sum mag[x .. x + CL)                       (chip energy)
//   bits[q]  = W(q + ps) - W(q + ps + CL) >= 0            (Manchester bit),
//              forced to 0 for q < PacketLength on the first window
//   mask[q]  = bit g set iff bits[q + k SL] == preamble_g[k] for every k,
//              for q < window                             (preamble bank)
//   q6[q]    = R900 6-ary symbol from d_i = W(q + ps + SL + i CL), i < 4:
//              a0 = (d0 + d1) - (d2 + d3), a1 = d0 - d1 + d2 - d3,
//              a2 = d0 - d1 - d2 + d3; arg = strict-> argmax of |a|;
//              q6 = arg + 3 (a_arg > 0)                   (R900 bank)
//
// What bounds it on the card: bytes and integer operations about equally.
// At the all-protocol spec (CL 72, window_blocks 1024) a window reads
// 8,525,824 u16 (17.1 MB) and writes bits (8.49 MB) + q6 (8.49 MB) + mask
// (8.39 MB), so 42.4 MB, 12.7 us at 3.35 TB/s. Its 32-bit integer work,
// counted in the cheapest form shown (chip_smoke.py stencil_work: 2 a sample
// for magnitude and sum, 3 a bit, 19 an R900 symbol, the packed bank as the
// data needs it), is about 24.5 operations a position, some 208 M; on 16
// INT32 lanes per SM partition, 64 results per clock per SM, 132 SMs at
// 1.98 GHz give 16.7 T/s, so about 12.4 us.
//
// Design, for that bound (measured on an H100 by chip_smoke.py; PERF.md):
// - Persistent strips. The grid is two CTAs per SM (264 on an H100); each
//   owns one contiguous strip of positions (ops/stencil.py stencil_plan) and
//   walks it in steps of SUB_TILE staged samples, carrying the running
//   uint32 prefix sum in a register and the last prefix values and packed
//   bit words in shared memory. Only the strip's right halo (d_mask, about
//   4.9 K positions at CL 72) is loaded twice; a warp skips bits and R900
//   symbols that no output of its strip needs.
// - Asynchronous input. Each thread brings 16 bytes of a sub-tile with
//   cp.async into a 3-slot ring, two sub-tiles ahead of the one it scans; the
//   strip's start is rounded down to 16 bytes and the stencil offsets carry
//   the remainder (`shift`).
// - Few instructions a sample. (255 - 2x)^2 = 65025 - 4 x (255 - x), so a
//   sample's magnitude is 130050 - 4 dp4a(its I and Q bytes, their
//   complements): one __dp4a and one multiply-add into the running sum. Every
//   filter weighs two equally long windows with opposite signs, so the
//   constant 130050 cancels and the sum runs over mag - 130050 (a zeroed
//   first-window sample adds -130050). The scan is in registers, 8
//   consecutive samples a thread (one 16-byte shared load), then a warp
//   shuffle scan and a cross-warp shuffle scan of the warp totals. Every
//   filter output is a difference of prefix values whose true value fits in
//   int32 (|f| <= 96 * 130050), so uint32 wrap-around, which the carried
//   prefix reaches within a strip, cancels exactly. The prefix buffer is
//   linear (the step's samples behind a carried lookback), so each stencil
//   read is a base register plus an immediate offset, and the bit and the
//   R900 symbol of a position share their seven prefix reads.
// - Bits 32 to a word by __ballot_sync, kept packed. The preamble bank reads,
//   for symbol k, the 32-position word at offset k SL with two loads and a
//   funnel shift, shares it across groups, and ANDs it with each group's
//   flip mask for k (a shared table) into one accumulator per group: no
//   data-dependent branch and no per-position byte load. Groups come longest
//   first and their count is a template argument, so no test of a group's
//   length or existence runs per symbol. The k of a step's 128 words are
//   split four ways over all 16 warps and the partial accumulators meet by
//   shared-memory atomicAnd.
// - Each output byte is written once, 16 bytes a thread where a whole
//   vector lies inside the output, byte by byte at the ragged ends; the
//   mask's transposition and the bits and q6 stores share one phase.
// Each step emits bits and q6 d_bits, and mask d_mask, positions behind the
// newest sample it scanned, so everything a position reads has arrived.

#include <cuda_runtime.h>
#include <stdint.h>

#define SUB_TILE 4096                     // staged samples (and positions) a step
#define THREADS 512
#define CTAS_PER_SM 2
#define STAGES 3                          // input ring slots
#define WARPS (THREADS / 32)
#define PER_THREAD (SUB_TILE / THREADS)   // 8 samples: one 16-byte load
#define WORDS (SUB_TILE / 32)             // bit words a step
#define K_SPLIT (THREADS * 32 / SUB_TILE)  // warps sharing a mask word: 4
#define CHUNKS (SUB_TILE / 16)            // 16-byte output vectors a step
#define MAX_GROUPS 8
#define SMEM_CAP (113 * 1024)             // two CTAs per SM

// Scalar arguments; the layout matches ops/stencil.py _Args.
struct StencilArgs {
  int n_staged, lp, lq, window, cl, sl, ps, halo_staged, packet_length;
  int sub_tile, n_strips, strip_len, n_steps, shift, d_bits, d_mask;
  int lookback, bit_words, n_groups, max_len;
  // Groups longest first: length, symbols (bit k = symbol k), and the bit
  // of the mask byte that is the group's.
  int pre_len[MAX_GROUPS];
  unsigned long long pre_bits[MAX_GROUPS];
  int order[MAX_GROUPS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Low 4 bits of x -> 4 bytes of 0 or 1.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

// Store the 16 bytes of v at out[i .. i + 16), only the bytes with
// 0 <= i + b < end; one vector store when all of them are.
__device__ __forceinline__ void store16(uint8_t* out, int i, int end, uint4 v) {
  if (i >= 0 && i + 16 <= end) {
    *reinterpret_cast<uint4*>(out + i) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (i + b >= 0 && i + b < end) out[i + b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

// The preamble bank's table: flip[k][g] is 0 where group g's preamble
// symbol k is 1 (or g >= NG), all ones where it is 0, so that a word of bits
// XOR flip[k][g] has a 1 at each position whose bit k SL on matches.
template <int NG>
__device__ __forceinline__ void fill_flip(uint32_t (*flip)[MAX_GROUPS], const StencilArgs& a,
                                          int tid, int threads) {
  for (int x = tid; x < 64 * MAX_GROUPS; x += threads) {
    const int k = x / MAX_GROUPS, g = x % MAX_GROUPS;
    flip[k][g] = g < NG && !((a.pre_bits[g] >> k) & 1ull) ? 0xffffffffu : 0u;
  }
}

// Bits and R900 symbols of a warp's 256 positions, from e_n = I[j - 1 + n CL]
// (p0: lane's e_0 for the first 32, j = i + shift, P[j] = I[j - 1],
// SL = 2 CL): f = 2 P[j + CL] - P[j] - P[j + SL] = 2 e1 - e0 - e2, packed 32
// to a word into words[]; R900: d_m = W(j + SL + m CL) = e_{m+3} - e_{m+2},
// the symbol into row[]. `above` is the lane's position minus the first
// position whose bit is not forced to 0.
template <bool R900>
__device__ __forceinline__ void bits_and_r900(const uint32_t* p0, int cl, int above, int lane,
                                              uint32_t* words, uint8_t* row) {
#pragma unroll
  for (int r = 0; r < WORDS / WARPS; ++r) {
    const uint32_t* p = p0 + 32 * r;
    const uint32_t e0 = p[0], e1 = p[cl], e2 = p[2 * cl];
    const uint32_t f = 2u * e1 - e0 - e2;
    const uint32_t word = __ballot_sync(0xffffffffu, (int32_t)f >= 0 && above + 32 * r >= 0);
    if (lane == 0) words[r] = word;
    if (R900) {
      const uint32_t e3 = p[3 * cl], e4 = p[4 * cl], e5 = p[5 * cl], e6 = p[6 * cl];
      const int32_t s = (int32_t)(e2 + e6);
      const int32_t a0 = (int32_t)(2u * e4) - s;               // (d0 + d1) - (d2 + d3)
      const int32_t a1 = (int32_t)(2u * (e3 - e4 + e5)) - s;   // d0 - d1 + d2 - d3
      const int32_t a2 = (int32_t)(2u * (e3 - e5) + e6 - e2);  // d0 - d1 - d2 + d3
      const int32_t m0 = abs(a0), m1 = abs(a1), m2 = abs(a2);
      const bool p1 = m1 > m0, p2 = m2 > max(m0, m1);
      const int32_t chosen = p2 ? a2 : (p1 ? a1 : a0);
      row[32 * r] = (uint8_t)((p2 ? 2 : (p1 ? 1 : 0)) + (chosen > 0 ? 3 : 0));
    }
  }
}

// NG: the number of preamble groups, fixed so that no dead group costs an
// instruction.
template <int NG>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
decode_stencil_kernel(const uint16_t* __restrict__ staged, uint8_t* __restrict__ bits,
                      uint8_t* __restrict__ q6, uint8_t* __restrict__ mask, int first,
                      const StencilArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(16) uint32_t wsum[WARPS];
  // flip[k][g]: 0 where group g's preamble symbol k is 1, all ones where 0.
  __shared__ __align__(16) uint32_t flip[64][MAX_GROUPS];
  const int lb = a.lookback;
  // I[j] (inclusive prefix of mag - 130050 over local samples) of samples
  // [t SUB_TILE - lb, (t + 1) SUB_TILE) at j - t SUB_TILE + lb.
  uint32_t* pre = smem;
  uint32_t* macc = pre + SUB_TILE + lb;  // [group][word] mask accumulators
  uint16_t* in = reinterpret_cast<uint16_t*>(macc + MAX_GROUPS * WORDS);
  uint8_t* q6s = reinterpret_cast<uint8_t*>(in + STAGES * SUB_TILE);  // a step's q6
  // Bit words of positions from t SUB_TILE - d_mask on.
  uint32_t* bw = reinterpret_cast<uint32_t*>(q6s + SUB_TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int keep = (a.d_mask - a.d_bits) >> 5;  // bit words carried to the next step
  const int q0 = blockIdx.x * a.strip_len;     // the strip's first position
  // Staged index of local sample 0; local position i reads from sample i + shift.
  const int base = q0 + a.ps - a.shift;
  const int bits_end = min(a.strip_len, a.lp - q0);  // local ends of the outputs
  const int q6_end = min(a.strip_len, a.lq - q0);
  const int mask_end = min(a.strip_len, a.window - q0);
  // Bits the bank reads reach d_mask - d_bits past the strip; a step skips
  // bits, q6 and magnitudes that no output of the strip needs.
  const int bits_need = min(a.strip_len + a.d_mask - a.d_bits, a.lp - q0);
  const int samples_need = bits_need + a.d_bits;
  const int zero_samples = first ? a.halo_staged - base : 0;  // mag 0 below
  const int zero_bits = first ? a.packet_length - q0 : -(1 << 30);  // bit 0 below

  auto issue = [&](int t) {  // sub-tile t into input slot t % STAGES
    const int s = base + t * SUB_TILE + PER_THREAD * tid;  // n_staged % 8 == 0
    const bool live = s < a.n_staged;
    cp_async16(in + (t % STAGES) * SUB_TILE + PER_THREAD * tid, live ? staged + s : staged,
               live ? 16 : 0);
  };

  if (tid == 0) pre[lb - 1] = 0;  // I[-1]
  fill_flip<NG>(flip, a, tid, THREADS);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < a.n_steps) issue(t);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  uint32_t carry = 0;  // I of the last sample of the previous step
  for (int t = 0; t < a.n_steps; ++t) {
    if (t + STAGES - 1 < a.n_steps) issue(t + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncthreads();  // sub-tile t has landed; step t - 1 is done

    // Carry the lookback prefix values (disjoint ranges) and read the bit
    // words to carry (written after the next barrier: the ranges overlap).
    uint32_t carried_word = 0;
    if (t > 0) {
      if (tid < lb / 4)
        reinterpret_cast<uint4*>(pre)[tid] = reinterpret_cast<const uint4*>(pre + SUB_TILE)[tid];
      if (tid < keep) carried_word = bw[WORDS + tid];
    }
    for (int x = tid; x < NG * WORDS; x += THREADS) macc[x] = 0xffffffffu;

    // A. mag - 130050 = -4 (I (255 - I) + Q (255 - Q)) and its prefix.
    const int j0 = t * SUB_TILE + PER_THREAD * tid;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(in + (t % STAGES) * SUB_TILE + PER_THREAD * tid);
    const uint32_t pair[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t run = 0, sums[PER_THREAD];
    if (j0 >= samples_need) {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) sums[k] = 0;
    } else if (j0 >= zero_samples) {
#pragma unroll
      for (int p = 0; p < PER_THREAD / 2; ++p) {
        const uint32_t nv = ~pair[p];
        run -= 4u * __dp4a(pair[p] & 0xffffu, nv, 0u);
        sums[2 * p] = run;
        run -= 4u * __dp4a(pair[p] & 0xffff0000u, nv, 0u);
        sums[2 * p + 1] = run;
      }
    } else {  // the first window's zeroed history: mag 0
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const uint32_t v = pair[k >> 1];
        const uint32_t sel = (k & 1) ? 0xffff0000u : 0xffffu;
        run -= j0 + k < zero_samples ? 130050u : 4u * __dp4a(v & sel, ~v, 0u);
        sums[k] = run;
      }
    }
    uint32_t x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (tid < keep) bw[tid] = carried_word;
    uint32_t ws = lane < WARPS ? wsum[lane] : 0u;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    const uint32_t below = __shfl_sync(0xffffffffu, ws, (warp + 31) & 31);
    const uint32_t before = carry + (warp > 0 ? below : 0u) + (x - run);
    carry += __shfl_sync(0xffffffffu, ws, WARPS - 1);
    uint4* dst = reinterpret_cast<uint4*>(pre + lb + PER_THREAD * tid);
    dst[0] = make_uint4(sums[0] + before, sums[1] + before, sums[2] + before, sums[3] + before);
    dst[1] = make_uint4(sums[4] + before, sums[5] + before, sums[6] + before, sums[7] + before);
    __syncthreads();

    // B. Manchester bits and the R900 bank, d_bits behind the scan. A warp
    // skips its 256 positions when no output of the strip needs them.
    {
      const int i0 = t * SUB_TILE - a.d_bits + (SUB_TILE / WARPS) * warp;  // the warp's first
      if (i0 + SUB_TILE / WARPS > 0 && i0 < bits_need) {
        const uint32_t* p0 = pre + lb - a.d_bits + a.shift - 1 + (SUB_TILE / WARPS) * warp + lane;
        uint32_t* words = bw + keep + (WORDS / WARPS) * warp;
        uint8_t* row = q6s + (SUB_TILE / WARPS) * warp + lane;
        if (q6 != nullptr && i0 < q6_end)
          bits_and_r900<true>(p0, a.cl, i0 + lane - zero_bits, lane, words, row);
        else
          bits_and_r900<false>(p0, a.cl, i0 + lane - zero_bits, lane, words, row);
      }
    }
    __syncthreads();

    // C1. Preamble bank, d_mask behind: word (warp % 4) * 32 + lane, the
    // symbols k with k % K_SPLIT = warp / 4; partial accumulators meet in
    // macc. Groups come longest first, so while k is below the length of
    // group `live - 1` exactly groups 0 .. live - 1 are live, a number fixed
    // at compile time in each unrolled copy of the loop.
    {
      const int word = ((warp % (WORDS / 32)) << 5) | lane;
      const int i0 = t * SUB_TILE - a.d_mask + 32 * word;
      if (i0 + 32 > 0 && i0 < mask_end) {
        uint32_t acc[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g] = 0xffffffffu;
        int k = warp / (WORDS / 32);
#pragma unroll
        for (int live = NG; live >= 1; --live) {
#pragma unroll 4
          for (; k < a.pre_len[live - 1]; k += K_SPLIT) {
            const int off = k * a.sl;
            const uint32_t* wp = bw + word + (off >> 5);
            const uint32_t w = __funnelshift_r(wp[0], wp[1], (uint32_t)off & 31u);
            uint32_t f[8];
            const uint4 f0 = *reinterpret_cast<const uint4*>(flip[k]);
            f[0] = f0.x, f[1] = f0.y, f[2] = f0.z, f[3] = f0.w;
            if constexpr (NG > 4) {
              const uint4 f1 = *reinterpret_cast<const uint4*>(flip[k] + 4);
              f[4] = f1.x, f[5] = f1.y, f[6] = f1.z, f[7] = f1.w;
            }
#pragma unroll
            for (int g = 0; g < live; ++g) acc[g] &= w ^ f[g];
          }
        }
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (acc[g] != 0xffffffffu) atomicAnd(&macc[g * WORDS + word], acc[g]);
      }
    }
    __syncthreads();

    // C2. The mask bytes of this step, 16 positions a thread, beside the
    // bits and q6 of this step.
    if (tid < CHUNKS) {
      const int i = t * SUB_TILE - a.d_mask + 16 * tid;
      if (i + 16 > 0 && i < mask_end) {
        uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const uint32_t m = macc[g * WORDS + (tid >> 1)] >> (16 * (tid & 1));
#pragma unroll
          for (int n = 0; n < 4; ++n) out[n] |= spread4(m >> (4 * n)) << a.order[g];
        }
        store16(mask + q0, i, mask_end, make_uint4(out[0], out[1], out[2], out[3]));
      }
    } else {
      const int c = tid - CHUNKS;  // one 16-byte vector of bits and one of q6
      const int i = t * SUB_TILE - a.d_bits + 16 * c;
      if (i + 16 > 0 && i < bits_end) {
        const uint32_t w = bw[keep + (c >> 1)] >> (16 * (c & 1));
        store16(bits + q0, i, bits_end,
                make_uint4(spread4(w), spread4(w >> 4), spread4(w >> 8), spread4(w >> 12)));
      }
      if (q6 != nullptr && i + 16 > 0 && i < q6_end)
        store16(q6 + q0, i, q6_end, reinterpret_cast<const uint4*>(q6s)[c]);
    }
  }
}

// The preamble bank alone over positions [q0, q0 + n) of a bit stream K1
// wrote, one byte a position: the mask of the window program's look-ahead
// (ops/stencil.py lookahead_mask). A warp takes 32 consecutive positions;
// for each preamble symbol k its lanes read the bits k SL on, which
// __ballot_sync packs into a word, and the word meets each live group's
// flip mask as in K1's bank (groups longest first, their count fixed at
// compile time). Output byte i is position q0 + i, its bit order[g] group
// g's hit.
#define MASK_THREADS 256

template <int NG>
__global__ void __launch_bounds__(MASK_THREADS)
lookahead_mask_kernel(const uint8_t* __restrict__ bits, uint8_t* __restrict__ mask, int q0,
                      int n, const StencilArgs a) {
  __shared__ __align__(16) uint32_t flip[64][MAX_GROUPS];
  fill_flip<NG>(flip, a, threadIdx.x, MASK_THREADS);
  __syncthreads();
  const int i = blockIdx.x * MASK_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool inside = i < n;
  const uint8_t* p = bits + q0 + i;
  uint32_t acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0xffffffffu;
  int k = 0;
#pragma unroll
  for (int live = NG; live >= 1; --live) {
    for (; k < a.pre_len[live - 1]; ++k) {
      const uint32_t w = __ballot_sync(0xffffffffu, inside && p[k * a.sl]);
#pragma unroll
      for (int g = 0; g < live; ++g) acc[g] &= w ^ flip[k][g];
    }
  }
  if (inside) {
    uint32_t m = 0;
#pragma unroll
    for (int g = 0; g < NG; ++g) m |= ((acc[g] >> lane) & 1u) << a.order[g];
    mask[i] = (uint8_t)m;
  }
}

// Groups longest first, at most 64 symbols, each mask bit once.
static bool groups_ok(const StencilArgs& a) {
  if (a.n_groups < 1 || a.n_groups > MAX_GROUPS || a.max_len != a.pre_len[0]) return false;
  int seen = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    if (a.pre_len[g] < 1 || a.pre_len[g] > (g ? a.pre_len[g - 1] : 64) || a.order[g] < 0 ||
        a.order[g] >= a.n_groups || (seen >> a.order[g] & 1))
      return false;
    seen |= 1 << a.order[g];
  }
  return true;
}

template <int NG>
static int launch_mask(const void* bits, void* mask, int q0, int n, const StencilArgs& a,
                       void* stream) {
  lookahead_mask_kernel<NG><<<(n + MASK_THREADS - 1) / MASK_THREADS, MASK_THREADS, 0,
                              (cudaStream_t)stream>>>((const uint8_t*)bits, (uint8_t*)mask, q0,
                                                      n, a);
  return (int)cudaGetLastError();
}

// Launch the look-ahead's bank on `stream`: mask[i] for positions q0 + i,
// i < n, of `bits` (a.lp bytes). Returns 0 or a CUDA error code:
// cudaErrorInvalidValue when a read would pass a.lp or the groups are not
// K1's, else that of the launch. `args` is K1's, read before the call
// returns.
extern "C" int rtlamr_lookahead_mask(const void* bits, void* mask, int q0, int n,
                                     const StencilArgs* args, void* stream) {
  const StencilArgs a = *args;
  if (n < 1 || q0 < 0 || a.sl < 1 || !groups_ok(a) ||
      (long long)q0 + n + (long long)(a.max_len - 1) * a.sl > a.lp)
    return (int)cudaErrorInvalidValue;
  switch (a.n_groups) {
    case 1: return launch_mask<1>(bits, mask, q0, n, a, stream);
    case 2: return launch_mask<2>(bits, mask, q0, n, a, stream);
    case 3: return launch_mask<3>(bits, mask, q0, n, a, stream);
    case 4: return launch_mask<4>(bits, mask, q0, n, a, stream);
    case 5: return launch_mask<5>(bits, mask, q0, n, a, stream);
    case 6: return launch_mask<6>(bits, mask, q0, n, a, stream);
    case 7: return launch_mask<7>(bits, mask, q0, n, a, stream);
    default: return launch_mask<8>(bits, mask, q0, n, a, stream);
  }
}

static size_t smem_bytes(int lookback, int bit_words) {
  return (size_t)(SUB_TILE + lookback) * 4 + MAX_GROUPS * WORDS * 4 + STAGES * SUB_TILE * 2 +
         SUB_TILE + (size_t)bit_words * 4;
}

template <int NG>
static int launch(int dev, const void* staged, void* bits, void* q6, void* mask, int first,
                  const StencilArgs& a, void* stream) {
  static bool attr_set[64];  // the shared-memory ceiling, once per process and device
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_stencil_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  decode_stencil_kernel<NG><<<a.n_strips, THREADS, smem_bytes(a.lookback, a.bit_words),
                              (cudaStream_t)stream>>>((const uint16_t*)staged, (uint8_t*)bits,
                                                      (uint8_t*)q6, (uint8_t*)mask,
                                                      first ? 1 : 0, a);
  return (int)cudaGetLastError();
}

// Launch on `stream`. Returns 0 or a CUDA error code: cudaErrorInvalidValue
// for arguments the kernel does not take, else that of the attribute call
// or of the launch (cudaGetLastError). Pass q6 = NULL when no group wants
// R900 symbols. `args` is a host struct, read before the call returns.
extern "C" int rtlamr_decode_stencil(const void* staged, void* bits, void* q6, void* mask,
                                     int first, const StencilArgs* args, void* stream) {
  const StencilArgs a = *args;
  const int keep = (a.d_mask - a.d_bits) / 32;
  bool ok = a.sub_tile == SUB_TILE && a.n_groups >= 1 && a.n_groups <= MAX_GROUPS &&
            a.n_staged % 8 == 0 && a.strip_len > 0 && a.strip_len % 32 == 0 &&
            a.n_strips > 0 && (long long)(a.n_strips - 1) * a.strip_len < a.lp &&
            a.d_bits % 32 == 0 && a.d_mask % 32 == 0 && a.shift == a.ps % 8 &&
            a.sl == 2 * a.cl && a.d_bits >= a.sl + a.shift &&
            (q6 == nullptr || a.d_bits >= a.sl + 4 * a.cl + a.shift) &&
            a.d_mask >= a.d_bits + (a.max_len - 1) * a.sl && keep <= THREADS &&
            a.lookback % 8 == 0 && a.lookback <= 4 * THREADS &&
            a.lookback >= a.d_bits - a.shift + 1 && a.bit_words >= keep + WORDS + 1 &&
            (long long)a.n_steps * SUB_TILE >= (long long)a.strip_len + a.d_mask &&
            smem_bytes(a.lookback, a.bit_words) <= SMEM_CAP && ((uintptr_t)staged & 15) == 0 &&
            ((uintptr_t)bits & 15) == 0 && ((uintptr_t)q6 & 15) == 0 &&
            ((uintptr_t)mask & 15) == 0;
  if (!ok || !groups_ok(a)) return (int)cudaErrorInvalidValue;

  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  switch (a.n_groups) {
    case 1: return launch<1>(dev, staged, bits, q6, mask, first, a, stream);
    case 2: return launch<2>(dev, staged, bits, q6, mask, first, a, stream);
    case 3: return launch<3>(dev, staged, bits, q6, mask, first, a, stream);
    case 4: return launch<4>(dev, staged, bits, q6, mask, first, a, stream);
    case 5: return launch<5>(dev, staged, bits, q6, mask, first, a, stream);
    case 6: return launch<6>(dev, staged, bits, q6, mask, first, a, stream);
    case 7: return launch<7>(dev, staged, bits, q6, mask, first, a, stream);
    default: return launch<8>(dev, staged, bits, q6, mask, first, a, stream);
  }
}
