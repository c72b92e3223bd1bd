// Fused polyphase channelizer (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel rtlamr_tpu/ops/pallas_channelizer.py::_kernel (the
// Pallas body called through channelize_requantize_fused_u16). One pass
// turns F frames of a wideband u16 stream (frame-major: element m*N + j is
// frame m of plane j, one (I, Q) byte pair each, I in the low byte) into N
// channel rows of staged u16 samples:
//
//   x_j[k]  = ((v & 255) - 127.5, (v >> 8) - 127.5) of frame k, plane j;
//             frames k < 0 come from the P history frames, or are 0.0 when
//             `first` (the stream head)
//   y_b[m]  = sum_p h2[p, b] * x_{(N-b) mod N}[m - p - (b >= 1)],
//             taps p ascending                             (branches)
//   c_c[m]  = sum_b: cr = (cr + er[c,b] yr_b) - ei[c,b] yi_b,
//                    ci = (ci + er[c,b] yi_b) + ei[c,b] yr_b,
//             branches b ascending                         (DFT mix)
//   out[c][m] = q(cr) | q(ci) << 8, q(v) = clip(rint(v + 127.5), 0, 255)
//
// for the channels c of one block [C0, C0 + C), written as rows c - C0: all
// N by default, or the rows of one channel shard of the wideband mesh
// (rtlamr_tpu_torch/parallel/wideband_mesh.py), which runs every branch and
// only its own rows of the mix, as the JAX mesh's mix_channels(spec, y,
// channel_start, channel_count) does. A block's rows are the same operations
// on the same values as those rows of the full launch, so the same bytes.
//
// Every product and sum is rounded on its own, in the reference's order
// (__fmul_rn / __fadd_rn / __fsub_rn, never an FMA), so the result is
// byte-equal to the plain PyTorch version
// (rtlamr_tpu_torch/ops/channelizer_fused.py channelize_requantize_plain).
//
// What bounds it on the card: operations. None may be fused, so each
// product and each sum is one instruction, and the FP32 pipe issues 128 a
// clock per SM, which is also the SM's whole issue width: 128 x 132 SMs x
// 1.98 GHz = 33.45 T instructions/s on an NVIDIA H100 80GB HBM3 at its
// 700.00 W power limit (clocks.max.sm 1980 MHz). Counted in the cheapest
// exact form, at N = 12, P = 8 a frame needs 4 N P - 2 N = 360 for the
// branches (each chain starts with its first product, not 0 + it), 6 N = 72
// for the DC removal (two bit operations and a subtraction a component), 9
// N = 108 for the requantize (an add, a max, a min and the rounding add a
// component, one byte permute), and 652 for the mix (ops/channelizer_mix.py;
// 1,152 in the reference's order): 1,192 a frame, 10.0 G at F = 8,388,608
// frames, 0.299 ms (1,716 a frame, 0.430 ms in the reference's order;
// chip_smoke.py channelizer_work), against 403 MB of traffic, 0.120 ms at
// 3.35 TB/s. Dropping a chain's 0 + is exact but for a zero's sign, which
// the requantize cannot see.
//
// Design, for that bound (measured on an H100 by chip_smoke.py; PERF.md):
// - N and the block's row count C are template arguments (its first
//   channel C0 lives in the generated mix alone), so the branch loop and
//   the mix unroll fully and the 2 C T accumulators of a thread's T frames
//   stay in registers. A library holds one instantiation, built on first
//   use for the N, block and tap class a caller launches (-DRTLAMR_K2_N,
//   -DRTLAMR_K2_C0, -DRTLAMR_K2_ROWS, -DRTLAMR_K2_P; ops/channelizer_fused.py
//   kernel_library). The mix is the straight-line program of
//   ops/channelizer_mix.py, generated from the float32 tables of that N for
//   that block into the build directory (channelizer_mix.cuh): one product for
//   each distinct coefficient magnitude of a branch, shared by its channels,
//   none for a magnitude of 1, nothing for a 0, a copy for the first
//   accumulation; the coefficients are immediates. P = 8, the only count any
//   path uses, is a template argument too, and its taps arrive in the
//   __grid_constant__ parameter block, so they are constant-bank operands;
//   any other P runs the same kernel with a runtime tap loop over the taps
//   in device memory (read through the L1).
// - Each thread owns T consecutive frames (2 up to N = 20, else 1;
//   ops/channelizer_fused.py channelizer_plan), keeps the P + T - 1 input
//   frames of a branch in registers and reads each from shared memory once.
//   A CTA is 256 threads, one tile of 512 frames at T = 2. Shapes with more
//   frames a thread (4), fewer threads (64, 128) or persistent CTAs that
//   load the next span while computing held more registers, so fewer
//   resident warps, and measured slower (PERF.md).
// - Shared memory holds the CTA's span (its tile and the P frames before
//   it), DC-removed, as float2 in a layout [plane][frame % T][frame / T], so
//   the T-strided reads of a warp touch consecutive words (no bank
//   conflicts). The span is copied with 16-byte loads where the chunk is
//   16-byte aligned, IN_FLIGHT of them a thread issued before any is
//   converted (element by element at a misaligned head or tail).
// - Conversions stay off the slow pipe: the DC removal builds the float
//   2^22 + byte from the byte's bits and subtracts 2^22 + 127.5; the
//   requantize clamps v + 127.5 to [0, 255] and adds 1.5 x 2^23, which rounds
//   half to even as rintf does, and reads the byte from the float's bits.
// - Outputs are written straight into their rows (row stride out_stride),
//   T u16 of a channel in one store where the rows allow it.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_CHANNELS 32
#define FIXED_TAPS 8                   // the P with a compile-time tap loop
#define IN_FLIGHT 2                    // 16-byte input loads a thread has in flight
#define SMEM_CAP (227 * 1024)

#ifndef RTLAMR_K2_N
#error "build with -DRTLAMR_K2_N=<channels> (ops/channelizer_fused.py kernel_library)"
#endif
#ifndef RTLAMR_K2_P
#define RTLAMR_K2_P 0                  // 0: the runtime tap loop, else FIXED_TAPS
#endif
#ifndef RTLAMR_K2_C0
#define RTLAMR_K2_C0 0                 // the block's first channel
#endif
#ifndef RTLAMR_K2_ROWS
#define RTLAMR_K2_ROWS RTLAMR_K2_N     // the block's channels
#endif
static_assert(RTLAMR_K2_N >= 1 && RTLAMR_K2_N <= MAX_CHANNELS, "1 <= N <= 32");
static_assert(RTLAMR_K2_P == 0 || RTLAMR_K2_P == FIXED_TAPS, "P is 0 (runtime) or FIXED_TAPS");
static_assert(RTLAMR_K2_C0 >= 0 && RTLAMR_K2_ROWS >= 1 && RTLAMR_K2_C0 + RTLAMR_K2_ROWS <= RTLAMR_K2_N,
              "the block [C0, C0 + ROWS) lies inside [0, N)");

#define MIX_MUL(dst, a, y) \
  _Pragma("unroll") for (int u = 0; u < T; ++u) dst[u] = __fmul_rn(a, y[u]);
#define MIX_SET(acc, v) \
  _Pragma("unroll") for (int u = 0; u < T; ++u) acc[u] = v[u];
#define MIX_ADD(acc, v) \
  _Pragma("unroll") for (int u = 0; u < T; ++u) acc[u] = __fadd_rn(acc[u], v[u]);
#define MIX_SUB(acc, v) \
  _Pragma("unroll") for (int u = 0; u < T; ++u) acc[u] = __fsub_rn(acc[u], v[u]);

#include "channelizer_mix.cuh"
static_assert(Mix<RTLAMR_K2_N>::kStart == RTLAMR_K2_C0 && Mix<RTLAMR_K2_N>::kRows == RTLAMR_K2_ROWS,
              "the generated mix is of this block");

// Must match ops/channelizer_fused.py _Args.
struct ChannelizeArgs {
  long long frames;      // F
  long long out_stride;  // elements between output rows
  int n;                 // channels N (= planes)
  int p;                 // taps per branch P (= history frames)
  int first;             // 1 at the stream head: history reads as 0.0
  int per_thread;        // frames a thread, T
  int tile;              // frames a CTA, THREADS * T
  int vec_in;            // set by the launcher: chunk 16-byte aligned
  int vec_out;           // set by the launcher: T u16 of a row in one store
  int rows;              // the block's channels (output rows), C
  float taps[FIXED_TAPS * MAX_CHANNELS];  // (P, N) row-major when P == 8
};

__host__ __device__ constexpr int frames_per_thread(int n) {
  return n <= 20 ? 2 : 1;
}

__host__ __device__ constexpr int log2_of(int t) { return t == 2 ? 1 : 0; }  // t is 1 or 2

// ((v & 255) - 127.5, (v >> 8) - 127.5) of a u16 sample: 2^22 + byte is
// built from the bits (float32 spacing there is 0.5), then 2^22 + 127.5 is
// subtracted; both are exact.
__device__ __forceinline__ float2 dc_removed(uint32_t v) {
  const float re = __int_as_float(0x4A800000 | ((v << 1) & 0x1FEu));
  const float im = __int_as_float(0x4A800000 | ((v >> 7) & 0x1FEu));
  return make_float2(__fsub_rn(re, 4194431.5f), __fsub_rn(im, 4194431.5f));
}

// Bits of clip(rint(v + 127.5), 0, 255) + 1.5 x 2^23: the low byte is the
// value. Clamping first and rounding after is the same for integer bounds,
// and in [0, 255] + 1.5 x 2^23 the float32 spacing is 1, so the add rounds
// half to even.
__device__ __forceinline__ uint32_t requant_bits(float v) {
  const float t = fminf(fmaxf(__fadd_rn(v, 127.5f), 0.0f), 255.0f);
  return (uint32_t)__float_as_int(__fadd_rn(t, 12582912.0f));
}

// u16 sample I | Q << 8 in the low half.
__device__ __forceinline__ uint32_t pack_iq(float cr, float ci) {
  return __byte_perm(requant_bits(cr), requant_bits(ci), 0x0040);
}

// Where span element i (frame i / N, plane i % N) lies in the
// [plane][frame % T][frame / T] layout.
template <int N, int T>
__device__ __forceinline__ int slot(int sub, int i) {
  const int f = i / N;
  const int j = i - f * N;
  return j * T * sub + (f & (T - 1)) * sub + (f >> log2_of(T));
}

template <int N, int C, int P>
__global__ void __launch_bounds__(THREADS)
channelize_kernel(const uint16_t* __restrict__ wb, const uint16_t* __restrict__ hist,
                  uint16_t* __restrict__ out, const float* __restrict__ taps_dev,
                  const __grid_constant__ ChannelizeArgs a) {
  constexpr int T = frames_per_thread(N);
  constexpr int LT = log2_of(T);
  constexpr int TILE = THREADS * T;
  const int p_taps = P > 0 ? P : a.p;
  const int sub = THREADS + (p_taps + T - 1) / T;  // float2 in a [frame % T] row
  extern __shared__ float2 s_x[];                  // [N][T][sub]
  const int tid = threadIdx.x;

  // The span: frames [m0 - P, m0 + TILE) clipped to F, elements [e0, e_end)
  // of the stream (negative ones from the history).
  const long long m0 = (long long)blockIdx.x * TILE;
  const long long e0 = (m0 - p_taps) * N;
  const long long e_end = (m0 + TILE < a.frames ? m0 + TILE : a.frames) * N;
  if (e0 < 0) {
    const int nh = (int)((e_end < 0 ? e_end : 0) - e0);
    const long long h0 = e0 + (long long)p_taps * N;  // history index of element e0
    for (int i = tid; i < nh; i += THREADS)
      s_x[slot<N, T>(sub, i)] = a.first ? make_float2(0.0f, 0.0f) : dc_removed(hist[h0 + i]);
  }
  const long long lo = e0 > 0 ? e0 : 0;
  if (a.vec_in) {
    // 16-byte groups of 8 elements, IN_FLIGHT a thread loaded before any is
    // converted, so their latencies overlap; a group that is not whole
    // inside [lo, e_end) goes element by element.
    const long long g0 = lo >> 3;
    const int ng = (int)(((e_end + 7) >> 3) - g0);
    for (int k0 = 0; k0 < ng; k0 += IN_FLIGHT * THREADS) {
      uint4 w[IN_FLIGHT];
#pragma unroll
      for (int r = 0; r < IN_FLIGHT; ++r) {
        const int k = k0 + r * THREADS + tid;
        const long long e = (g0 + k) << 3;
        if (k < ng && e >= lo && e + 8 <= e_end)
          w[r] = __ldg(reinterpret_cast<const uint4*>(wb) + (g0 + k));
      }
#pragma unroll
      for (int r = 0; r < IN_FLIGHT; ++r) {
        const int k = k0 + r * THREADS + tid;
        const long long e = (g0 + k) << 3;
        if (k >= ng) continue;
        if (e >= lo && e + 8 <= e_end) {
          const uint32_t ws[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
          const int i0 = (int)(e - e0);
          int f = i0 / N;
          int j = i0 - f * N;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const uint32_t v = (q & 1) ? ws[q >> 1] >> 16 : ws[q >> 1] & 0xFFFFu;
            s_x[j * T * sub + (f & (T - 1)) * sub + (f >> LT)] = dc_removed(v);
            if (++j == N) {
              j = 0;
              ++f;
            }
          }
        } else {
          for (int q = 0; q < 8; ++q) {
            if (e + q >= lo && e + q < e_end)
              s_x[slot<N, T>(sub, (int)(e + q - e0))] = dc_removed(wb[e + q]);
          }
        }
      }
    }
  } else {
    const int n_el = (int)(e_end - lo);
    for (int i = tid; i < n_el; i += THREADS)
      s_x[slot<N, T>(sub, (int)(lo - e0) + i)] = dc_removed(wb[lo + i]);
  }
  __syncthreads();

  // Thread tid owns output frames m0 + T tid + u, u < T: span frame
  // T tid + u - p - d + P for tap p of a branch with delay d.
  const long long m = m0 + (long long)T * tid;
  if (m >= a.frames) return;
  float cr[C][T], ci[C][T];  // rows c - C0: set by branch 0's MIX_SET, then accumulated
#pragma unroll
  for (int b = 0; b < N; ++b) {
    const int j = b == 0 ? 0 : N - b;
    const int d = b == 0 ? 0 : 1;
    const float2* xs = s_x + j * T * sub + tid;  // + (s % T) sub + s / T for span frame T tid + s
    float yr[T], yi[T];
    if constexpr (P > 0) {
      float2 w[P + T - 1];  // span frames T tid + 1 - d + i
#pragma unroll
      for (int i = 0; i < P + T - 1; ++i) {
        const int s = 1 - d + i;
        w[i] = xs[(s & (T - 1)) * sub + (s >> LT)];
      }
#pragma unroll
      for (int u = 0; u < T; ++u) {
        float ar, ai;  // each chain starts with its first product
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float h = a.taps[p * N + b];
          const float2 x = w[u + P - 1 - p];
          ar = p == 0 ? __fmul_rn(h, x.x) : __fadd_rn(ar, __fmul_rn(h, x.x));
          ai = p == 0 ? __fmul_rn(h, x.y) : __fadd_rn(ai, __fmul_rn(h, x.y));
        }
        yr[u] = ar;
        yi[u] = ai;
      }
    } else {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const int s0 = u - d + p_taps;  // span frame of tap 0, T tid off
        const float h0 = __ldg(taps_dev + b);
        const float2 x0 = xs[(s0 & (T - 1)) * sub + (s0 >> LT)];
        float ar = __fmul_rn(h0, x0.x), ai = __fmul_rn(h0, x0.y);
        for (int p = 1; p < p_taps; ++p) {
          const float h = __ldg(taps_dev + p * N + b);
          const int s = s0 - p;
          const float2 x = xs[(s & (T - 1)) * sub + (s >> LT)];
          ar = __fadd_rn(ar, __fmul_rn(h, x.x));
          ai = __fadd_rn(ai, __fmul_rn(h, x.y));
        }
        yr[u] = ar;
        yi[u] = ai;
      }
    }
    Mix<N>::template branch<T>(b, yr, yi, cr, ci);
  }

  const long long left = a.frames - m;
  const bool whole = left >= T && a.vec_out;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint16_t* o = out + c * a.out_stride + m;
    uint32_t q[T];
#pragma unroll
    for (int u = 0; u < T; ++u) q[u] = pack_iq(cr[c][u], ci[c][u]);
    if (whole) {
      if constexpr (T == 2) {
        *reinterpret_cast<uint32_t*>(o) = __byte_perm(q[0], q[1], 0x5410);
      } else {
        o[0] = (uint16_t)q[0];
      }
    } else {
#pragma unroll
      for (int u = 0; u < T; ++u)
        if (u < left) o[u] = (uint16_t)q[u];
    }
  }
}

static size_t smem_bytes(int n, int t, int p) {
  const size_t sub = THREADS + (p + t - 1) / t;
  return (size_t)n * t * sub * sizeof(float2);
}

template <int N, int C, int P>
static int launch(int dev, const void* wb, const void* hist, void* out, const void* taps_dev,
                  const ChannelizeArgs& a, void* stream) {
  static bool attr_set[64];  // the shared-memory ceiling, once per process and device
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        channelize_kernel<N, C, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  constexpr int T = frames_per_thread(N);
  const size_t smem = smem_bytes(N, T, a.p);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  const long long grid = (a.frames + THREADS * T - 1) / (THREADS * T);
  channelize_kernel<N, C, P><<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)wb, (const uint16_t*)hist, (uint16_t*)out, (const float*)taps_dev, a);
  return (int)cudaGetLastError();
}

// Launch channelize_kernel<RTLAMR_K2_N, RTLAMR_K2_ROWS, RTLAMR_K2_P> on
// `stream`. Returns 0 or a CUDA error code:
// cudaErrorInvalidValue for arguments the kernel does not take (an N, block
// or P this library does not hold, a plan that is not the kernel's, or more
// shared memory than a CTA may have, at a large p), else that of the
// attribute call or of the launch (cudaGetLastError). `wb` holds frames * n
// u16 elements, `hist` p * n (the previous chunk's last p frames; ignored
// when first), `out` rows rows of `frames` u16 at row stride
// `out_stride`; `taps` is the (p, n) float32 device table, read by the
// runtime tap loop (args->taps holds it for P = 8). `args` is a host
// struct, read before the call returns.
extern "C" int rtlamr_channelize(const void* wb, const void* hist, void* out, const void* taps,
                                 const ChannelizeArgs* args, void* stream) {
  ChannelizeArgs a = *args;
  if (a.n != RTLAMR_K2_N || a.rows != RTLAMR_K2_ROWS || a.p < 1 ||
      (RTLAMR_K2_P > 0 && a.p != RTLAMR_K2_P) ||
      a.frames < 1 || a.per_thread != frames_per_thread(a.n) ||
      a.tile != THREADS * a.per_thread || (a.frames + a.tile - 1) / a.tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int t = a.per_thread;
  a.vec_in = ((uintptr_t)wb & 15) == 0;
  a.vec_out = ((uintptr_t)out & (2 * t - 1)) == 0 && a.out_stride % t == 0;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  return launch<RTLAMR_K2_N, RTLAMR_K2_ROWS, RTLAMR_K2_P>(dev, wb, hist, out, taps, a, stream);
}
