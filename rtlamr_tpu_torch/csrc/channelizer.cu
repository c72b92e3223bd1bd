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
// Every product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn
// in the reference's order, so nothing is contracted into an FMA and the
// result is bit-equal to the plain PyTorch version
// (rtlamr_tpu_torch/ops/channelizer_fused.py channelize_requantize_plain).
// rintf rounds half to even, as torch.round and jnp.round do. The taps and
// the mix coefficients arrive as float32 tables made in numpy, never
// recomputed here.
//
// What bounds it on the card: operations. At N = 12, P = 8 a frame reads
// and writes 2 bytes per plane (4 N bytes) but takes about 4 N P + 8 N^2 +
// 18 N = 1,752 float32 operations, none of which may be fused; at
// F = 8,388,608 frames that is 14.7 G operations (0.22 ms at the 67 TFLOP/s
// float32 peak, 0.44 ms at the 33.5 T/s rate of unfused instructions)
// against 403 MB of traffic (0.12 ms at 3.35 TB/s).
//
// Design: one CTA per tile of FRAMES frames, one thread per frame. The CTA
// copies its input span (the tile plus the P frames before it) from the
// frame-major stream where it lies, coalesced, into shared memory as
// plane-major float2 (DC removed once per sample), so neighbouring threads
// read neighbouring words and no transpose pass runs on the card. The
// branch outputs go to shared memory too ([b][thread] float2), which keeps
// register use independent of N (no spills up to MAX_CHANNELS = 32). The
// mix reads the coefficient tables from shared memory as broadcasts. The
// output is written straight into its destination rows (row stride
// `out_stride`), e.g. the staged batch behind each channel's halo.

#include <cuda_runtime.h>
#include <stdint.h>

#define FRAMES 128
#define MAX_CHANNELS 32

struct Params {
  int n;                 // channels N (= planes)
  int p;                 // taps per branch P (= history frames)
  long long frames;      // F
  long long out_stride;  // elements between output rows
  int first;             // 1 at the stream head: history reads as 0.0
  int span;              // frames staged per CTA: FRAMES + P
  int coef_floats;       // P N + 2 N^2, rounded up to even
};

__device__ __forceinline__ float2 dc_removed(uint32_t v) {
  return make_float2(__fsub_rn((float)(v & 255u), 127.5f),
                     __fsub_rn((float)(v >> 8), 127.5f));
}

__device__ __forceinline__ uint32_t requant(float v) {
  float r = rintf(__fadd_rn(v, 127.5f));
  r = fminf(fmaxf(r, 0.0f), 255.0f);
  return (uint32_t)r;
}

__global__ void __launch_bounds__(FRAMES)
channelize_kernel(const uint16_t* __restrict__ wb,
                  const uint16_t* __restrict__ hist,
                  uint16_t* __restrict__ out,
                  const float* __restrict__ taps,  // (P, N)
                  const float* __restrict__ er,    // (N, N)
                  const float* __restrict__ ei,    // (N, N)
                  Params g) {
  extern __shared__ float smem[];
  const int n = g.n, P = g.p, span = g.span;
  float* s_taps = smem;        // [p * n + b]
  float* s_er = s_taps + P * n;  // [c * n + b]
  float* s_ei = s_er + n * n;
  float2* s_x = reinterpret_cast<float2*>(smem + g.coef_floats);  // [j][span]
  float2* s_y = s_x + n * span;  // [b][FRAMES]

  const int tid = threadIdx.x;
  for (int i = tid; i < P * n; i += FRAMES) s_taps[i] = taps[i];
  for (int i = tid; i < n * n; i += FRAMES) {
    s_er[i] = er[i];
    s_ei[i] = ei[i];
  }

  // Input span: frames [m0 - P, m0 + FRAMES), one contiguous run of the
  // frame-major stream (history for frames < 0), staged plane-major.
  const long long m0 = (long long)blockIdx.x * FRAMES;
  const long long k0 = m0 - P;
  const int n_elem = span * n;
  for (int i = tid; i < n_elem; i += FRAMES) {
    const int f = i / n;
    const int j = i - f * n;
    const long long k = k0 + f;
    float2 x = make_float2(0.0f, 0.0f);
    if (k >= g.frames) {
      // past the ragged end: read by no output frame
    } else if (k >= 0) {
      x = dc_removed(wb[k * n + j]);
    } else if (!g.first) {
      x = dc_removed(hist[(k + P) * n + j]);
    }
    s_x[j * span + f] = x;
  }
  __syncthreads();

  // Branches: output frame m = m0 + tid reads local frame tid + P - p - d.
  for (int b = 0; b < n; ++b) {
    const int j = b == 0 ? 0 : n - b;
    const int d = b == 0 ? 0 : 1;
    const float2* xs = s_x + j * span + (tid + P - d);
    float ar = 0.0f, ai = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float h = s_taps[p * n + b];
      const float2 x = xs[-p];
      ar = __fadd_rn(ar, __fmul_rn(h, x.x));
      ai = __fadd_rn(ai, __fmul_rn(h, x.y));
    }
    s_y[b * FRAMES + tid] = make_float2(ar, ai);
  }
  // Each thread reads back only its own column of s_y: no barrier needed.

  const long long m = m0 + tid;
  if (m >= g.frames) return;
  for (int c = 0; c < n; ++c) {
    float cr = 0.0f, ci = 0.0f;
    const float* rr = s_er + c * n;
    const float* ri = s_ei + c * n;
    for (int b = 0; b < n; ++b) {
      const float2 y = s_y[b * FRAMES + tid];
      const float r = rr[b], q = ri[b];
      cr = __fsub_rn(__fadd_rn(cr, __fmul_rn(r, y.x)), __fmul_rn(q, y.y));
      ci = __fadd_rn(__fadd_rn(ci, __fmul_rn(r, y.y)), __fmul_rn(q, y.x));
    }
    out[c * g.out_stride + m] = (uint16_t)(requant(cr) | (requant(ci) << 8));
  }
}

static size_t smem_bytes(int n, int p, int* span, int* coef_floats) {
  *span = FRAMES + p;
  int coef = p * n + 2 * n * n;
  coef += coef & 1;  // float2 alignment of what follows
  *coef_floats = coef;
  return (size_t)coef * sizeof(float) +
         (size_t)n * (*span + FRAMES) * sizeof(float2);
}

// Launch on `stream`. Returns 0 or the CUDA error code of the attribute call
// (e.g. more shared memory than a CTA may have, at a large p) or of the
// launch (cudaGetLastError). `wb` holds frames * n u16 elements,
// `hist` p * n (the previous chunk's last p frames; ignored when first),
// `out` n rows of `frames` u16 at row stride `out_stride`; `taps`, `er`
// and `ei` are float32 device tables of p * n, n * n and n * n values.
extern "C" int rtlamr_channelize(const void* wb, const void* hist, void* out,
                                 const void* taps, const void* er,
                                 const void* ei, int n, int p,
                                 long long frames, long long out_stride,
                                 int first, void* stream) {
  if (n < 1 || n > MAX_CHANNELS || p < 1 || frames < 1)
    return (int)cudaErrorInvalidValue;
  Params g;
  g.n = n;
  g.p = p;
  g.frames = frames;
  g.out_stride = out_stride;
  g.first = first ? 1 : 0;
  const size_t smem = smem_bytes(n, p, &g.span, &g.coef_floats);
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (frames + FRAMES - 1) / FRAMES;
  channelize_kernel<<<(unsigned)grid, FRAMES, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)wb, (const uint16_t*)hist, (uint16_t*)out,
      (const float*)taps, (const float*)er, (const float*)ei, g);
  return (int)cudaGetLastError();
}
