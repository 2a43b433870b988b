// Brick-pool sampling for Hopper, sm_90a: one thread a sample.
//
// Replaces instantvnr_tpu/render/brickcache.py::brick_sample_fn and
// _pool_lookup (:731-779), which the JAX package leaves to XLA (two
// gathers a sample: the cell's LUT slot, then one corner-packed row). In
// plain PyTorch the same lookup is ~60 elementwise launches over the
// batch; here a thread computes its macrocell, reads the LUT slot (a
// 2 KB table at 128^3, cache-resident), reads ONE corner-packed row (8 x
// f16 = one 16-byte load, 8 x f32 = two) and sums the trilinear weights.
//
// Exactness: the operations are the plain version's (ops/brick_sample.py::
// brick_sample_reference) in its order, IEEE division, floorf and no FMA
// (-fmad=false), the corner sum a left-to-right chain: bit for bit.
//
// Bound on an H100: a sample reads p (12 B) and one pool row (16 B in f16,
// 32 B in f32) and writes 4 B. Samples along a ray share rows, and two
// f16 rows that are neighbours in x share one 32-byte sector, so the pool
// bytes a launch needs are its distinct sectors (chip_smoke.py counts
// them), well under 32 B a sample. The ~80 float operations a sample stay
// under that on the float32 pipes.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kGhost = 2;
constexpr int kBrick = 20;

// The rows a launch samples: all n, or with a device-side count (the
// compacted wavefront's valid slots) those of [offset, offset + n) below
// it. Blocks past the count exit at once.
__device__ __forceinline__ long long live_rows(long long n, const int* count,
                                               long long offset) {
  if (count == nullptr) return n;
  const long long c = static_cast<long long>(*count) - offset;
  return c < 0 ? 0 : (c < n ? c : n);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool kHalf>
__device__ __forceinline__ void load_row(const void* packed, long long idx,
                                         float (&r)[8]) {
  if (kHalf) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(packed) + idx);
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      r[2 * i] = f.x;
      r[2 * i + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(packed) + 2 * idx;
    const float4 a = __ldg(q);
    const float4 b = __ldg(q + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  }
}

template <bool kHalf>
__global__ void __launch_bounds__(kBlock)
brick_sample_kernel(const int* __restrict__ lut, const void* __restrict__ packed,
                    const float* __restrict__ p, long long n, int dx, int dy,
                    int dz, int mx, int my, int mz, int ss,
                    float* __restrict__ out, const int* __restrict__ count,
                    long long offset) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= live_rows(n, count, offset)) return;
  const int dims[3] = {dx, dy, dz};
  const int mcd[3] = {mx, my, mz};
  const int brick = ss * (kBrick - 1) + 1;
  int cell[3], local[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pa = __ldg(p + 3 * i + a);
    const float dimf = static_cast<float>(dims[a]);
    const float pos_v = pa * dimf;
    cell[a] = clampi(static_cast<int>(floorf(pos_v / 16.0f)), 0, mcd[a] - 1);
    const float top = static_cast<float>(ss) * (dimf - 1.0f);
    const float x = fminf(fmaxf(pa * top, 0.0f), top);
    const float i0 = floorf(x);
    frac[a] = x - i0;
    local[a] = clampi(static_cast<int>(i0) - (cell[a] * (16 * ss) - kGhost * ss),
                      0, brick - 2);
  }
  const int slot = __ldg(lut + (cell[2] * my + cell[1]) * mx + cell[0]);
  if (slot < 0) {
    out[i] = 0.0f;
    return;
  }
  const long long brick3 = static_cast<long long>(brick) * brick * brick;
  const long long idx = static_cast<long long>(slot) * brick3 +
                        (static_cast<long long>(local[2]) * brick + local[1]) *
                            brick + local[0];
  float r[8];
  load_row<kHalf>(packed, idx, r);
  const float wx[2] = {1.0f - frac[0], frac[0]};
  const float wy[2] = {1.0f - frac[1], frac[1]};
  const float wz[2] = {1.0f - frac[2], frac[2]};
  float val = r[0] * (wz[0] * wy[0] * wx[0]);
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    const float w = wz[(c >> 2) & 1] * wy[(c >> 1) & 1] * wx[c & 1];
    val = val + r[c] * w;
  }
  out[i] = val;
}

}  // namespace

// lut: int32 [mx*my*mz] (slot or -1); packed: [n_rows, 8] float32, or
// float16 when is_half, 16-byte aligned; p: float32 [n, 3] object space;
// dims (dx, dy, dz); ss 1 or 2. Writes out float32 [n]. count: null, or
// an int32 on the device: then only rows i < *count - offset are sampled
// and the others of out are left as they were.
extern "C" int brick_sample(const void* lut, const void* packed, int is_half,
                            const void* p, long long n, int dx, int dy, int dz,
                            int mx, int my, int mz, int ss, void* out,
                            const void* count, long long offset,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  if (mx < 1 || my < 1 || mz < 1 || (ss != 1 && ss != 2))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lut);
  const float* pp = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  const int* c = static_cast<const int*>(count);
  if (is_half)
    brick_sample_kernel<true><<<blocks, kBlock, 0, s>>>(
        l, packed, pp, n, dx, dy, dz, mx, my, mz, ss, o, c, offset);
  else
    brick_sample_kernel<false><<<blocks, kBlock, 0, s>>>(
        l, packed, pp, n, dx, dy, dz, mx, my, mz, ss, o, c, offset);
  return cudaGetLastError();
}
