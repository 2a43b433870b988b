// Fused bias-free MLP forward (inference) for Hopper, sm_90a.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/fused_mlp.py
// (_pallas_forward / _kernel, inference form without residuals).
//
// Each block takes a tile of kTile rows, one row per thread. It stages every
// weight matrix of the chain in shared memory as bf16 (33 KB for the
// reference 64-wide, 4-hidden-layer schema) and runs the whole chain for its
// rows: activations live in shared memory, transposed so that each thread
// reads and writes only its own column, and never go back to device memory.
// Rounding points are exactly those of the TPU kernel (fused_mlp.py:74-86):
// the input is rounded to bf16; each hidden layer accumulates in float32,
// applies the activation, then rounds to bf16; the last layer stays float32
// and gets the output activation. Products are float32 FMAs on bf16-rounded
// operands. Any B is taken: the ragged last tile is masked.
//
// Bound on an H100: at B = 262,144 rows of 64 bf16 features the call moves
// about 34.6 MB and does 8.62 GFLOP, so it is bytes-bound at the tensor-core
// rate. This first version runs on the float32 FMA pipes instead; a wgmma
// version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;          // rows per block == threads per block
constexpr int kStride = kTile + 1;  // padded activation stride: conflict-free

enum Act { kNone = 0, kRelu = 1, kSine = 2, kSquareplus = 3 };

__device__ __forceinline__ float activate(float h, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(h, 0.0f);
    case kSine:
      return sinf(h);
    case kSquareplus:
      return 0.5f * (h + sqrtf(h * h + 4.0f));
    default:
      return h;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two packed bf16 (low half first) → two floats, exactly
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Weights arrive as one bf16 buffer: layer 0 [n_in][W], then n_hidden-1
// layers [W][W], then the last layer [fan_in][n_out] (fan_in = W, or n_in
// without hidden layers); each matrix row-major [fan_in][fan_out].
template <int W>
__global__ void __launch_bounds__(kTile)
fused_mlp_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                 float* __restrict__ y, long long n_rows, int n_in,
                 int n_hidden, int n_out, int w_total, int act, int out_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem_raw);
  float* sact = reinterpret_cast<float*>(smem_raw) + ((w_total + 7) / 8) * 4;
  const int t = threadIdx.x;

  for (int e = t; e < w_total; e += kTile) sw[e] = w[e];

  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                        n_rows - row0));
  // coalesced load of the [rows][n_in] input tile, stored transposed
  const uint16_t* xt = x + row0 * n_in;
  for (int e = t; e < kTile * n_in; e += kTile) {
    const int r = e / n_in;
    const int i = e - r * n_in;
    sact[i * kStride + r] =
        r < rows ? __uint_as_float(static_cast<uint32_t>(xt[e]) << 16) : 0.0f;
  }
  __syncthreads();

  // from here each thread touches only its own activation column: no
  // barrier is needed between layers
  const uint16_t* wl = sw;
  int fan_in = n_in;
  for (int l = 0; l < n_hidden; ++l) {
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.0f;
    for (int i = 0; i < fan_in; ++i) {
      const float a = sact[i * kStride + t];
      const uint2* wr = reinterpret_cast<const uint2*>(wl + i * W);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint2 u = wr[q];
        acc[4 * q + 0] = fmaf(a, bf16_lo(u.x), acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(a, bf16_hi(u.x), acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a, bf16_lo(u.y), acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a, bf16_hi(u.y), acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      sact[j * kStride + t] = round_bf16(activate(acc[j], act));
    }
    wl += fan_in * W;
    fan_in = W;
  }

  if (t < rows) {
    for (int o = 0; o < n_out; ++o) {
      float s = 0.0f;
      for (int i = 0; i < fan_in; ++i) {
        const float wv = __uint_as_float(
            static_cast<uint32_t>(wl[i * n_out + o]) << 16);
        s = fmaf(sact[i * kStride + t], wv, s);
      }
      y[(row0 + t) * n_out + o] = activate(s, out_act);
    }
  }
}

template <int W>
cudaError_t launch(const void* x, const void* w, void* y, long long n_rows,
                   int n_in, int n_hidden, int n_out, int act, int out_act,
                   cudaStream_t stream) {
  const int last_in = n_hidden > 0 ? W : n_in;
  const int w_total =
      (n_hidden > 0 ? n_in * W + (n_hidden - 1) * W * W : 0) + last_in * n_out;
  const int n_act = n_in > W ? n_in : W;
  const size_t bytes = sizeof(float) * (((w_total + 7) / 8) * 4 +
                                        static_cast<size_t>(n_act) * kStride);
  auto kern = fused_mlp_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + kTile - 1) / kTile;
  kern<<<static_cast<unsigned>(blocks), kTile, bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<float*>(y), n_rows, n_in, n_hidden, n_out, w_total, act,
      out_act);
  return cudaGetLastError();
}

}  // namespace

// x [n_rows, n_in] bf16, w packed bf16 (layout above), y [n_rows, n_out] f32.
// width: the hidden width, one of 16, 32, 64, 128; n_in ≤ 128.
extern "C" int fused_mlp_forward(const void* x, const void* w, void* y,
                                 long long n_rows, int n_in, int width,
                                 int n_hidden, int n_out, int act, int out_act,
                                 void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_in <= 0 || n_in > 128 || n_out <= 0 || n_hidden < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch<16>(x, w, y, n_rows, n_in, n_hidden, n_out, act, out_act, s);
    case 32:
      return launch<32>(x, w, y, n_rows, n_in, n_hidden, n_out, act, out_act, s);
    case 64:
      return launch<64>(x, w, y, n_rows, n_in, n_hidden, n_out, act, out_act, s);
    case 128:
      return launch<128>(x, w, y, n_rows, n_in, n_hidden, n_out, act, out_act,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}
