// Fused bias-free MLP for Hopper, sm_90a: inference forward, training
// forward and backward.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/fused_mlp.py
// (_pallas_forward / _kernel, with and without residuals) and its custom_vjp
// backward _bwd, an XLA matmul chain there.
//
// Forward (fused_mlp_forward, fused_mlp_train_forward). Each block takes a
// tile of kTile rows, one row per thread. It stages every weight matrix of
// the chain in shared memory as bf16 (33 KB for the reference 64-wide,
// 4-hidden-layer schema) and runs the whole chain for its rows: activations
// live in shared memory, transposed so that each thread reads and writes
// only its own column, and never go back to device memory. Rounding points
// are exactly those of the TPU kernel (fused_mlp.py:74-86): the input is
// rounded to bf16; each hidden layer accumulates in float32, applies the
// activation, then rounds to bf16; the last layer stays float32. The
// inference form applies the output activation; the training form instead
// writes each hidden layer's float32 pre-activation to zs [n_hidden, B, W]
// and leaves the output pre-activation z_out to the caller. Products are
// float32 FMAs on bf16-rounded operands. The ragged last tile is masked.
//
// Backward (fused_mlp_backward): one block per tile of kRows rows, one row
// per thread, the bf16 weights in shared memory. Per row, from the output
// cotangent g: g_z = g·out_act'(z_out); then for k from the last layer
// down, g_h = g_z·W_kᵀ and g_z = g_h·act'(z_{k-1}), all in float32. The
// layer inputs h_k = bf16(act(z_{k-1})) are rebuilt from zs, never
// recomputed from x. Each block sums h_kᵀ g_z over its rows in float32 and
// writes the sum as its partial of dW; a second kernel adds the partials in
// block order, so two runs give the same bits (no float atomics). dx is
// g_h of the first layer, rounded to x's type.
//
// Bound on an H100: the forward at B = 262,144 rows of 64 bf16 features
// moves about 34.6 MB and does 8.62 GFLOP, bytes-bound at the tensor-core
// rate; the backward at B = 65,536 does about twice the forward's
// operations and moves the residuals (64 MB of float32 at the reference
// widths). These first versions run on the float32 FMA pipes instead of
// the tensor cores; wgmma versions are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;          // forward: rows per block == threads
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

// d act(z) / dz (fused_mlp.py _act_grad); ReLU's is 0 at z = 0
__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case kRelu:
      return z > 0.0f ? 1.0f : 0.0f;
    case kSine:
      return cosf(z);
    case kSquareplus:
      return 0.5f * (1.0f + z * rsqrtf(z * z + 4.0f));
    default:
      return 1.0f;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// two packed bf16 (low half first) → two floats, exactly
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__host__ __device__ constexpr int weights_total(int n_in, int width,
                                                int n_hidden, int n_out) {
  return (n_hidden > 0 ? n_in * width + (n_hidden - 1) * width * width : 0) +
         (n_hidden > 0 ? width : n_in) * n_out;
}

// float offset of the first float after the bf16 weights, 16-byte aligned
__host__ __device__ constexpr int weights_floats(int w_total) {
  return ((w_total + 7) / 8) * 4;
}

// Weights arrive as one bf16 buffer: layer 0 [n_in][W], then n_hidden-1
// layers [W][W], then the last layer [fan_in][n_out] (fan_in = W, or n_in
// without hidden layers); each matrix row-major [fan_in][fan_out].
template <int W, bool kTrain>
__global__ void __launch_bounds__(kTile)
fused_mlp_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                 float* __restrict__ y, float* __restrict__ zs,
                 long long n_rows, int n_in, int n_hidden, int n_out,
                 int w_total, int act, int out_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem_raw);
  float* sact = reinterpret_cast<float*>(smem_raw) + weights_floats(w_total);
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
    sact[i * kStride + r] = r < rows ? bf16_bits(xt[e]) : 0.0f;
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
    if (kTrain && t < rows) {
      float4* zr = reinterpret_cast<float4*>(
          zs + (static_cast<long long>(l) * n_rows + row0 + t) * W);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        zr[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                            acc[4 * q + 3]);
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
        s = fmaf(sact[i * kStride + t], bf16_bits(wl[i * n_out + o]), s);
      }
      y[(row0 + t) * n_out + o] = kTrain ? s : activate(s, out_act);
    }
  }
}

template <int W, bool kTrain>
cudaError_t launch_forward(const void* x, const void* w, void* y, void* zs,
                           long long n_rows, int n_in, int n_hidden,
                           int n_out, int act, int out_act,
                           cudaStream_t stream) {
  const int w_total = weights_total(n_in, W, n_hidden, n_out);
  const int n_act = n_in > W ? n_in : W;
  const size_t bytes = sizeof(float) * (weights_floats(w_total) +
                                        static_cast<size_t>(n_act) * kStride);
  auto kern = fused_mlp_kernel<W, kTrain>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + kTile - 1) / kTile;
  kern<<<static_cast<unsigned>(blocks), kTile, bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<float*>(y), static_cast<float*>(zs), n_rows, n_in, n_hidden,
      n_out, w_total, act, out_act);
  return cudaGetLastError();
}

// Backward. Shared memory: the bf16 weights, then sh [max(n_in, W)][kRows+1]
// (the current layer's inputs h_k, transposed) and sg [max(W, n_out)]
// [kRows+1] (its output cotangents g_z, transposed).
template <int W, int kRows>
__global__ void __launch_bounds__(kRows)
fused_mlp_backward_kernel(const uint16_t* __restrict__ x,
                          const uint16_t* __restrict__ w,
                          const float* __restrict__ zs,
                          const float* __restrict__ z_out,
                          const float* __restrict__ g, void* __restrict__ dx,
                          int dx_bf16, float* __restrict__ partials,
                          long long n_rows, int n_in, int n_hidden, int n_out,
                          int w_total, int act, int out_act) {
  constexpr int kS = kRows + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem_raw);
  float* sh = reinterpret_cast<float*>(smem_raw) + weights_floats(w_total);
  float* sg = sh + (n_in > W ? n_in : W) * kS;
  const int t = threadIdx.x;

  for (int e = t; e < w_total; e += kRows) sw[e] = w[e];

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        n_rows - row0));
  const bool live = t < rows;
  const long long row = row0 + t;
  for (int o = 0; o < n_out; ++o) {
    float gz = 0.0f;
    if (live) {
      gz = g[row * n_out + o];
      if (out_act != kNone) gz = gz * act_grad(z_out[row * n_out + o], out_act);
    }
    sg[o * kS + t] = gz;
  }
  float* part = partials + static_cast<long long>(blockIdx.x) * w_total;
  const int n_layers = n_hidden + 1;
  int w_off = w_total;
  __syncthreads();

  for (int k = n_layers - 1; k >= 0; --k) {
    const int fan_in = k == 0 ? n_in : W;
    const int fan_out = k == n_layers - 1 ? n_out : W;
    w_off -= fan_in * fan_out;
    const uint16_t* wk = sw + w_off;
    float acc[W];  // g_h, then g_z of the layer below
    if (k > 0) {
      // g_h = g_z · W_kᵀ from this thread's own column of sg
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.0f;
      for (int j = 0; j < fan_out; ++j) {
        const float gz = sg[j * kS + t];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          acc[i] = fmaf(gz, bf16_bits(wk[i * fan_out + j]), acc[i]);
        }
      }
      // the layer's input h_k = bf16(act(z_{k-1})) into sh; the cotangent
      // of z_{k-1} stays in registers until sg is free
      if (live) {
        const float4* zr = reinterpret_cast<const float4*>(
            zs + (static_cast<long long>(k - 1) * n_rows + row) * W);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 z4 = zr[q];
          const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 4 * q + c;
            sh[i * kS + t] = round_bf16(activate(z[c], act));
            acc[i] = acc[i] * act_grad(z[c], act);
          }
        }
      }
    } else {
      // dx = g_z · W_0ᵀ, then the input tile into sh (coalesced)
      if (live) {
        for (int i = 0; i < n_in; ++i) {
          float s = 0.0f;
          for (int j = 0; j < fan_out; ++j) {
            s = fmaf(sg[j * kS + t], bf16_bits(wk[i * fan_out + j]), s);
          }
          if (dx_bf16) {
            static_cast<__nv_bfloat16*>(dx)[row * n_in + i] =
                __float2bfloat16_rn(s);
          } else {
            static_cast<float*>(dx)[row * n_in + i] = s;
          }
        }
      }
      const uint16_t* xt = x + row0 * n_in;
      for (int e = t; e < rows * n_in; e += kRows) {
        const int r = e / n_in;
        sh[(e - r * n_in) * kS + r] = bf16_bits(xt[e]);
      }
    }
    __syncthreads();
    // this block's partial of dW_k = h_kᵀ g_z over its rows
    for (int e = t; e < fan_in * fan_out; e += kRows) {
      const int i = e / fan_out;
      const int j = e - i * fan_out;
      const float* hi = sh + i * kS;
      const float* gj = sg + j * kS;
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s = fmaf(hi[r], gj[r], s);
      part[w_off + e] = s;
    }
    if (k > 0) {
      __syncthreads();  // every thread is done reading sh and sg
#pragma unroll
      for (int i = 0; i < W; ++i) sg[i * kS + t] = live ? acc[i] : 0.0f;
    }
  }
}

// dw[e] = Σ_b partials[b][e], the blocks in order
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ dw, int n_blocks,
                                    int w_total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= w_total) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    s += partials[static_cast<long long>(b) * w_total + e];
  }
  dw[e] = s;
}

template <int W>
cudaError_t launch_backward(const void* x, const void* w, const void* zs,
                            const void* z_out, const void* g, void* dx,
                            int dx_bf16, void* partials, void* dw,
                            long long n_rows, int n_in, int n_hidden,
                            int n_out, int act, int out_act,
                            cudaStream_t stream) {
  // 128 rows a block; 64 at width 128, so that the weights and both
  // transposed tiles fit in shared memory
  constexpr int kRows = W == 128 ? 64 : 128;
  const int w_total = weights_total(n_in, W, n_hidden, n_out);
  const int n_h = n_in > W ? n_in : W;
  const int n_g = n_out > W ? n_out : W;
  const size_t bytes =
      sizeof(float) * (weights_floats(w_total) +
                       static_cast<size_t>(n_h + n_g) * (kRows + 1));
  auto kern = fused_mlp_backward_kernel<W, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + kRows - 1) / kRows;
  kern<<<static_cast<unsigned>(blocks), kRows, bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(zs), static_cast<const float*>(z_out),
      static_cast<const float*>(g), dx, dx_bf16, static_cast<float*>(partials),
      n_rows, n_in, n_hidden, n_out, w_total, act, out_act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(w_total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw),
      static_cast<int>(blocks), w_total);
  return cudaGetLastError();
}

bool valid_shape(int n_in, int n_hidden, int n_out) {
  return n_in > 0 && n_in <= 128 && n_out > 0 && n_hidden >= 0;
}

template <bool kTrain>
cudaError_t forward(const void* x, const void* w, void* y, void* zs,
                    long long n_rows, int n_in, int width, int n_hidden,
                    int n_out, int act, int out_act, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (!valid_shape(n_in, n_hidden, n_out)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch_forward<16, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, s);
    case 32:
      return launch_forward<32, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, s);
    case 64:
      return launch_forward<64, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, s);
    case 128:
      return launch_forward<128, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                         n_out, act, out_act, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [n_rows, n_in] bf16, w packed bf16 (layout above), y [n_rows, n_out] f32.
// width: the hidden width, one of 16, 32, 64, 128; n_in ≤ 128.
extern "C" int fused_mlp_forward(const void* x, const void* w, void* y,
                                 long long n_rows, int n_in, int width,
                                 int n_hidden, int n_out, int act, int out_act,
                                 void* stream) {
  return forward<false>(x, w, y, nullptr, n_rows, n_in, width, n_hidden,
                        n_out, act, out_act, stream);
}

// As fused_mlp_forward, without the output activation: z_out [n_rows, n_out]
// f32, and zs [n_hidden, n_rows, width] f32 the hidden pre-activations.
extern "C" int fused_mlp_train_forward(const void* x, const void* w,
                                       void* z_out, void* zs,
                                       long long n_rows, int n_in, int width,
                                       int n_hidden, int n_out, int act,
                                       void* stream) {
  return forward<true>(x, w, z_out, zs, n_rows, n_in, width, n_hidden, n_out,
                       act, kNone, stream);
}

// From the training forward's x, zs, z_out and the cotangent g [n_rows,
// n_out] f32: dx [n_rows, n_in] (bf16 if dx_bf16, else f32) and dw, the
// float32 weight gradients in the packed weight layout. partials: float32
// scratch [ceil(n_rows / tile), w_total], tile = 64 at width 128, else 128.
extern "C" int fused_mlp_backward(const void* x, const void* w, const void* zs,
                                  const void* z_out, const void* g, void* dx,
                                  int dx_bf16, void* partials, void* dw,
                                  long long n_rows, int n_in, int width,
                                  int n_hidden, int n_out, int act,
                                  int out_act, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (!valid_shape(n_in, n_hidden, n_out)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch_backward<16>(x, w, zs, z_out, g, dx, dx_bf16, partials,
                                 dw, n_rows, n_in, n_hidden, n_out, act,
                                 out_act, s);
    case 32:
      return launch_backward<32>(x, w, zs, z_out, g, dx, dx_bf16, partials,
                                 dw, n_rows, n_in, n_hidden, n_out, act,
                                 out_act, s);
    case 64:
      return launch_backward<64>(x, w, zs, z_out, g, dx, dx_bf16, partials,
                                 dw, n_rows, n_in, n_hidden, n_out, act,
                                 out_act, s);
    case 128:
      return launch_backward<128>(x, w, zs, z_out, g, dx, dx_bf16, partials,
                                  dw, n_rows, n_in, n_hidden, n_out, act,
                                  out_act, s);
    default:
      return cudaErrorInvalidValue;
  }
}
