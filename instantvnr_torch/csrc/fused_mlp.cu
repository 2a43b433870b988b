// Fused bias-free MLP for Hopper, sm_90a, on the tensor cores: inference
// forward, training forward and backward.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/fused_mlp.py
// (_pallas_forward / _kernel, with and without residuals) and its custom_vjp
// backward _bwd, an XLA matmul chain there.
//
// Every product is mma.sync.m16n8k16 with bf16 operands and float32
// accumulation. Weights are staged once per block in shared memory, each
// matrix zero-padded to whole fragments, with a row stride of 8 elements
// more than a multiple of 16 so that the 32-bit fragment loads of a warp
// hit 32 distinct banks. Grids are persistent: about SMs × occupancy
// blocks stride over the row tiles.
//
// Forward (fused_mlp_forward, fused_mlp_train_forward). Each warp owns a
// tile of 32 rows (16 at width 128). The bf16 input tile arrives in shared
// memory by cp.async, double-buffered, the next tile in flight while the
// current one is computed. Layer 0 reads its A fragments from that tile;
// from then on activations stay in registers: each layer's f32 accumulator
// fragment gets the activation, is rounded to bf16 and is re-packed as the
// A fragment of the next layer (the m16n8k16 C layout of two neighbouring
// n-tiles is the A layout of one k-tile). Rounding points are those of the
// TPU kernel (fused_mlp.py:74-86): bf16 input, f32 accumulation, act then
// bf16, an f32 last layer; only the summation order inside the tensor core
// differs. The last layer pads n_out to 8 zero columns. The training form
// writes each hidden layer's f32 pre-activation to zs [n_hidden, B, W]
// through a shared-memory tile, as coalesced 16-byte stores (zs is most of
// its bytes), and leaves the output activation to the caller.
//
// Backward (fused_mlp_backward). A block takes batches of 256 rows (64 at
// width 128), 16 rows a warp. Per layer k, from the top: the cotangent g_z
// of the layer's output (float32, transposed in shared memory, gT), the
// layer's input h_k = bf16(act(z_{k-1})) rebuilt from zs (or x), transposed
// into hT; then dW_k += h_kᵀ g_z over the batch's rows, each warp on its
// own 16 × 8 tiles of dW_k; g_h = g_z · W_kᵀ over the warp's rows; g_z of
// the layer below = g_h · act'(z_{k-1}); at layer 0, dx = g_h rounded to
// x's type. The cotangents stay float32-accurate (_bwd runs them at
// Precision.HIGHEST; rounding them to bf16 cost the TPU about 5 dB): in
// every product the other operand is exactly bf16 (W, or the
// bf16-rounded h_k), and the f32 cotangent is split into three bf16 terms
// g = g0 + g1 + g2 (+ a rest below 2^-27 |g|), each multiplied exactly by
// the tensor core, three MMAs with f32 accumulation per product. Each block
// accumulates dW of every layer in shared memory across its batches and
// writes one partial; a second kernel sums the partials in block order, so
// two runs give the same bits (no float atomics). Where every layer's dW
// does not fit next to the weights (width 128), each batch writes its own
// partial instead.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the inference forward of
// a 262,144-row blob moves 34.6 MB (10.3 µs) for 8.62 GFLOP (8.7 µs); the
// training forward at B = 65,536 moves 75.8 MB (22.6 µs, zs 67 MB); the
// backward at B = 65,536 moves about 84 MB (25 µs) for 3 × 4.31 GFLOP of
// bf16 MMAs (13 µs): all three are bytes-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Act { kNone = 0, kRelu = 1, kSine = 2, kSquareplus = 3 };

// The activations, one instantiation each: hot loops dispatch on the
// activation once per fragment, so that each runs straight-line code (a
// switch per element would interleave every case, sinf's slow path
// included, and the unrolled fragment loops would miss in the instruction
// cache on every element).
template <int A>
__device__ __forceinline__ float act_t(float h) {
  if (A == kRelu) return fmaxf(h, 0.0f);
  if (A == kSine) return sinf(h);
  if (A == kSquareplus) return 0.5f * (h + sqrtf(h * h + 4.0f));
  return h;
}

// d act(z) / dz (fused_mlp.py _act_grad); ReLU's is 0 at z = 0
template <int A>
__device__ __forceinline__ float act_grad_t(float z) {
  if (A == kRelu) return z > 0.0f ? 1.0f : 0.0f;
  if (A == kSine) return cosf(z);
  if (A == kSquareplus) return 0.5f * (1.0f + z * rsqrtf(z * z + 4.0f));
  return 1.0f;
}

__device__ __forceinline__ float activate(float h, int act) {
  switch (act) {
    case kRelu:
      return act_t<kRelu>(h);
    case kSine:
      return act_t<kSine>(h);
    case kSquareplus:
      return act_t<kSquareplus>(h);
    default:
      return h;
  }
}

__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case kRelu:
      return act_grad_t<kRelu>(z);
    case kSine:
      return act_grad_t<kSine>(z);
    case kSquareplus:
      return act_grad_t<kSquareplus>(z);
    default:
      return 1.0f;
  }
}

__host__ __device__ constexpr int pad_to(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr int weights_total(int n_in, int width,
                                                int n_hidden, int n_out) {
  return (n_hidden > 0 ? n_in * width + (n_hidden - 1) * width * width : 0) +
         (n_hidden > 0 ? width : n_in) * n_out;
}

__host__ __device__ constexpr int fan_in_of(int l, int n_in, int width) {
  return l == 0 ? n_in : width;
}

__host__ __device__ constexpr int fan_out_of(int l, int width, int n_hidden,
                                             int n_out) {
  return l == n_hidden ? n_out : width;
}

// offset of layer l in the packed [fan_in][fan_out] weight buffer
__host__ __device__ constexpr int packed_offset(int l, int n_in, int width) {
  return l == 0 ? 0 : n_in * width + (l - 1) * width * width;
}

// (low, high) → two bf16, rounded to nearest, low half first (in a
// register: a bf16x2 value whose address is taken would go to local memory)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the three-term bf16 split of two floats, packed: v = t0 + t1 + t2 + rest,
// |rest| ≤ 2^-27 |v| (each subtraction is exact)
__device__ __forceinline__ void split3(float a, float b, uint32_t (&p)[3]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    p[s] = pack_bf16(a, b);
    a = a - __uint_as_float(p[s] << 16);
    b = b - __uint_as_float(p[s] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b, one m16n8k16 tile: bf16 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loads (g = lane / 4, t = lane % 4). A 16 × 16 from a row-major
// bf16 tile s[row][k] of stride ld: rows g, g + 8; columns k0 + 2t (+1), +8.
__device__ __forceinline__ void lds_a(const uint16_t* s, int ld, int k0,
                                      int g, int t, uint32_t (&a)[4]) {
  const uint16_t* p = s + g * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B 16 × 8 from an n-major bf16 matrix s[n][k] of stride ld: column n0 + g,
// rows k0 + 2t (+1) and k0 + 2t + 8 (+1)
__device__ __forceinline__ void lds_b(const uint16_t* s, int ld, int n0,
                                      int k0, int g, int t, uint32_t& b0,
                                      uint32_t& b1) {
  const uint16_t* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = lds32(p);
  b1 = lds32(p + 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Persistent grid size: SMs × resident blocks of `kern` at this shared
// memory (which also sets the kernel's shared-memory limit), cached for the
// last kernel, device and size seen by this signature.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kern, int threads, size_t bytes,
                              int* blocks) {
  static const void* s_kern = nullptr;
  static int s_dev = -1;
  static size_t s_bytes = 0;
  static int s_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* k = reinterpret_cast<const void*>(kern);
  if (k != s_kern || dev != s_dev || bytes != s_bytes) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    int occ = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    s_kern = k;
    s_dev = dev;
    s_bytes = bytes;
    s_blocks = occ * sms;
  }
  *blocks = s_blocks;
  return cudaSuccess;
}

// Layer of element e of the packed weights, and that layer's first element.
__device__ __forceinline__ int layer_of(int e, int n_in, int width,
                                        int n_hidden, int n_out, int& off) {
  int l = 0;
  off = 0;
  while (l < n_hidden && e >= off + fan_in_of(l, n_in, width) *
                                        fan_out_of(l, width, n_hidden, n_out)) {
    off += fan_in_of(l, n_in, width) * fan_out_of(l, width, n_hidden, n_out);
    ++l;
  }
  return l;
}

// Copy the packed bf16 weights (16-byte aligned) into a zeroed shared-memory
// image: element (row k, column n) of layer l's [fan_in][fan_out] goes to
// sw[at(l, k, n)]. 16-byte loads, four in flight per thread; a layer starts
// on an 8-element bound (fan_in × fan_out is a multiple of 8 wherever a
// hidden width is a factor), so a load never spans two layers.
template <typename At>
__device__ __forceinline__ void stage_weights(const uint16_t* __restrict__ w,
                                              uint16_t* sw, int n_in,
                                              int width, int n_hidden,
                                              int n_out, At at) {
  const int total = weights_total(n_in, width, n_hidden, n_out);
  const int chunks = total / 8;
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  for (int c0 = threadIdx.x; c0 < chunks; c0 += 4 * blockDim.x) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < chunks) v[u] = __ldg(w4 + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c >= chunks) continue;
      int off;
      const int l = layer_of(8 * c, n_in, width, n_hidden, n_out, off);
      const int fo = fan_out_of(l, width, n_hidden, n_out);
      const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = 8 * c + q - off, k = r / fo;
        sw[at(l, k, r - k * fo)] =
            static_cast<uint16_t>(words[q >> 1] >> (16 * (q & 1)));
      }
    }
  }
  for (int e = 8 * chunks + threadIdx.x; e < total; e += blockDim.x) {
    int off;
    const int l = layer_of(e, n_in, width, n_hidden, n_out, off);
    const int fo = fan_out_of(l, width, n_hidden, n_out);
    const int k = (e - off) / fo;
    sw[at(l, k, e - off - k * fo)] = w[e];
  }
}

// zero n_bytes (a multiple of 16) of 16-byte aligned shared memory
__device__ __forceinline__ void zero_smem(void* p, int n_bytes) {
  for (int e = threadIdx.x; e < n_bytes / 16; e += blockDim.x) {
    reinterpret_cast<uint4*>(p)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// Forward

constexpr int kFwdWarps = 4;

// Shared-memory image of the forward's weights, in bf16 elements: each
// layer transposed to [fan_out][fan_in] (n-major, k contiguous). Layer 0
// [W][ld0], hidden layers [W][W + 8], the last [pad8(n_out)][W + 8] (or
// [pad8(n_out)][ld0] without hidden layers). ld0 = pad16(n_in) + 8.
struct FwdLayout {
  int k0, ld0, n_last, off_last, elems;
};

__host__ __device__ inline FwdLayout fwd_layout(int n_in, int width,
                                                int n_hidden, int n_out) {
  FwdLayout L;
  L.k0 = pad_to(n_in, 16);
  L.ld0 = L.k0 + 8;
  L.n_last = pad_to(n_out, 8);
  L.off_last = n_hidden > 0 ? width * L.ld0 + (n_hidden - 1) * width *
                                                  (width + 8)
                            : 0;
  L.elems = L.off_last + L.n_last * (n_hidden > 0 ? width + 8 : L.ld0);
  return L;
}

__host__ __device__ inline int fwd_weight_offset(const FwdLayout& L, int l,
                                                 int width, int n_hidden) {
  if (l == n_hidden) return L.off_last;
  return l == 0 ? 0 : width * L.ld0 + (l - 1) * width * (width + 8);
}

template <int W, bool kTrain>
struct FwdTile {
  static constexpr int kM = W <= 64 ? 2 : 1;  // 16-row m-tiles per warp
  static constexpr int kRows = 16 * kM;
  static constexpr int kNT = W / 8;   // n-tiles of a hidden layer
  static constexpr int kKT = W / 16;  // k-tiles of a hidden layer's input

  // bytes of shared memory: weights, then per warp two input buffers
  // [kRows][ld0] bf16 and (training) a pre-activation tile [kRows][W + 8]
  static size_t bytes(const FwdLayout& L) {
    return static_cast<size_t>(pad_to(2 * L.elems, 16)) +
           kFwdWarps * (2 * kRows * L.ld0 * 2 +
                        (kTrain ? kRows * (W + 8) * 4 : 0));
  }
};

// bf16(act(C)) of one layer's accumulators, re-packed as the next layer's
// A fragments: the C of n-tiles 2kk and 2kk + 1 is the A of k-tile kk
template <int A, int kM, int kNT, int kKT>
__device__ __forceinline__ void act_to_a(const float (&acc)[kM][kNT][4],
                                         uint32_t (&h)[kM][kKT][4]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = 2 * kk + (q >> 1), c = 2 * (q & 1);
        h[m][kk][q] = pack_bf16(act_t<A>(acc[m][n][c]),
                                act_t<A>(acc[m][n][c + 1]));
      }
    }
  }
}

template <int W, bool kTrain>
__global__ void __launch_bounds__(kFwdWarps * 32)
fused_mlp_forward_kernel(const uint16_t* __restrict__ x,
                         const uint16_t* __restrict__ w,
                         float* __restrict__ y, float* __restrict__ zs,
                         long long n_rows, int n_in, int n_hidden, int n_out,
                         int act, int out_act, const int* __restrict__ count,
                         long long offset) {
  using T = FwdTile<W, kTrain>;
  if (count != nullptr) {
    // the device-side count form (inference only: the training form's zs
    // stride is n_rows): rows [offset, offset + n_rows) below *count; the
    // tiles past them are never loaded, and their rows of y never written
    const long long live = static_cast<long long>(*count) - offset;
    n_rows = live < 0 ? 0 : (live < n_rows ? live : n_rows);
  }
  constexpr int kM = T::kM, kRows = T::kRows, kNT = T::kNT, kKT = T::kKT;
  constexpr int kZ = W + 8;  // pre-activation tile stride (floats)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdLayout L = fwd_layout(n_in, W, n_hidden, n_out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* sw = reinterpret_cast<uint16_t*>(smem_raw);
  unsigned char* per_warp = smem_raw + pad_to(2 * L.elems, 16);
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(per_warp) +
                   warp * 2 * kRows * L.ld0;
  float* zst = reinterpret_cast<float*>(per_warp +
                                        kFwdWarps * 2 * kRows * L.ld0 * 2) +
               warp * kRows * kZ;

  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  const long long stride = static_cast<long long>(gridDim.x) * kFwdWarps;
  const bool vec = n_in % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // rows of tile `tile` into buffer `dst`; rows past the end read as zero
  auto load_tile = [&](long long tile, uint16_t* dst) {
    const long long row0 = tile * kRows;
    if (vec) {
      const int cpr = n_in / 8;  // 16-byte chunks per row
      for (int e = lane; e < kRows * cpr; e += 32) {
        const int r = e / cpr, c = e - r * cpr;
        const bool ok = row0 + r < n_rows;
        cp_async16(dst + r * L.ld0 + c * 8,
                   ok ? x + (row0 + r) * n_in + c * 8 : x, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < kRows * n_in; e += 32) {
        const int r = e / n_in, c = e - r * n_in;
        dst[r * L.ld0 + c] =
            row0 + r < n_rows ? x[(row0 + r) * n_in + c] : uint16_t(0);
      }
    }
  };

  // one output fragment of the last layer (columns n0..n0+7) to y
  auto store_out = [&](const float (&o)[kM][4], long long row0, int n0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long row = row0 + m * 16 + g + (q >> 1) * 8;
        const int col = n0 + 2 * t + (q & 1);
        if (row < n_rows && col < n_out) {
          y[row * n_out + col] = kTrain ? o[m][q] : activate(o[m][q],
                                                             out_act);
        }
      }
    }
  };

  // the input buffers' padding columns stay zero from here on
  for (int e = lane; e < 2 * kRows * L.ld0; e += 32) xbuf[e] = 0;
  __syncwarp();
  long long tile = static_cast<long long>(blockIdx.x) * kFwdWarps + warp;
  int buf = 0;
  if (tile < n_tiles) load_tile(tile, xbuf);  // in flight during staging
  cp_async_commit();

  // the weights, transposed into the zero-padded image
  zero_smem(sw, pad_to(2 * L.elems, 16));
  __syncthreads();
  stage_weights(w, sw, n_in, W, n_hidden, n_out, [=](int l, int k, int n) {
    return fwd_weight_offset(L, l, W, n_hidden) +
           n * (l == 0 ? L.ld0 : W + 8) + k;
  });
  __syncthreads();
  for (; tile < n_tiles; tile += stride, buf ^= 1) {
    if (tile + stride < n_tiles) {
      load_tile(tile + stride, xbuf + (buf ^ 1) * kRows * L.ld0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const uint16_t* xs = xbuf + buf * kRows * L.ld0;
    const long long row0 = tile * kRows;

    if (n_hidden == 0) {  // one matrix: A straight from the input tile
      for (int n0 = 0; n0 < L.n_last; n0 += 8) {
        float o[kM][4] = {};
        for (int k0 = 0; k0 < L.k0; k0 += 16) {
          uint32_t b0, b1;
          lds_b(sw, L.ld0, n0, k0, g, t, b0, b1);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            uint32_t a[4];
            lds_a(xs + m * 16 * L.ld0, L.ld0, k0, g, t, a);
            mma(o[m], a, b0, b1);
          }
        }
        store_out(o, row0, n0);
      }
      __syncwarp();
      continue;
    }

    // layer 0: A from the input tile
    float acc[kM][kNT][4];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.0f;
    for (int k0 = 0; k0 < L.k0; k0 += 16) {
      uint32_t a[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) lds_a(xs + m * 16 * L.ld0, L.ld0, k0, g, t,
                                         a[m]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0, b1;
        lds_b(sw, L.ld0, n * 8, k0, g, t, b0, b1);
#pragma unroll
        for (int m = 0; m < kM; ++m) mma(acc[m][n], a[m], b0, b1);
      }
    }

    uint32_t h[kM][kKT][4];  // the next layer's A fragments
    for (int l = 0; l < n_hidden; ++l) {
      if (kTrain) {  // pre-activations → zs, 16-byte coalesced stores
#pragma unroll
        for (int m = 0; m < kM; ++m) {
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            float* p = zst + (m * 16 + g) * kZ + n * 8 + 2 * t;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[m][n][0], acc[m][n][1]);
            *reinterpret_cast<float2*>(p + 8 * kZ) =
                make_float2(acc[m][n][2], acc[m][n][3]);
          }
        }
        __syncwarp();
        float* zl = zs + static_cast<long long>(l) * n_rows * W;
        constexpr int kV = W / 4;  // float4 per row
        for (int e = lane; e < kRows * kV; e += 32) {
          const int r = e / kV, c = e - r * kV;
          if (row0 + r < n_rows) {
            *reinterpret_cast<float4*>(zl + (row0 + r) * W + c * 4) =
                *reinterpret_cast<const float4*>(zst + r * kZ + c * 4);
          }
        }
        __syncwarp();
      }
      switch (act) {
        case kRelu:
          act_to_a<kRelu>(acc, h);
          break;
        case kSine:
          act_to_a<kSine>(acc, h);
          break;
        case kSquareplus:
          act_to_a<kSquareplus>(acc, h);
          break;
        default:
          act_to_a<kNone>(acc, h);
      }
      if (l + 1 == n_hidden) break;
      const uint16_t* wl = sw + fwd_weight_offset(L, l + 1, W, n_hidden);
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          uint32_t b0, b1;
          lds_b(wl, W + 8, n * 8, kk * 16, g, t, b0, b1);
#pragma unroll
          for (int m = 0; m < kM; ++m) mma(acc[m][n], h[m][kk], b0, b1);
        }
      }
    }

    // the last layer, f32, A from registers
    const uint16_t* wo = sw + L.off_last;
    for (int n0 = 0; n0 < L.n_last; n0 += 8) {
      float o[kM][4] = {};
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        uint32_t b0, b1;
        lds_b(wo, W + 8, n0, kk * 16, g, t, b0, b1);
#pragma unroll
        for (int m = 0; m < kM; ++m) mma(o[m], h[m][kk], b0, b1);
      }
      store_out(o, row0, n0);
    }
    __syncwarp();  // every lane is done with this buffer before it refills
  }
  cp_async_wait<0>();
}

template <int W, bool kTrain>
cudaError_t launch_forward(const void* x, const void* w, void* y, void* zs,
                           long long n_rows, int n_in, int n_hidden,
                           int n_out, int act, int out_act, const int* count,
                           long long offset, cudaStream_t stream) {
  using T = FwdTile<W, kTrain>;
  const size_t bytes = T::bytes(fwd_layout(n_in, W, n_hidden, n_out));
  auto kern = fused_mlp_forward_kernel<W, kTrain>;
  int max_blocks = 0;
  cudaError_t err = persistent_blocks(kern, kFwdWarps * 32, bytes,
                                      &max_blocks);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_rows + T::kRows - 1) / T::kRows;
  const long long want = (tiles + kFwdWarps - 1) / kFwdWarps;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  kern<<<blocks, kFwdWarps * 32, bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<float*>(y), static_cast<float*>(zs), n_rows, n_in, n_hidden,
      n_out, act, out_act, count, offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward

template <int W>
struct BwdTile {
  static constexpr int kWarps = W == 128 ? 4 : 16;
  static constexpr int kBatch = kWarps * 16;  // rows a block takes at once
  static constexpr int kLd = kBatch + 8;      // stride of hT and gT
};

// dW accumulator stride: ≥ pad8(fan_out) and ≡ 8 mod 32, so that the
// float2 C loads of a half-warp hit distinct banks
__host__ __device__ constexpr int acc_stride(int fo) {
  return (pad_to(fo, 8) + 23) / 32 * 32 + 8;
}

// Shared memory of the backward: gT [kmax][kLd] f32 (the cotangents of the
// batch's rows, transposed), the dW accumulators (each layer
// [pad16(fan_in)][acc_stride(fan_out)] f32, when they fit), the bf16
// weights as packed (each layer [pad16(fan_in)][pad16(fan_out) + 8]), hT
// [rmax][kLd] bf16 (the layer inputs, transposed).
struct BwdLayout {
  int w_elems, acc_floats, rmax, kmax;
};

__host__ __device__ inline BwdLayout bwd_layout(int n_in, int width,
                                                int n_hidden, int n_out) {
  BwdLayout L = {0, 0, 0, 0};
  for (int l = 0; l <= n_hidden; ++l) {
    const int fi = pad_to(fan_in_of(l, n_in, width), 16);
    const int fo = fan_out_of(l, width, n_hidden, n_out);
    L.w_elems += fi * (pad_to(fo, 16) + 8);
    L.acc_floats += fi * acc_stride(fo);
    L.rmax = L.rmax > fi ? L.rmax : fi;
    L.kmax = L.kmax > pad_to(fo, 16) ? L.kmax : pad_to(fo, 16);
  }
  L.w_elems = pad_to(L.w_elems, 8);
  return L;
}

// offsets of layer k in the staged weights and in the accumulators
__device__ inline void bwd_offsets(int k, int n_in, int width, int n_hidden,
                                   int n_out, int& w_off, int& a_off) {
  w_off = a_off = 0;
  for (int l = 0; l < k; ++l) {
    const int fi = pad_to(fan_in_of(l, n_in, width), 16);
    const int fo = fan_out_of(l, width, n_hidden, n_out);
    w_off += fi * (pad_to(fo, 16) + 8);
    a_off += fi * acc_stride(fo);
  }
}

__device__ __forceinline__ uint16_t bf16_raw(float v) {
  return static_cast<uint16_t>(pack_bf16(v, 0.0f));
}

// A 16 × 16 of the cotangent for this warp's rows from gT (transposed, at
// the warp's first row), split into three bf16 terms
template <int kLd>
__device__ __forceinline__ void lda_split(const float* gTw, int k0, int gi,
                                          int t, uint32_t (&a)[3][4]) {
  const float* p = gTw + (k0 + 2 * t) * kLd + gi;
  const float v[4][2] = {{p[0], p[kLd]},
                         {p[8], p[kLd + 8]},
                         {p[8 * kLd], p[9 * kLd]},
                         {p[8 * kLd + 8], p[9 * kLd + 8]}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t s[3];
    split3(v[q][0], v[q][1], s);
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j][q] = s[j];
  }
}

// From this lane's z_{k-1} fragment: the layer input bf16(act(z)) into hT
// (transposed, at the warp's first row), and g_h · act'(z) in place
template <int A, int kLd, int kNT>
__device__ __forceinline__ void rebuild(const float2 (&zr)[kNT][2],
                                        float (&gh)[kNT][4], uint16_t* hTw,
                                        int gi, int t) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gi + 8 * half, col = n * 8 + 2 * t;
      const float2 z = zr[n][half];
      hTw[col * kLd + r] = bf16_raw(act_t<A>(z.x));
      hTw[(col + 1) * kLd + r] = bf16_raw(act_t<A>(z.y));
      gh[n][2 * half] = gh[n][2 * half] * act_grad_t<A>(z.x);
      gh[n][2 * half + 1] = gh[n][2 * half + 1] * act_grad_t<A>(z.y);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(BwdTile<W>::kWarps * 32)
fused_mlp_backward_kernel(const uint16_t* __restrict__ x,
                          const uint16_t* __restrict__ w,
                          const float* __restrict__ zs,
                          const float* __restrict__ z_out,
                          const float* __restrict__ g, void* __restrict__ dx,
                          int dx_bf16, float* __restrict__ partials,
                          long long n_rows, int n_in, int n_hidden, int n_out,
                          int act, int out_act, int block_acc) {
  using T = BwdTile<W>;
  constexpr int kWarps = T::kWarps, kBatch = T::kBatch, kLd = T::kLd;
  constexpr int kNT = W / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdLayout L = bwd_layout(n_in, W, n_hidden, n_out);
  const int w_total = weights_total(n_in, W, n_hidden, n_out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  float* gT = reinterpret_cast<float*>(smem_raw);
  float* acc = gT + L.kmax * kLd;
  uint16_t* sw = reinterpret_cast<uint16_t*>(
      acc + (block_acc ? L.acc_floats : 0));
  uint16_t* hT = sw + L.w_elems;

  // the weights as packed, into the zero-padded image; the accumulators
  zero_smem(sw, 2 * L.w_elems);
  if (block_acc) zero_smem(acc, 4 * L.acc_floats);
  __syncthreads();
  stage_weights(w, sw, n_in, W, n_hidden, n_out, [=](int l, int k, int n) {
    int w_off, a_off;
    bwd_offsets(l, n_in, W, n_hidden, n_out, w_off, a_off);
    return w_off + k * (pad_to(fan_out_of(l, W, n_hidden, n_out), 16) + 8) +
           n;
  });
  __syncthreads();

  const long long n_batches = (n_rows + kBatch - 1) / kBatch;
  const int rw = warp * 16;  // this warp's rows within the batch
  const bool vec = n_in % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (long long bt = blockIdx.x; bt < n_batches; bt += gridDim.x) {
    const long long row0 = bt * kBatch + rw;
    // the top layer's cotangent g · out_act'(z_out) into gT, zero-padded
    for (int e = lane; e < 16 * n_out; e += 32) {
      const int r = e / n_out, j = e - r * n_out;
      const long long row = row0 + r;
      float v = 0.0f;
      if (row < n_rows) {
        v = g[row * n_out + j];
        if (out_act != kNone) {
          v = v * act_grad(z_out[row * n_out + j], out_act);
        }
      }
      gT[j * kLd + rw + r] = v;
    }
    for (int e = 16 * n_out + lane; e < 16 * pad_to(n_out, 16); e += 32) {
      gT[(e >> 4) * kLd + rw + (e & 15)] = 0.0f;
    }
    __syncwarp();

    for (int k = n_hidden; k >= 0; --k) {
      const int fi = fan_in_of(k, n_in, W);
      const int fo = fan_out_of(k, W, n_hidden, n_out);
      const int kpad = pad_to(fo, 16), ldw = kpad + 8;
      int w_off, a_off;
      bwd_offsets(k, n_in, W, n_hidden, n_out, w_off, a_off);
      const uint16_t* wk = sw + w_off;
      float gh[kNT][4];  // g_h, then the cotangent of the layer below
      if (k > 0) {
        // z_{k-1} of this lane's fragment, loaded before the products
        const float* zk = zs + static_cast<long long>(k - 1) * n_rows * W;
        float2 zr[kNT][2];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long row = row0 + gi + 8 * half;
            zr[n][half] =
                row < n_rows ? *reinterpret_cast<const float2*>(
                                   zk + row * W + n * 8 + 2 * t)
                             : make_float2(0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) gh[n][q] = 0.0f;
        for (int k0 = 0; k0 < kpad; k0 += 16) {
          uint32_t a[3][4];
          lda_split<kLd>(gT + rw, k0, gi, t, a);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t b0, b1;
            lds_b(wk, ldw, n * 8, k0, gi, t, b0, b1);
#pragma unroll
            for (int s = 2; s >= 0; --s) mma(gh[n], a[s], b0, b1);
          }
        }
        // the layer's input bf16(act(z_{k-1})) into hT, and act'(z)
        switch (act) {
          case kRelu:
            rebuild<kRelu, kLd>(zr, gh, hT + rw, gi, t);
            break;
          case kSine:
            rebuild<kSine, kLd>(zr, gh, hT + rw, gi, t);
            break;
          case kSquareplus:
            rebuild<kSquareplus, kLd>(zr, gh, hT + rw, gi, t);
            break;
          default:
            rebuild<kNone, kLd>(zr, gh, hT + rw, gi, t);
        }
      } else {
        // dx = g_z · W_0ᵀ, rounded to x's type: 4 column tiles at once
        for (int n0 = 0; n0 < pad_to(n_in, 8); n0 += 32) {
          float d[4][4] = {};
          for (int k0 = 0; k0 < kpad; k0 += 16) {
            uint32_t a[3][4];
            lda_split<kLd>(gT + rw, k0, gi, t, a);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (n0 + 8 * u >= n_in) continue;
              uint32_t b0, b1;
              lds_b(wk, ldw, n0 + 8 * u, k0, gi, t, b0, b1);
#pragma unroll
              for (int s = 2; s >= 0; --s) mma(d[u], a[s], b0, b1);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const long long row = row0 + gi + (q >> 1) * 8;
              const int col = n0 + 8 * u + 2 * t + (q & 1);
              if (row < n_rows && col < n_in) {
                if (dx_bf16) {
                  static_cast<__nv_bfloat16*>(dx)[row * n_in + col] =
                      __float2bfloat16_rn(d[u][q]);
                } else {
                  static_cast<float*>(dx)[row * n_in + col] = d[u][q];
                }
              }
            }
          }
        }
        // the layer's input x into hT, transposed; zero past the last row
        // and in the padding columns
        if (vec) {
          const int cpr = n_in / 8;  // 16-byte chunks per row
#pragma unroll 4
          for (int e = lane; e < 16 * cpr; e += 32) {
            const int r = e / cpr, c = e - r * cpr;
            const uint4 v = row0 + r < n_rows
                                ? __ldg(reinterpret_cast<const uint4*>(
                                      x + (row0 + r) * n_in) + c)
                                : make_uint4(0u, 0u, 0u, 0u);
            const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              hT[(8 * c + q) * kLd + rw + r] =
                  static_cast<uint16_t>(words[q >> 1] >> (16 * (q & 1)));
            }
          }
          for (int e = 16 * n_in + lane; e < 16 * pad_to(n_in, 16); e += 32) {
            hT[(e >> 4) * kLd + rw + (e & 15)] = 0;
          }
        } else {
          for (int e = lane; e < 16 * pad_to(n_in, 16); e += 32) {
            const int r = e & 15, i = e >> 4;
            const long long row = row0 + r;
            hT[i * kLd + rw + r] =
                i < n_in && row < n_rows ? x[row * n_in + i] : uint16_t(0);
          }
        }
      }
      __syncthreads();  // every warp's rows of hT and gT are in place

      // dW_k += h_kᵀ g_z over the batch: A = hT (m = fan_in, k = rows),
      // B = gT (k = rows, n = fan_out). A job is one 8-column strip of dW_k
      // over up to 4 row blocks of 16: the split B fragment is shared, and
      // the 4 accumulator chains are independent. Each warp its own jobs.
      const int mt = pad_to(fi, 16) / 16, nt = pad_to(fo, 8) / 8;
      const int lda = acc_stride(fo);
      for (int job = warp; job < nt * ((mt + 3) / 4); job += kWarps) {
        const int j0 = (job % nt) * 8, ib = (job / nt) * 4;
        float c[4][4] = {};
        if (block_acc) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (ib + u >= mt) continue;
            const float* c_lo =
                acc + a_off + ((ib + u) * 16 + gi) * lda + j0 + 2 * t;
            const float2 lo = *reinterpret_cast<const float2*>(c_lo);
            const float2 hi =
                *reinterpret_cast<const float2*>(c_lo + 8 * lda);
            c[u][0] = lo.x;
            c[u][1] = lo.y;
            c[u][2] = hi.x;
            c[u][3] = hi.y;
          }
        }
        for (int r0 = 0; r0 < kBatch; r0 += 16) {
          const float* gp = gT + (j0 + gi) * kLd + r0 + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(gp);
          const float2 v1 = *reinterpret_cast<const float2*>(gp + 8);
          uint32_t b0[3], b1[3];
          split3(v0.x, v0.y, b0);
          split3(v1.x, v1.y, b1);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (ib + u >= mt) continue;
            uint32_t a[4];
            lds_a(hT + (ib + u) * 16 * kLd, kLd, r0, gi, t, a);
#pragma unroll
            for (int s = 2; s >= 0; --s) mma(c[u], a, b0[s], b1[s]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ib + u >= mt) continue;
          const int i0 = (ib + u) * 16;
          if (block_acc) {
            float* c_lo = acc + a_off + (i0 + gi) * lda + j0 + 2 * t;
            *reinterpret_cast<float2*>(c_lo) = make_float2(c[u][0], c[u][1]);
            *reinterpret_cast<float2*>(c_lo + 8 * lda) =
                make_float2(c[u][2], c[u][3]);
          } else {  // this batch's own partial
            float* part =
                partials + bt * w_total + packed_offset(k, n_in, W);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = i0 + gi + (q >> 1) * 8, j = j0 + 2 * t + (q & 1);
              if (i < fi && j < fo) part[i * fo + j] = c[u][q];
            }
          }
        }
      }
      __syncthreads();  // every warp is done reading hT and gT

      if (k > 0) {  // the cotangent of the layer below into gT
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = gi + (q >> 1) * 8, col = n * 8 + 2 * t + (q & 1);
            gT[col * kLd + rw + r] = gh[n][q];
          }
        }
        __syncwarp();
      }
    }
  }

  if (block_acc) {  // this block's partial, in the packed weight layout
    float* part = partials + static_cast<long long>(blockIdx.x) * w_total;
    for (int l = 0, a_off = 0; l <= n_hidden; ++l) {
      const int fi = fan_in_of(l, n_in, W);
      const int fo = fan_out_of(l, W, n_hidden, n_out);
      const int lda = acc_stride(fo);
      const int po = packed_offset(l, n_in, W);
      for (int e = threadIdx.x; e < fi * fo; e += blockDim.x) {
        const int i = e / fo, j = e - i * fo;
        part[po + e] = acc[a_off + i * lda + j];
      }
      a_off += pad_to(fi, 16) * lda;
    }
  }
}

// dw[e] = Σ_b partials[b][e], the partials in order
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ dw, int n_parts,
                                    int w_total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= w_total) return;
  float s = 0.0f;
  for (int b = 0; b < n_parts; ++b) {
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
  using T = BwdTile<W>;
  const BwdLayout L = bwd_layout(n_in, W, n_hidden, n_out);
  const int w_total = weights_total(n_in, W, n_hidden, n_out);
  const size_t base = 4 * static_cast<size_t>(L.kmax) * T::kLd +
                      2 * static_cast<size_t>(L.w_elems) +
                      2 * static_cast<size_t>(L.rmax) * T::kLd;
  const size_t with_acc = base + 4 * static_cast<size_t>(L.acc_floats);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // each block's dW in shared memory where it fits, else one per batch
  const int block_acc = with_acc <= static_cast<size_t>(optin);
  const size_t bytes = block_acc ? with_acc : base;
  auto kern = fused_mlp_backward_kernel<W>;
  int max_blocks = 0;
  err = persistent_blocks(kern, T::kWarps * 32, bytes, &max_blocks);
  if (err != cudaSuccess) return err;
  const long long batches = (n_rows + T::kBatch - 1) / T::kBatch;
  const int blocks =
      static_cast<int>(batches < max_blocks ? batches : max_blocks);
  kern<<<blocks, T::kWarps * 32, bytes, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(zs), static_cast<const float*>(z_out),
      static_cast<const float*>(g), dx, dx_bf16, static_cast<float*>(partials),
      n_rows, n_in, n_hidden, n_out, act, out_act, block_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(w_total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dw),
      block_acc ? blocks : static_cast<int>(batches), w_total);
  return cudaGetLastError();
}

// the kernels read the packed weights with 16-byte loads
bool valid_shape(const void* w, int n_in, int n_hidden, int n_out) {
  return n_in > 0 && n_in <= 128 && n_out > 0 && n_hidden >= 0 &&
         (reinterpret_cast<uintptr_t>(w) & 15) == 0;
}

template <bool kTrain>
cudaError_t forward(const void* x, const void* w, void* y, void* zs,
                    long long n_rows, int n_in, int width, int n_hidden,
                    int n_out, int act, int out_act, const int* count,
                    long long offset, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (!valid_shape(w, n_in, n_hidden, n_out)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16:
      return launch_forward<16, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, count, offset,
                                        s);
    case 32:
      return launch_forward<32, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, count, offset,
                                        s);
    case 64:
      return launch_forward<64, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                        n_out, act, out_act, count, offset,
                                        s);
    case 128:
      return launch_forward<128, kTrain>(x, w, y, zs, n_rows, n_in, n_hidden,
                                         n_out, act, out_act, count, offset,
                                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [n_rows, n_in] bf16, w packed bf16 (each matrix row-major [fan_in]
// [fan_out], layer 0 first; 16-byte aligned), y [n_rows, n_out] f32.
// count: null, or an int32 on the device: then only the rows i < *count -
// offset are computed, and the rows of y past them are left as they were.
// width: the hidden width, one of 16, 32, 64, 128; n_in ≤ 128.
extern "C" int fused_mlp_forward(const void* x, const void* w, void* y,
                                 long long n_rows, int n_in, int width,
                                 int n_hidden, int n_out, int act, int out_act,
                                 const void* count, long long offset,
                                 void* stream) {
  return forward<false>(x, w, y, nullptr, n_rows, n_in, width, n_hidden,
                        n_out, act, out_act, static_cast<const int*>(count),
                        offset, stream);
}

// As fused_mlp_forward, without the output activation: z_out [n_rows, n_out]
// f32, and zs [n_hidden, n_rows, width] f32 the hidden pre-activations.
extern "C" int fused_mlp_train_forward(const void* x, const void* w,
                                       void* z_out, void* zs,
                                       long long n_rows, int n_in, int width,
                                       int n_hidden, int n_out, int act,
                                       void* stream) {
  return forward<true>(x, w, z_out, zs, n_rows, n_in, width, n_hidden, n_out,
                       act, kNone, nullptr, 0, stream);
}

// From the training forward's x, zs, z_out and the cotangent g [n_rows,
// n_out] f32: dx [n_rows, n_in] (bf16 if dx_bf16, else f32) and dw, the
// float32 weight gradients in the packed weight layout. partials: float32
// scratch [ceil(n_rows / batch), w_total], batch = 64 rows at width 128,
// else 256.
extern "C" int fused_mlp_backward(const void* x, const void* w, const void* zs,
                                  const void* z_out, const void* g, void* dx,
                                  int dx_bf16, void* partials, void* dw,
                                  long long n_rows, int n_in, int width,
                                  int n_hidden, int n_out, int act,
                                  int out_act, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (!valid_shape(w, n_in, n_hidden, n_out)) return cudaErrorInvalidValue;
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
