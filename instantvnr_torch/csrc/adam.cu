// Adam's update for Hopper, sm_90a: one streaming pass over a group of up
// to kMaxLeaves parameter leaves (adam_step), tiny-cuda-nn's Adam as
// models/optimizer.py states it.
//
// Replaces no TPU kernel: the JAX package leaves Adam to XLA
// (instantvnr_tpu/models/optimizer.py::adam_update), and the port's plain
// form (models/optimizer.py::adam_update_plain) runs it as about 14
// torch._foreach_* passes, plus two elementwise launches a leaf for the l2
// term, each pass reading and writing whole lists. It was added because
// that form was the largest item of the 2^19 training step's device time
// (1.29-1.31 ms a step, three multi_tensor_apply_kernel entries).
//
// What bounds it on an H100 is bytes: each parameter's p, g, m and v are
// read once and p', m' and v' written once, 28 B a parameter (654 MB for
// the 2^19 model's 23.4 M parameters: 0.195 ms at 3.35 TB/s). The design
// fuses the passes and streams each array once, nothing in device memory
// between them:
// - the leaf table travels by value in the kernel's parameters (as
//   multi_tensor_apply's TensorListMeta does), so no pointer is copied to
//   the device before a launch, and a tree of up to kMaxLeaves leaves is
//   one launch;
// - blocks map onto leaves by a prefix of each leaf's block count; a
//   thread owns one 16-byte word of one leaf (2, 4 and 8 words a thread,
//   all loads issued before any arithmetic, and streaming cache hints were
//   timed at the 2^19 tree on the card: 1-2% apart, 8 words 12% slower);
// - a leaf whose seven arrays are all 16-byte aligned moves as float4
//   words, its last n mod 4 elements one by one; any other leaf moves one
//   float a lane (the outputs are fresh allocations, 16-byte aligned, so no
//   scalar head could align an input view at 4 mod 16 with its output).
//
// The arithmetic is the plain form's, operation for operation, in float32:
// the library builds with -fmad=false, so each product and sum rounds once,
// and `/` and sqrtf are IEEE (no fast math), as in PyTorch's foreach
// kernels, which divide by a scalar as a product with its float32
// reciprocal (found bit for bit on the card; a true division parts from
// them in up to 37% of the parameters):
//   g += l2·p (leaves whose flag is set);  m' = β1·m + (1−β1)·g;
//   v' = β2·v + ((1−β2)·g)·g;
//   p' = p − ((m'·(1/c1))·lr) / (sqrt(v'·(1/c2)) + ε)
// with the scalars as the plain form hands them to PyTorch, each rounded to
// float32 by the caller.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kFields = 10;  // a leaf's row of the host table

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long n;
  int vec;  // all seven arrays 16-byte aligned: float4 words
  int l2;
};

struct Group {
  Leaf leaf[kMaxLeaves];
  long long first_block[kMaxLeaves + 1];
  int n;
};

struct Scalars {
  float lr, beta1, one_minus_beta1, beta2, one_minus_beta2, inv_c1, inv_c2,
      epsilon, l2_reg;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       bool l2, const Scalars& s) {
  if (l2) g = g + s.l2_reg * p;
  m = s.beta1 * m + s.one_minus_beta1 * g;
  v = s.beta2 * v + (s.one_minus_beta2 * g) * g;
  const float den = sqrtf(v * s.inv_c2) + s.epsilon;
  p = p - ((m * s.inv_c1) * s.lr) / den;
}

__device__ __forceinline__ void one(const Leaf& lf, long long i, bool l2,
                                    const Scalars& s) {
  float p = lf.p[i], m = lf.m[i], v = lf.v[i];
  update(p, lf.g[i], m, v, l2, s);
  lf.p_out[i] = p;
  lf.m_out[i] = m;
  lf.v_out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
    adam_step_kernel(const __grid_constant__ Group grp, const Scalars s) {
  long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < grp.n && b >= grp.first_block[l + 1]) ++l;
  const Leaf& lf = grp.leaf[l];
  const bool l2 = lf.l2 != 0;
  const long long w = (b - grp.first_block[l]) * kThreads + threadIdx.x;
  if (!lf.vec) {
    if (w < lf.n) one(lf, w, l2, s);
    return;
  }
  const long long full = lf.n / 4;
  if (w < full) {
    float4 p = reinterpret_cast<const float4*>(lf.p)[w];
    const float4 g = reinterpret_cast<const float4*>(lf.g)[w];
    float4 m = reinterpret_cast<const float4*>(lf.m)[w];
    float4 v = reinterpret_cast<const float4*>(lf.v)[w];
    update(p.x, g.x, m.x, v.x, l2, s);
    update(p.y, g.y, m.y, v.y, l2, s);
    update(p.z, g.z, m.z, v.z, l2, s);
    update(p.w, g.w, m.w, v.w, l2, s);
    reinterpret_cast<float4*>(lf.p_out)[w] = p;
    reinterpret_cast<float4*>(lf.m_out)[w] = m;
    reinterpret_cast<float4*>(lf.v_out)[w] = v;
  } else if (w == full) {  // the partial word: the last n mod 4 floats
    for (long long i = 4 * full; i < lf.n; ++i) one(lf, i, l2, s);
  }
}

}  // namespace

// table: host int64 [n_leaves, 10], a leaf a row: the addresses of p, g, m,
// v, p_out, m_out, v_out (float32 [n] each on the device), n, vec (1 where
// all seven are 16-byte aligned) and l2 (1 where the l2 term applies). One
// launch for up to kMaxLeaves leaves; a group with no elements launches
// nothing.
extern "C" int adam_step(const void* table, int n_leaves, float lr,
                         float beta1, float one_minus_beta1, float beta2,
                         float one_minus_beta2, float c1, float c2,
                         float epsilon, float l2_reg, void* stream) {
  if (n_leaves < 0 || n_leaves > kMaxLeaves) return cudaErrorInvalidValue;
  const auto* t = static_cast<const long long*>(table);
  Group grp{};
  grp.n = n_leaves;
  long long blocks = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* row = t + l * kFields;
    Leaf& lf = grp.leaf[l];
    lf.p = reinterpret_cast<const float*>(row[0]);
    lf.g = reinterpret_cast<const float*>(row[1]);
    lf.m = reinterpret_cast<const float*>(row[2]);
    lf.v = reinterpret_cast<const float*>(row[3]);
    lf.p_out = reinterpret_cast<float*>(row[4]);
    lf.m_out = reinterpret_cast<float*>(row[5]);
    lf.v_out = reinterpret_cast<float*>(row[6]);
    lf.n = row[7];
    lf.vec = static_cast<int>(row[8]);
    lf.l2 = static_cast<int>(row[9]);
    if (lf.n < 0) return cudaErrorInvalidValue;
    const long long words = lf.vec ? (lf.n + 3) / 4 : lf.n;
    grp.first_block[l] = blocks;
    blocks += (words + kThreads - 1) / kThreads;
  }
  grp.first_block[n_leaves] = blocks;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the reciprocals as PyTorch's scalar division forms them, in float32
  const Scalars s{lr,        beta1,     one_minus_beta1, beta2,
                  one_minus_beta2, 1.0f / c1, 1.0f / c2, epsilon, l2_reg};
  adam_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(grp, s);
  return cudaGetLastError();
}
