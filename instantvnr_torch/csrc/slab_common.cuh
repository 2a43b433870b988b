// Pieces shared by the slab kernels (slab_composite.cu, iso_sweep.cu): two
// resamples of a slab's fields, transfer-function classification and the
// front-to-back blend.
//
// The banded resample (resample_banded; the compositors): a row of the
// per-slab interpolation matrices My [hi, ay] and Mx [wi, ax] has at most
// two nonzeros, at columns j0 and j0 + 1 (render/slabmarch.py::
// _interp_pairs), so a pixel reads its 2 x 2 source texels and sums
//   tmp_c = wy0 s[jy][c] + wy1 s[jy + 1][c]   (c = jx, jx + 1)
//   v     = wx0 tmp_jx + wx1 tmp_jx+1
// the nonzero terms of the dense product in its order (-fmad=false keeps
// each product and sum an IEEE operation, as in the plain PyTorch version,
// ops/slab_composite.py::resample_pairs). No shared memory, no barrier.
//
// The dense resample (resample; iso_sweep.cu, until it moves onto the
// banded one): each block owns a kTH x kTW tile of the intermediate image
// (one thread per column, kTH rows each) and walks the D slabs in order
// itself, so the per-pixel state stays in registers for the whole frame.
// Per slab the block stages its kTH rows of My[k] once and its kTW columns
// of Mx[k] chunk by chunk once, and resamples every field of the slab:
//   tmp_f = My_tile · field_f    [kTH, ax]  (field streamed by row chunks)
//   v_f   = tmp_f · Mx_tileᵀ     [kTH, kTW] (Mx streamed by column chunks)
// float32 FMA throughout. Shared memory does not grow with the volume
// beyond tmp (nf x ax x kTH floats) and one My tile. Ragged tiles are
// masked: no divisibility rule on the frame or the volume.
#pragma once

#include <cuda_runtime.h>

namespace slab {

constexpr int kTW = 256;          // columns per block == threads per block
constexpr int kTH = 4;            // rows per block: each thread owns 4 pixels
constexpr int kCC = 32;           // Mx columns staged per chunk
constexpr int kSlabChunk = 2048;  // floats of a field's slab staged per chunk

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// float offsets into the dynamic shared memory of one block
struct Layout {
  int my, tmp, slab, mx, tf, total;
};

__host__ __device__ __forceinline__ Layout layout(int ay, int ax, int ka,
                                                  int nf, int n_tf) {
  Layout l;
  l.my = 0;                                // [kTH][ay + 1]
  l.tmp = l.my + round4(kTH * (ay + 1));   // [nf][ax][kTH]
  l.slab = l.tmp + round4(nf * ax * kTH);  // [ka][ax]
  l.mx = l.slab + round4(ka * ax);         // [kCC][kTW + 1]
  l.tf = l.mx + round4(kCC * (kTW + 1));   // ctrl [kc][8] | lut [n][4]
  l.total = l.tf + round4(n_tf);
  return l;
}

// rows of a field's slab staged per chunk
inline int chunk_rows(int ay, int ax) {
  const int ka = kSlabChunk / ax;
  return ka < 1 ? 1 : (ka > ay ? ay : ka);
}

// Resample the NF fields src[f] ([ay, ax] each) of one slab for this
// block's tile: v[f][r] = sum_c (sum_a My[row0+r][a] src[f][a][c]) Mx[col][c]
// for the thread's column col = col0 + threadIdx.x. Begins with a barrier,
// so the caller may still read shared memory of the previous slab before.
template <int NF>
__device__ __forceinline__ void resample(
    const float* const (&src)[NF], const float* __restrict__ my_k,
    const float* __restrict__ mx_k, float* s_my, float* s_tmp, float* s_slab,
    float* s_mx, int ay, int ax, int hi, int wi, int ka, int row0, int col0,
    float (&v)[NF][kTH]) {
  const int t = threadIdx.x;
  const int myp = ay + 1;  // padded My row: conflict-free across the 4 rows
  __syncthreads();  // the previous slab is done with s_my, s_tmp, s_mx
  for (int e = t; e < kTH * ay; e += kTW) {
    const int r = e / ay;
    const int a = e - r * ay;
    const int row = row0 + r;
    s_my[r * myp + a] =
        row < hi ? my_k[static_cast<size_t>(row) * ay + a] : 0.0f;
  }
  for (int e = t; e < NF * kTH * ax; e += kTW) s_tmp[e] = 0.0f;

  // tmp_f[c][r] = sum_a My[row0 + r][a] * src_f[a][c], src streamed by rows
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    float* tmp_f = s_tmp + f * kTH * ax;
    for (int a0 = 0; a0 < ay; a0 += ka) {
      const int na = min(ka, ay - a0);
      __syncthreads();  // s_my/s_tmp written; previous chunk consumed
      for (int e = t; e < na * ax; e += kTW) {
        s_slab[e] = src[f][static_cast<size_t>(a0) * ax + e];
      }
      __syncthreads();
      for (int e = t; e < kTH * ax; e += kTW) {
        const int c = e / kTH;
        const int r = e - c * kTH;
        const float* m_row = s_my + r * myp + a0;
        float s = 0.0f;
        for (int aa = 0; aa < na; ++aa) {
          s = fmaf(m_row[aa], s_slab[aa * ax + c], s);
        }
        tmp_f[e] += s;
      }
    }
  }

  // v_f[r] = sum_c tmp_f[c][r] * Mx[col][c], Mx streamed by column chunks,
  // each chunk staged once for all NF fields
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int r = 0; r < kTH; ++r) v[f][r] = 0.0f;
  }
  for (int c0 = 0; c0 < ax; c0 += kCC) {
    const int nc = min(kCC, ax - c0);
    __syncthreads();  // s_tmp complete; previous Mx chunk consumed
    for (int e = t; e < kTW * kCC; e += kTW) {
      const int w = e / kCC;
      const int cc = e - w * kCC;
      const int gcol = col0 + w;
      s_mx[cc * (kTW + 1) + w] =
          (cc < nc && gcol < wi)
              ? mx_k[static_cast<size_t>(gcol) * ax + c0 + cc]
              : 0.0f;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      const float m = s_mx[cc * (kTW + 1) + t];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float4 tv = *reinterpret_cast<const float4*>(
            s_tmp + f * kTH * ax + (c0 + cc) * kTH);
        v[f][0] = fmaf(tv.x, m, v[f][0]);
        v[f][1] = fmaf(tv.y, m, v[f][1]);
        v[f][2] = fmaf(tv.z, m, v[f][2]);
        v[f][3] = fmaf(tv.w, m, v[f][3]);
      }
    }
  }
}

// One row's (or column's) pair: the first source index j0, clamped into
// [0, n - 2] so that a bad index cannot read outside the slab, and the
// weights of j0 and j0 + 1. j0 [.] int32, w [., 2] float32 (8-byte
// aligned).
struct Pair {
  int j;
  float w0, w1;
};

__device__ __forceinline__ Pair load_pair(const int* __restrict__ j0,
                                          const float* __restrict__ w,
                                          size_t i, int n) {
  Pair p;
  p.j = min(max(__ldg(j0 + i), 0), n - 2);
  const float2 ww = __ldg(reinterpret_cast<const float2*>(w) + i);
  p.w0 = ww.x;
  p.w1 = ww.y;
  return p;
}

// The banded resample of the slab s [ay, ax] at one pixel (header note)
__device__ __forceinline__ float resample_banded(const float* __restrict__ s,
                                                 int ax, const Pair& py,
                                                 const Pair& px) {
  const float* r0 = s + static_cast<size_t>(py.j) * ax + px.j;
  const float* r1 = r0 + ax;
  const float t0 = py.w0 * __ldg(r0) + py.w1 * __ldg(r1);
  const float t1 = py.w0 * __ldg(r0 + 1) + py.w1 * __ldg(r1 + 1);
  return px.w0 * t0 + px.w1 * t1;
}

// A transfer function staged in shared memory: control rows [kc][8]
// (x, r, g, b, a, range_lo, range_hi, 0), or the dense rgba LUT [n_lut][4]
// when n_lut > 0 (transfer functions of more than 64 segments).
struct TransferFn {
  const float* s_tf;
  int kc, n_lut;
  float lo, hi, den;
};

// Thread tid of n_threads copies its share of the TF into s_tf; the
// caller's barrier publishes it.
__device__ __forceinline__ TransferFn stage_tf(
    float* s_tf, const float* __restrict__ ctrl, int kc,
    const float* __restrict__ lut, int n_lut, int tid, int n_threads) {
  const bool use_lut = n_lut > 0;
  const int n_tf = use_lut ? n_lut * 4 : kc * 8;
  const float* src = use_lut ? lut : ctrl;
  for (int e = tid; e < n_tf; e += n_threads) s_tf[e] = src[e];
  TransferFn tf;
  tf.s_tf = s_tf;
  tf.kc = kc;
  tf.n_lut = n_lut;
  tf.lo = ctrl[5];
  tf.hi = ctrl[6];
  tf.den = fmaxf(tf.hi - tf.lo, 1e-20f);
  return tf;
}

// value → rgba: the control-point telescoping form of the TPU kernel's
// _classify (slab_composite.py:68), or the LUT's nodal lerp (utils/tfn.py
// classify)
__device__ __forceinline__ void classify(const TransferFn& tf,
                                         float value, float (&rgba)[4]) {
  const float vn = (fminf(fmaxf(value, tf.lo), tf.hi) - tf.lo) / tf.den;
  if (tf.n_lut > 0) {
    const float x = vn * static_cast<float>(tf.n_lut - 1);
    const int i0 = min(max(static_cast<int>(floorf(x)), 0), tf.n_lut - 2);
    const float frac = x - static_cast<float>(i0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a0 = tf.s_tf[i0 * 4 + c];
      const float a1 = tf.s_tf[(i0 + 1) * 4 + c];
      rgba[c] = a0 + (a1 - a0) * frac;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) rgba[c] = tf.s_tf[1 + c];
    for (int i = 0; i < tf.kc - 1; ++i) {
      const float* p0 = tf.s_tf + i * 8;
      const float* p1 = p0 + 8;
      const float denom = fmaxf(p1[0] - p0[0], 1e-12f);
      const float tt = fminf(fmaxf((vn - p0[0]) / denom, 0.0f), 1.0f);
#pragma unroll
      for (int c = 0; c < 4; ++c) rgba[c] += tt * (p1[1 + c] - p0[1 + c]);
    }
  }
}

// Per-pixel carry of the compositors: premultiplied rgb + transmittance.
struct Carry {
  float r, g, b, trans;
};

// Opacity correction 1-(1-a)^corr, coverage x early-termination mask and
// front-to-back blend, exactly as the TPU kernel's _blend
// (slab_composite.py:84).
__device__ __forceinline__ void blend(Carry& px, const float (&rgb)[3],
                                      float a, float corr, float cov,
                                      float term_thresh) {
  float alpha = 1.0f - powf(fmaxf(1.0f - a, 0.0f), corr);
  const float mask = cov * (px.trans > term_thresh ? 1.0f : 0.0f);
  alpha = alpha * mask;
  const float w = px.trans * alpha;
  px.r += w * rgb[0];
  px.g += w * rgb[1];
  px.b += w * rgb[2];
  px.trans = px.trans * (1.0f - alpha);
}

// out [4, hi, wi]: premultiplied rgb + transmittance of pixel p = row·wi +
// col of a frame of hi·wi pixels
__device__ __forceinline__ void store_carry(float* __restrict__ out,
                                            const Carry& px, size_t p,
                                            size_t plane) {
  out[p] = px.r;
  out[plane + p] = px.g;
  out[2 * plane + p] = px.b;
  out[3 * plane + p] = px.trans;
}

}  // namespace slab
