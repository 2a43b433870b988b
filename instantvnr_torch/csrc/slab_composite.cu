// Slab compositor for Hopper, sm_90a: the whole front-to-back slab loop of
// one frame as one kernel.
//
// Replaces the TPU kernel instantvnr_tpu/ops/pallas/slab_composite.py
// (composite_slabs / _kernel, _classify, _blend). On the TPU the slab axis
// was a sequential grid dimension with the carry resident in VMEM; here
// each block owns a kTH x kTW tile of the intermediate image and runs the
// in-order loop over the D slabs itself, keeping the premultiplied rgb and
// transmittance carry of its pixels in registers throughout.
//
// Per slab the block
//   - stages its kTH rows of My[k] in shared memory,
//   - streams the slab through shared memory in row chunks and forms
//     tmp = My_tile · slab  [kTH, ax],
//   - streams its kTW columns of Mx[k] in chunks and forms
//     vals = tmp · Mx_tileᵀ [kTH, kTW], float32 FMA throughout,
//   - classifies (control-point telescoping form, or the dense LUT for
//     transfer functions of more than 64 segments), corrects opacity
//     1-(1-a)^corr, masks by coverage x early termination and blends front
//     to back exactly as _classify/_blend do.
// No tile-height divisibility rule: ragged tiles are masked.
//
// Bound on an H100 at 512^2 x 128 slabs: about 81 MB of inputs and outputs,
// about 24 us; the dense resample this version runs adds 10.7 GFLOP of
// float32 FMA. Each row of My and Mx has at most 2 nonzeros, so a banded
// resample (per-row index/weight pairs) is the later optimisation.
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 256;  // columns per block == threads per block
constexpr int kTH = 4;    // rows per block: each thread owns a 4-pixel column
constexpr int kCC = 32;   // Mx columns staged per chunk
constexpr int kSlabChunk = 2048;  // floats of the slab staged per chunk

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Layout {
  int my, tmp, slab, mx, tf, total;  // float offsets into shared memory
};

__host__ __device__ Layout layout(int ay, int ax, int ka, int n_tf) {
  Layout l;
  l.my = 0;                                   // [kTH][ay + 1]
  l.tmp = l.my + round4(kTH * (ay + 1));      // [ax][kTH]
  l.slab = l.tmp + round4(ax * kTH);          // [ka][ax]
  l.mx = l.slab + round4(ka * ax);            // [kCC][kTW + 1]
  l.tf = l.mx + round4(kCC * (kTW + 1));      // ctrl [kc][8] | lut [n][4]
  l.total = l.tf + round4(n_tf);
  return l;
}

__global__ void __launch_bounds__(kTW)
slab_composite_kernel(const float* __restrict__ vol,
                      const float* __restrict__ my,
                      const float* __restrict__ mx,
                      const float* __restrict__ covy,
                      const float* __restrict__ covx,
                      const float* __restrict__ corr,
                      const float* __restrict__ ctrl, int kc,
                      const float* __restrict__ lut, int n_lut,
                      float* __restrict__ out, int D, int ay, int ax, int hi,
                      int wi, int ka, float term_thresh) {
  extern __shared__ __align__(16) float smem[];
  const bool use_lut = n_lut > 0;
  const int n_tf = use_lut ? n_lut * 4 : kc * 8;
  const Layout L = layout(ay, ax, ka, n_tf);
  float* s_my = smem + L.my;
  float* s_tmp = smem + L.tmp;
  float* s_slab = smem + L.slab;
  float* s_mx = smem + L.mx;
  float* s_tf = smem + L.tf;
  const int myp = ay + 1;  // padded My row: conflict-free across the 4 rows

  const int t = threadIdx.x;
  const int col = blockIdx.x * kTW + t;
  const int row0 = blockIdx.y * kTH;
  const float* tf_src = use_lut ? lut : ctrl;
  for (int e = t; e < n_tf; e += kTW) s_tf[e] = tf_src[e];
  const float r_lo = ctrl[5];
  const float r_hi = ctrl[6];
  const float r_den = fmaxf(r_hi - r_lo, 1e-20f);

  float c_r[kTH], c_g[kTH], c_b[kTH], trans[kTH], corr_px[kTH];
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    c_r[r] = c_g[r] = c_b[r] = 0.0f;
    trans[r] = 1.0f;
    const int row = row0 + r;
    corr_px[r] = (row < hi && col < wi) ? corr[row * wi + col] : 0.0f;
  }

  for (int k = 0; k < D; ++k) {
    __syncthreads();  // the previous slab is done with s_my, s_tmp, s_mx
    const float* my_k = my + static_cast<size_t>(k) * hi * ay;
    for (int e = t; e < kTH * ay; e += kTW) {
      const int r = e / ay;
      const int a = e - r * ay;
      const int row = row0 + r;
      s_my[r * myp + a] = row < hi ? my_k[static_cast<size_t>(row) * ay + a]
                                   : 0.0f;
    }
    for (int e = t; e < kTH * ax; e += kTW) s_tmp[e] = 0.0f;

    // tmp[c][r] = sum_a My[row0 + r][a] * slab[a][c], slab streamed by rows
    const float* slab = vol + static_cast<size_t>(k) * ay * ax;
    for (int a0 = 0; a0 < ay; a0 += ka) {
      const int na = min(ka, ay - a0);
      __syncthreads();  // s_my/s_tmp written; previous chunk consumed
      for (int e = t; e < na * ax; e += kTW) {
        s_slab[e] = slab[static_cast<size_t>(a0) * ax + e];
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
        s_tmp[e] += s;
      }
    }

    // vals[r] = sum_c tmp[c][r] * Mx[col][c], Mx streamed by column chunks
    float v[kTH];
#pragma unroll
    for (int r = 0; r < kTH; ++r) v[r] = 0.0f;
    const float* mx_k = mx + static_cast<size_t>(k) * wi * ax;
    for (int c0 = 0; c0 < ax; c0 += kCC) {
      const int nc = min(kCC, ax - c0);
      __syncthreads();  // s_tmp complete; previous Mx chunk consumed
      for (int e = t; e < kTW * kCC; e += kTW) {
        const int w = e / kCC;
        const int cc = e - w * kCC;
        const int gcol = blockIdx.x * kTW + w;
        s_mx[cc * (kTW + 1) + w] =
            (cc < nc && gcol < wi)
                ? mx_k[static_cast<size_t>(gcol) * ax + c0 + cc]
                : 0.0f;
      }
      __syncthreads();
      for (int cc = 0; cc < nc; ++cc) {
        const float m = s_mx[cc * (kTW + 1) + t];
        const float4 tv =
            *reinterpret_cast<const float4*>(s_tmp + (c0 + cc) * kTH);
        v[0] = fmaf(tv.x, m, v[0]);
        v[1] = fmaf(tv.y, m, v[1]);
        v[2] = fmaf(tv.z, m, v[2]);
        v[3] = fmaf(tv.w, m, v[3]);
      }
    }

    // classify, correct, mask, blend (slab_composite.py _classify/_blend)
    const float cov_x = col < wi ? covx[static_cast<size_t>(k) * wi + col]
                                 : 0.0f;
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int row = row0 + r;
      const float cov_y =
          row < hi ? covy[static_cast<size_t>(k) * hi + row] : 0.0f;
      const float vn = (fminf(fmaxf(v[r], r_lo), r_hi) - r_lo) / r_den;
      float rgba[4];
      if (use_lut) {
        const float x = vn * static_cast<float>(n_lut - 1);
        const int i0 = min(max(static_cast<int>(floorf(x)), 0), n_lut - 2);
        const float frac = x - static_cast<float>(i0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float a0 = s_tf[i0 * 4 + c];
          const float a1 = s_tf[(i0 + 1) * 4 + c];
          rgba[c] = a0 + (a1 - a0) * frac;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) rgba[c] = s_tf[1 + c];
        for (int i = 0; i < kc - 1; ++i) {
          const float* p0 = s_tf + i * 8;
          const float* p1 = p0 + 8;
          const float denom = fmaxf(p1[0] - p0[0], 1e-12f);
          const float tt = fminf(fmaxf((vn - p0[0]) / denom, 0.0f), 1.0f);
#pragma unroll
          for (int c = 0; c < 4; ++c) rgba[c] += tt * (p1[1 + c] - p0[1 + c]);
        }
      }
      float alpha = 1.0f - powf(fmaxf(1.0f - rgba[3], 0.0f), corr_px[r]);
      const float mask =
          cov_y * cov_x * (trans[r] > term_thresh ? 1.0f : 0.0f);
      alpha = alpha * mask;
      const float w = trans[r] * alpha;
      c_r[r] += w * rgba[0];
      c_g[r] += w * rgba[1];
      c_b[r] += w * rgba[2];
      trans[r] = trans[r] * (1.0f - alpha);
    }
  }

  if (col < wi) {
    const size_t plane = static_cast<size_t>(hi) * wi;
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int row = row0 + r;
      if (row >= hi) continue;
      const size_t p = static_cast<size_t>(row) * wi + col;
      out[p] = c_r[r];
      out[plane + p] = c_g[r];
      out[2 * plane + p] = c_b[r];
      out[3 * plane + p] = trans[r];
    }
  }
}

}  // namespace

// vol [D, ay, ax], my [D, hi, ay], mx [D, wi, ax], covy [D, hi],
// covx [D, wi], corr [hi, wi], ctrl [kc, 8] (rows x, r, g, b, a, lo, hi, 0),
// lut [n_lut, 4] rgba or null (n_lut = 0: control-point form);
// out [4, hi, wi] = premultiplied rgb + transmittance. All float32.
extern "C" int slab_composite_forward(const void* vol, const void* my,
                                      const void* mx, const void* covy,
                                      const void* covx, const void* corr,
                                      const void* ctrl, int kc,
                                      const void* lut, int n_lut, void* out,
                                      int D, int ay, int ax, int hi, int wi,
                                      float term_thresh, void* stream) {
  if (hi <= 0 || wi <= 0) return cudaSuccess;
  if (D < 0 || ay <= 0 || ax <= 0 || kc < 1 || (lut != nullptr && n_lut < 2))
    return cudaErrorInvalidValue;
  if (lut == nullptr) n_lut = 0;
  const int ka = max(1, min(ay, kSlabChunk / ax));
  const Layout L = layout(ay, ax, ka, n_lut > 0 ? n_lut * 4 : kc * 8);
  const size_t bytes = sizeof(float) * static_cast<size_t>(L.total);
  cudaError_t err = cudaFuncSetAttribute(
      slab_composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((wi + kTW - 1) / kTW, (hi + kTH - 1) / kTH);
  slab_composite_kernel<<<grid, kTW, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(my),
      static_cast<const float*>(mx), static_cast<const float*>(covy),
      static_cast<const float*>(covx), static_cast<const float*>(corr),
      static_cast<const float*>(ctrl), kc, static_cast<const float*>(lut),
      n_lut, static_cast<float*>(out), D, ay, ax, hi, wi, ka, term_thresh);
  return cudaGetLastError();
}
