// The package's ray-compaction kernels (csrc/compaction.cu, included) with
// their tiles set by hand, for scripts/compaction_variants.py to time side
// by side on one card.
//
// compact_variant(R, ...): compact_rows' entry with its partition's tile of
// 256·R rows chosen by the caller, where the package picks the largest R
// whose staging fits kStageBytes.
// scatter_variant(R, ...): scatter_rows with its gather's tile of 256·R
// rows set by hand.
#include "../instantvnr_torch/csrc/compaction.cu"

// R as above, the rest as compact_rows' (ws: nb + ceil(nb / 8) ints,
// nb = ceil(m / 256)).
extern "C" int compact_variant(int rows_per_thread,
                               const void* active, long long m,
                               int n_leaves, const void* src,
                               const void* dst, const void* row_bytes,
                               int copy_back, void* order, void* count,
                               void* ws, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv) || m <= 0 ||
      m > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool* a = static_cast<const bool*>(active);
  int* o = static_cast<int*>(order);
  int* c = static_cast<int*>(count);
  int* w = static_cast<int*>(ws);
  switch (rows_per_thread) {
    case 1: return launch_compaction<1>(a, m, lv, copy_back, o, c, w, s);
    case 2: return launch_compaction<2>(a, m, lv, copy_back, o, c, w, s);
    case 4: return launch_compaction<4>(a, m, lv, copy_back, o, c, w, s);
    case 8: return launch_compaction<8>(a, m, lv, copy_back, o, c, w, s);
    default: return cudaErrorInvalidValue;
  }
}

// R as above, the rest as scatter_rows'.
extern "C" int scatter_variant(int rows_per_thread, const void* perm,
                               long long m, int n_leaves, const void* src,
                               const void* dst, const void* row_bytes,
                               void* ws, void* stream) {
  Leaves lv;
  if (!make_leaves(n_leaves, src, dst, row_bytes, &lv) || m <= 0 ||
      m > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  int* inv = static_cast<int*>(ws);
  switch (rows_per_thread) {
    case 1: return launch_scatter<1>(p, m, lv, inv, s);
    case 2: return launch_scatter<2>(p, m, lv, inv, s);
    case 4: return launch_scatter<4>(p, m, lv, inv, s);
    case 8: return launch_scatter<8>(p, m, lv, inv, s);
    default: return cudaErrorInvalidValue;
  }
}
