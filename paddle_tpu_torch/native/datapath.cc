// Native host data-path: batch-packing scanners.
//
// TPU-native counterpart of the reference's C++ field scanners
// (/root/reference/paddle/gserver/dataproviders/PyDataProvider2.cpp:611-865
// DenseScanner/IndexScanner/SparseNonValueScanner/SparseValueScanner/
// SequenceScanner): user sample generators stay in Python, but the
// per-sample packing into padded device-feed buffers runs here, GIL-free,
// so the prefetch thread overlaps real work with the training step.
//
// Called through ctypes (C ABI only). All buffers are caller-allocated
// numpy arrays; offsets/lengths describe ragged sample layouts flattened
// by the Python side.

#include <atomic>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack ragged index sequences into a zero-padded [B, T] int32 batch.
// flat: concatenation of all sequences; lengths[b] gives each length.
void pt_pack_index_seq(const int32_t* flat, const int32_t* lengths, int64_t B,
                       int64_t T, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * B * T);
  const int32_t* src = flat;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n = lengths[b];
    std::memcpy(out + b * T, src, sizeof(int32_t) * n);
    src += n;
  }
}

// Pack ragged nested index sequences into [B, S, T].
// sub_lengths is row-major [B, S] (0 beyond each sample's subsequence
// count); flat concatenates every subsequence in order.
void pt_pack_index_subseq(const int32_t* flat, const int32_t* sub_lengths,
                          int64_t B, int64_t S, int64_t T, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * B * S * T);
  const int32_t* src = flat;
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t s = 0; s < S; ++s) {
      const int64_t n = sub_lengths[b * S + s];
      std::memcpy(out + (b * S + s) * T, src, sizeof(int32_t) * n);
      src += n;
    }
  }
}

// Scatter sparse rows into a zeroed dense [B, D] float batch.
// indices: concatenated per-row active column ids; counts[b] = #ids in row
// b; values: per-id values or nullptr (binary rows get 1.0).
void pt_pack_sparse_rows(const int64_t* indices, const float* values,
                         const int32_t* counts, int64_t B, int64_t D,
                         float* out) {
  std::memset(out, 0, sizeof(float) * B * D);
  const int64_t* idx = indices;
  const float* val = values;
  for (int64_t b = 0; b < B; ++b) {
    float* row = out + b * D;
    const int64_t n = counts[b];
    if (values) {
      for (int64_t i = 0; i < n; ++i) row[idx[i]] = val[i];
      val += n;
    } else {
      for (int64_t i = 0; i < n; ++i) row[idx[i]] = 1.0f;
    }
    idx += n;
  }
}

// Pack ragged dense-vector sequences into zero-padded [B, T, D].
// flat: concatenation of all [len_b, D] sample blocks.
void pt_pack_dense_seq(const float* flat, const int32_t* lengths, int64_t B,
                       int64_t T, int64_t D, float* out) {
  std::memset(out, 0, sizeof(float) * B * T * D);
  const float* src = flat;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n = lengths[b];
    std::memcpy(out + b * T * D, src, sizeof(float) * n * D);
    src += n * D;
  }
}

// Scatter sparse *sequence* rows into zeroed [B, T, D]: step_counts gives
// the number of active ids per (b, t) flattened in sequence order
// (total_steps entries, grouped by lengths[b] steps per sample).
void pt_pack_sparse_seq(const int64_t* indices, const float* values,
                        const int32_t* step_counts, const int32_t* lengths,
                        int64_t B, int64_t T, int64_t D, float* out) {
  std::memset(out, 0, sizeof(float) * B * T * D);
  const int64_t* idx = indices;
  const float* val = values;
  const int32_t* sc = step_counts;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t steps = lengths[b];
    for (int64_t t = 0; t < steps; ++t) {
      float* row = out + (b * T + t) * D;
      const int64_t n = *sc++;
      if (values) {
        for (int64_t i = 0; i < n; ++i) row[idx[i]] = val[i];
        val += n;
      } else {
        for (int64_t i = 0; i < n; ++i) row[idx[i]] = 1.0f;
      }
      idx += n;
    }
  }
}

// ABI version tag so a stale cached .so is rebuilt on upgrade.
int32_t pt_datapath_abi_version() { return 1; }

}  // extern "C"
