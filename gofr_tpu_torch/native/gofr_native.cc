// The port's native BPE core: greedy byte-pair merges over token ids, on
// the host, behind a plain C interface loaded with ctypes.
//
// A copy of the BPE part of gofr_tpu/native/gofr_native.cc (gn_version,
// gn_bpe_new, gn_bpe_free, gn_bpe_encode), and gn_bpe_encode_pieces, the
// same loop over many pieces in one call. The tokenizer's merge loop runs
// per request before the model sees a token; in Python it is O(n^2)
// interpreter-bound. Also a copy of gn_propose_draft, speculative
// decoding's prompt-lookup scan. This is host code, not a device kernel.
//
// Build: gofr_tpu_torch/native/__init__.py compiles it with the host C++
// compiler at first use into build/torch_native/.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct PairHash {
  std::size_t operator()(const std::pair<int32_t, int32_t>& p) const {
    return (static_cast<std::size_t>(static_cast<uint32_t>(p.first)) << 32) ^
           static_cast<uint32_t>(p.second);
  }
};

struct BPE {
  // (left, right) -> (rank, merged id); lower rank merges first
  std::unordered_map<std::pair<int32_t, int32_t>, std::pair<int32_t, int32_t>,
                     PairHash>
      merges;
};

}  // namespace

extern "C" {

const char* gn_version() { return "gofr_tpu_torch native 1.0"; }

void* gn_bpe_new(int32_t n_merges, const int32_t* left, const int32_t* right,
                 const int32_t* merged) {
  BPE* bpe = new BPE();
  bpe->merges.reserve(static_cast<std::size_t>(n_merges) * 2);
  for (int32_t i = 0; i < n_merges; ++i) {
    // last occurrence wins, as the reference's dict-comprehension ranks
    bpe->merges[std::make_pair(left[i], right[i])] =
        std::make_pair(i, merged[i]);
  }
  return bpe;
}

void gn_bpe_free(void* handle) { delete static_cast<BPE*>(handle); }

// Greedy lowest-rank-first merging over a linked list of tokens (the
// leftmost pair wins a tie of ranks). Returns the output length written
// into `out` (capacity must be >= n).
int32_t gn_bpe_encode(void* handle, const int32_t* ids, int32_t n,
                      int32_t* out) {
  const BPE* bpe = static_cast<const BPE*>(handle);
  if (n <= 0) return 0;
  std::vector<int32_t> tok(ids, ids + n);
  std::vector<int32_t> next(n);
  for (int32_t i = 0; i < n; ++i) next[i] = (i + 1 < n) ? i + 1 : -1;
  while (true) {
    int32_t best_rank = INT32_MAX, best_i = -1, best_merged = 0;
    for (int32_t i = 0; i != -1 && next[i] != -1; i = next[i]) {
      auto it = bpe->merges.find({tok[i], tok[next[i]]});
      if (it != bpe->merges.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_i = i;
        best_merged = it->second.second;
      }
    }
    if (best_i == -1) break;
    tok[best_i] = best_merged;
    next[best_i] = next[next[best_i]];
  }
  int32_t n_out = 0;
  for (int32_t i = 0; i != -1; i = next[i]) out[n_out++] = tok[i];
  return n_out;
}

// The merge loop of gn_bpe_encode over each of n_pieces spans of `ids`
// (piece p is ids[offsets[p], offsets[p + 1])): no merge crosses a span's
// edge, as the byte-level tokenizer merges each pre-tokenizer piece apart.
// Writes the pieces' outputs back to back into `out` (capacity >=
// offsets[n_pieces]) and each one's length into out_counts; returns the
// total. One call per text instead of one per piece.
int32_t gn_bpe_encode_pieces(void* handle, const int32_t* ids,
                             const int32_t* offsets, int32_t n_pieces,
                             int32_t* out, int32_t* out_counts) {
  int32_t total = 0;
  for (int32_t p = 0; p < n_pieces; ++p) {
    int32_t n = gn_bpe_encode(handle, ids + offsets[p],
                              offsets[p + 1] - offsets[p], out + total);
    out_counts[p] = n;
    total += n;
  }
  return total;
}

// Prompt-lookup draft proposal (speculative decoding): find the most recent
// earlier occurrence of the history's trailing bigram and copy up to `d`
// tokens that followed it into `out`. Returns tokens written (0 = no match).
// Runs once per active slot per verify dispatch.
int32_t gn_propose_draft(const int32_t* hist, int32_t n, int32_t d,
                         int32_t* out) {
  if (n < 3 || d <= 0) return 0;
  const int32_t a = hist[n - 2], b = hist[n - 1];
  for (int32_t i = n - 3; i >= 0; --i) {
    if (hist[i] == a && hist[i + 1] == b) {
      const int32_t start = i + 2;  // <= n-1, so at least one token follows
      const int32_t avail = n - start;
      const int32_t count = avail < d ? avail : d;
      std::memcpy(out, hist + start, count * sizeof(int32_t));
      return count;
    }
  }
  return 0;
}

}  // extern "C"
