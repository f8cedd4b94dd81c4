// Levenshtein edit distance over int32 sequences: ds_levenshtein of
// dsjax/cpp/src/beam.cpp, copied into the port's host library (the native
// twin of the python-Levenshtein dependency, reference: validation.py:10).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int ds_levenshtein(const int32_t* a, int n, const int32_t* b, int m) {
  if (n < m) return ds_levenshtein(b, m, a, n);
  std::vector<int> prev(m + 1), cur(m + 1);
  for (int j = 0; j <= m; ++j) prev[j] = j;
  for (int i = 1; i <= n; ++i) {
    cur[0] = i;
    for (int j = 1; j <= m; ++j) {
      int sub = prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"
