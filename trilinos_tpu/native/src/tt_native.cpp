// Native host kernels for trilinos_tpu.
//
// The reference implements ALL of its host-side runtime in C++ (Tpetra's
// fillComplete machinery, Ifpack2's factorizations, the MatrixMarket
// reader in MatrixMarket_Tpetra.hpp). The device compute path here is
// JAX/XLA; this translation unit provides the C++ versions of the
// *setup-time* hot paths, loaded from Python via ctypes:
//
//   * tt_read_mm   — MatrixMarket coordinate parser (fast strtod scan;
//                    analogue of MatrixMarket_Tpetra.hpp readSparse)
//   * tt_ilu0      — in-place ILU(0) numeric factorization on sorted CSR
//                    (analogue of Ifpack2_RILUK_def.hpp compute(), k=0)
//   * tt_spgemm_count / tt_spgemm — one-pass symbolic+numeric local
//                    SpGEMM with a dense accumulator (analogue of
//                    KokkosSparse spgemm's kkmem variant)
//
// Build: g++ -O3 -march=native -shared -fPIC (see ../build.py).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket coordinate parser
// ---------------------------------------------------------------------------

// Parses the header; returns 0 on success. symm: 0 general, 1 symmetric,
// 2 skew. field: 0 real/int, 1 pattern. Leaves *data_pos at the first
// entry line's file offset.
int tt_read_mm_header(const char* path, int64_t* m, int64_t* n,
                      int64_t* nnz, int* symm, int* pattern,
                      int64_t* data_pos) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
  if (std::strncmp(line, "%%MatrixMarket", 14) != 0) {
    std::fclose(f);
    return -3;
  }
  char obj[64], fmt[64], field[64], sym[64];
  if (std::sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s", obj, fmt,
                  field, sym) != 4) { std::fclose(f); return -4; }
  if (std::strcmp(fmt, "coordinate") != 0) { std::fclose(f); return -5; }
  // complex entries carry FOUR value columns — this parser reads three,
  // so defer complex (and hermitian symmetry) to the Python reader
  if (std::strcmp(field, "real") != 0 &&
      std::strcmp(field, "integer") != 0 &&
      std::strcmp(field, "pattern") != 0) { std::fclose(f); return -8; }
  *pattern = std::strcmp(field, "pattern") == 0 ? 1 : 0;
  if (std::strcmp(sym, "symmetric") == 0) *symm = 1;
  else if (std::strcmp(sym, "skew-symmetric") == 0) *symm = 2;
  else *symm = 0;
  // skip comments
  long pos;
  for (;;) {
    pos = std::ftell(f);
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -6; }
    if (line[0] != '%') break;
  }
  long long mm, nn, zz;
  if (std::sscanf(line, "%lld %lld %lld", &mm, &nn, &zz) != 3) {
    std::fclose(f);
    return -7;
  }
  *m = mm; *n = nn; *nnz = zz;
  *data_pos = std::ftell(f);
  std::fclose(f);
  return 0;
}

// Reads nnz (row, col, val) triples starting at data_pos. rows/cols are
// 0-based on output. Returns number parsed, or negative on error.
int64_t tt_read_mm(const char* path, int64_t data_pos, int64_t nnz,
                   int pattern, int64_t* rows, int64_t* cols, double* vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, static_cast<long>(data_pos), SEEK_SET);
  // slurp the remainder for a single fast scan
  long start = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long end = std::ftell(f);
  std::fseek(f, start, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(end - start) + 1);
  size_t got = std::fread(buf.data(), 1, buf.size() - 1, f);
  buf[got] = '\0';
  std::fclose(f);
  char* p = buf.data();
  int64_t k = 0;
  while (k < nnz) {
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (!*p) break;
    char* q;
    long long r = std::strtoll(p, &q, 10);
    if (q == p) return -2;
    p = q;
    long long c = std::strtoll(p, &q, 10);
    if (q == p) return -3;
    p = q;
    double v = 1.0;
    if (!pattern) {
      v = std::strtod(p, &q);
      if (q == p) return -4;
      p = q;
    }
    rows[k] = r - 1;
    cols[k] = c - 1;
    vals[k] = v;
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------------------
// ILU(0): in-place numeric factorization on a sorted CSR
// ---------------------------------------------------------------------------

// vals is modified in place; on exit, entries left of the diagonal hold L
// (unit diagonal implied), the diagonal and right of it hold U.
// Returns 0 on success, i+1 if a zero pivot was hit at row i (factorization
// continues with the pivot skipped, matching the reference's tolerant
// behavior).
int64_t tt_ilu0(int64_t n, const int64_t* row_ptr, const int32_t* cols,
                double* vals) {
  std::vector<int64_t> diag(n, -1);
  std::vector<int64_t> pos(n, -1);  // column -> index scratch for row i
  int64_t bad = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t jj = row_ptr[i]; jj < row_ptr[i + 1]; ++jj)
      if (cols[jj] == i) { diag[i] = jj; break; }
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t rs = row_ptr[i], re = row_ptr[i + 1];
    for (int64_t jj = rs; jj < re; ++jj) pos[cols[jj]] = jj;
    for (int64_t kk = rs; kk < re; ++kk) {
      const int64_t k = cols[kk];
      if (k >= i) break;  // sorted: done with the strict lower part
      const int64_t dk = diag[k];
      if (dk < 0) continue;
      const double ukk = vals[dk];
      if (ukk == 0.0) { if (!bad) bad = i + 1; continue; }
      const double lik = vals[kk] / ukk;
      vals[kk] = lik;
      for (int64_t jj = dk + 1; jj < row_ptr[k + 1]; ++jj) {
        const int64_t p = pos[cols[jj]];
        if (p >= 0) vals[p] -= lik * vals[jj];
      }
    }
    for (int64_t jj = rs; jj < re; ++jj) pos[cols[jj]] = -1;
  }
  return bad;
}

// ---------------------------------------------------------------------------
// Local SpGEMM (dense-accumulator numeric, like kkmem for modest n_cols)
// ---------------------------------------------------------------------------

// Pass 1: count output nnz per row of C = A(mxk) * B(kxn).
void tt_spgemm_count(int64_t m, int64_t n, const int64_t* a_ptr,
                     const int32_t* a_cols, const int64_t* b_ptr,
                     const int32_t* b_cols, int64_t* c_counts) {
  std::vector<int64_t> mark(n, -1);
  for (int64_t i = 0; i < m; ++i) {
    int64_t cnt = 0;
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t k = a_cols[jj];
      for (int64_t bb = b_ptr[k]; bb < b_ptr[k + 1]; ++bb) {
        const int32_t c = b_cols[bb];
        if (mark[c] != i) { mark[c] = i; ++cnt; }
      }
    }
    c_counts[i] = cnt;
  }
}

// Pass 2: fill C (rows sorted by column). c_ptr = exclusive scan of counts.
void tt_spgemm_fill(int64_t m, int64_t n, const int64_t* a_ptr,
                    const int32_t* a_cols, const double* a_vals,
                    const int64_t* b_ptr, const int32_t* b_cols,
                    const double* b_vals, const int64_t* c_ptr,
                    int32_t* c_cols, double* c_vals) {
  std::vector<double> acc(n, 0.0);
  std::vector<int64_t> mark(n, -1);
  std::vector<int32_t> touched;
  touched.reserve(256);
  for (int64_t i = 0; i < m; ++i) {
    touched.clear();
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t k = a_cols[jj];
      const double av = a_vals[jj];
      for (int64_t bb = b_ptr[k]; bb < b_ptr[k + 1]; ++bb) {
        const int32_t c = b_cols[bb];
        if (mark[c] != i) {
          mark[c] = i;
          acc[c] = 0.0;
          touched.push_back(c);
        }
        acc[c] += av * b_vals[bb];
      }
    }
    std::sort(touched.begin(), touched.end());
    int64_t out = c_ptr[i];
    for (const int32_t c : touched) {
      c_cols[out] = c;
      c_vals[out] = acc[c];
      ++out;
    }
  }
}


// ---------------------------------------------------------------------------
// Sparse LU: Gilbert-Peierls left-looking factorization with partial
// pivoting (the algorithm behind KLU/SuperLU's column factorization —
// reference consumer: packages/amesos2/src/Amesos2_KLU2_decl.hpp).
// Two-call protocol: tt_splu sizes/fills within caller-provided capacity;
// returns required nnz (caller retries with bigger buffers if needed).
// Outputs: L (unit diagonal implicit, row-permuted), U (upper), and the
// row permutation perm (perm[k] = original row in position k).
// ---------------------------------------------------------------------------

int64_t tt_splu(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                const double* a_vals, int64_t cap,
                int64_t* l_ptr, int32_t* l_cols, double* l_vals,
                int64_t* u_ptr, int32_t* u_cols, double* u_vals,
                int64_t* perm) {
  // CSC copy of A (Gilbert-Peierls is column-based)
  std::vector<int64_t> cptr(n + 1, 0);
  const int64_t nnz = a_ptr[n];
  for (int64_t j = 0; j < nnz; ++j) cptr[a_cols[j] + 1]++;
  for (int64_t c = 0; c < n; ++c) cptr[c + 1] += cptr[c];
  std::vector<int32_t> crow(nnz);
  std::vector<double> cval(nnz);
  {
    std::vector<int64_t> w(cptr.begin(), cptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
        const int64_t pos = w[a_cols[jj]]++;
        crow[pos] = (int32_t)i;
        cval[pos] = a_vals[jj];
      }
  }
  // L stored column-wise during factorization (unit diag implicit)
  std::vector<std::vector<int32_t>> lrow(n);
  std::vector<std::vector<double>> lval(n);
  std::vector<int64_t> pinv(n, -1);  // original row -> pivot position
  std::vector<double> x(n, 0.0);
  std::vector<int32_t> stack(n), flag(n, -1), pattern;
  pattern.reserve(256);
  int64_t lnnz = 0, unnz = 0;
  u_ptr[0] = 0;
  for (int64_t col = 0; col < n; ++col) {
    // symbolic: DFS from A(:,col) rows through L columns of pivoted rows
    pattern.clear();
    for (int64_t jj = cptr[col]; jj < cptr[col + 1]; ++jj) {
      int32_t r = crow[jj];
      if (flag[r] == col) continue;
      // iterative DFS
      int64_t top = 0;
      stack[top] = r;
      std::vector<int64_t> pos_in(1, 0);
      while (top >= 0) {
        const int32_t node = stack[top];
        if (flag[node] != col) flag[node] = col;
        const int64_t pv = pinv[node];
        bool descended = false;
        if (pv >= 0) {
          auto& lr = lrow[pv];
          for (int64_t q = pos_in[top]; q < (int64_t)lr.size(); ++q) {
            const int32_t child = lr[q];
            if (flag[child] != col) {
              pos_in[top] = q + 1;
              stack[++top] = child;
              if ((int64_t)pos_in.size() <= top) pos_in.push_back(0);
              else pos_in[top] = 0;
              descended = true;
              break;
            }
          }
        }
        if (!descended) {
          pattern.push_back(node);
          --top;
        }
      }
    }
    // numeric: x = A(:,col); sparse triangular updates in topological
    // (reverse-pattern) order
    for (int32_t r : pattern) x[r] = 0.0;
    for (int64_t jj = cptr[col]; jj < cptr[col + 1]; ++jj)
      x[crow[jj]] = cval[jj];
    for (int64_t t = (int64_t)pattern.size() - 1; t >= 0; --t) {
      const int32_t node = pattern[t];
      const int64_t pv = pinv[node];
      if (pv < 0) continue;
      const double xj = x[node];
      if (xj == 0.0) continue;
      auto& lr = lrow[pv];
      auto& lv = lval[pv];
      for (size_t q = 0; q < lr.size(); ++q) x[lr[q]] -= lv[q] * xj;
    }
    // pivot: largest |x| among unpivoted rows in the pattern
    double pmax = 0.0;
    int32_t prow = -1;
    for (int32_t r : pattern)
      if (pinv[r] < 0 && std::abs(x[r]) > pmax) {
        pmax = std::abs(x[r]);
        prow = r;
      }
    if (prow < 0) {  // structurally singular column: pick any free row
      for (int32_t r = 0; r < n; ++r)
        if (pinv[r] < 0) { prow = r; break; }
      x[prow] = (x[prow] == 0.0) ? 1e-300 : x[prow];
    }
    const double piv = x[prow] != 0.0 ? x[prow] : 1e-300;
    pinv[prow] = col;
    perm[col] = prow;
    // U column = pivoted-row entries (pattern rows already pivoted)
    for (int32_t r : pattern) {
      if (pinv[r] >= 0 && pinv[r] < col && x[r] != 0.0) {
        if (unnz >= cap) return -(int64_t)(unnz + lnnz + n);
        u_cols[unnz] = (int32_t)pinv[r];
        u_vals[unnz] = x[r];
        ++unnz;
      }
    }
    if (unnz >= cap) return -(int64_t)(unnz + lnnz + n);
    u_cols[unnz] = (int32_t)col;  // diagonal of U
    u_vals[unnz] = piv;
    ++unnz;
    u_ptr[col + 1] = unnz;
    // L column (unit diagonal implicit): unpivoted pattern rows
    auto& lr = lrow[col];
    auto& lv = lval[col];
    for (int32_t r : pattern) {
      if (pinv[r] < 0 && x[r] != 0.0) {
        lr.push_back(r);
        lv.push_back(x[r] / piv);
      }
    }
    lnnz += (int64_t)lr.size();
    for (int32_t r : pattern) x[r] = 0.0;
  }
  if (lnnz > cap) return -(lnnz + unnz);
  // flatten L columns to CSC-ish (l_ptr/l_cols hold column-major: for
  // column j, the ORIGINAL row ids with their multipliers)
  l_ptr[0] = 0;
  int64_t at = 0;
  for (int64_t j = 0; j < n; ++j) {
    for (size_t q = 0; q < lrow[j].size(); ++q) {
      l_cols[at] = lrow[j][q];
      l_vals[at] = lval[j][q];
      ++at;
    }
    l_ptr[j + 1] = at;
  }
  return lnnz + unnz;
}

// Forward/backward solve with the tt_splu factors: solves A x = b.
void tt_splu_solve(int64_t n, const int64_t* l_ptr, const int32_t* l_cols,
                   const double* l_vals, const int64_t* u_ptr,
                   const int32_t* u_cols, const double* u_vals,
                   const int64_t* perm, const double* b, double* out) {
  // y[col] = (P b) with L (unit lower, column-major over original rows)
  std::vector<double> y(n);
  std::vector<double> bw(b, b + n);
  for (int64_t col = 0; col < n; ++col) {
    const double yc = bw[perm[col]];
    y[col] = yc;
    for (int64_t q = l_ptr[col]; q < l_ptr[col + 1]; ++q)
      bw[l_cols[q]] -= l_vals[q] * yc;
  }
  // U x = y  (U stored column-wise: u column col holds rows < col and
  // the diagonal at the end)
  std::vector<double>& xv = y;
  for (int64_t col = n - 1; col >= 0; --col) {
    const int64_t lo = u_ptr[col], hi = u_ptr[col + 1];
    const double piv = u_vals[hi - 1];
    const double xc = xv[col] / piv;
    xv[col] = xc;
    for (int64_t q = lo; q < hi - 1; ++q) xv[u_cols[q]] -= u_vals[q] * xc;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = xv[i];
}

// ---------------------------------------------------------------------------
// ILUT(p, tau) — Saad dual-threshold incomplete LU, row-based.
// Analogue of Ifpack2::ILUT numeric factorization
// (packages/ifpack2/src/Ifpack2_ILUT_def.hpp compute()); semantics match
// the Python reference sweep in precond/ilut.py:ilut_factor exactly (drop
// below tau = droptol*||row||, keep the p = fill*row_len largest per
// factor, zero-pivot guard row_norm*1e-12).
//
// Outputs: L rows STRICT lower (unit diagonal added by the caller),
// U rows with the DIAGONAL FIRST then kept uppers ascending. Returns
// total nnz written (l+u), or a negative capacity hint when cap is
// exceeded (caller doubles and retries).
// ---------------------------------------------------------------------------

int64_t tt_ilut(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                const double* a_vals, double fill, double droptol,
                int64_t cap,
                int64_t* l_ptr, int32_t* l_cols, double* l_vals,
                int64_t* u_ptr, int32_t* u_cols, double* u_vals) {
  std::vector<double> w(n, 0.0);
  std::vector<double> udiag(n, 0.0);
  // state: 0 absent, 1 present, 2 present+queued for elimination
  std::vector<char> state(n, 0);
  std::priority_queue<int32_t, std::vector<int32_t>,
                      std::greater<int32_t>> heap;
  std::vector<int32_t> pat, cand;
  pat.reserve(256);
  int64_t lnnz = 0, unnz = 0;
  l_ptr[0] = 0;
  u_ptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    pat.clear();
    double norm2 = 0.0;
    for (int64_t jj = a_ptr[i]; jj < a_ptr[i + 1]; ++jj) {
      const int32_t c = a_cols[jj];
      const double v = a_vals[jj];
      if (!state[c]) {
        state[c] = 1;
        pat.push_back(c);
        w[c] = v;
      } else {
        w[c] += v;
      }
      norm2 += v * v;
    }
    double row_norm = std::sqrt(norm2);
    if (row_norm == 0.0) row_norm = 1.0;
    const double tau = droptol * row_norm;
    const int64_t row_len = a_ptr[i + 1] - a_ptr[i];
    int64_t p_keep = (int64_t)(fill * (double)row_len);
    if (p_keep < 1) p_keep = 1;
    for (int32_t c : pat)
      if (c < i && state[c] == 1) {
        state[c] = 2;
        heap.push(c);
      }
    while (!heap.empty()) {
      const int32_t k = heap.top();
      heap.pop();
      if (!state[k]) continue;  // dropped by an earlier elimination
      state[k] = 1;
      const double ukk = udiag[k];
      if (ukk == 0.0) continue;
      const double lik = w[k] / ukk;
      if (std::abs(lik) < tau) {
        state[k] = 0;
        w[k] = 0.0;
        continue;
      }
      w[k] = lik;
      for (int64_t q = u_ptr[k]; q < u_ptr[k + 1]; ++q) {
        const int32_t j = u_cols[q];
        if (j <= k) continue;  // skip the leading diagonal slot
        const double uv = u_vals[q];
        if (!state[j]) {
          state[j] = 1;
          pat.push_back(j);
          w[j] = -lik * uv;
          if (j < i) {
            state[j] = 2;
            heap.push(j);
          }
        } else {
          w[j] -= lik * uv;
        }
      }
    }
    // select lower entries: |w| >= tau, keep the p largest
    cand.clear();
    for (int32_t c : pat)
      if (c < i && state[c] && std::abs(w[c]) >= tau) cand.push_back(c);
    auto bigger = [&](int32_t x, int32_t y) {
      return std::abs(w[x]) > std::abs(w[y]);
    };
    if ((int64_t)cand.size() > p_keep) {
      std::nth_element(cand.begin(), cand.begin() + p_keep, cand.end(),
                       bigger);
      cand.resize(p_keep);
    }
    std::sort(cand.begin(), cand.end());
    if (lnnz + (int64_t)cand.size() > cap ||
        unnz + p_keep + 1 > cap)
      return -(lnnz + unnz + 2 * (n - i) * (p_keep + 1));
    for (int32_t c : cand) {
      l_cols[lnnz] = c;
      l_vals[lnnz] = w[c];
      ++lnnz;
    }
    l_ptr[i + 1] = lnnz;
    // select upper entries (excluding diagonal): |w| >= tau, p largest
    cand.clear();
    for (int32_t c : pat)
      if (c > i && state[c] && std::abs(w[c]) >= tau) cand.push_back(c);
    if ((int64_t)cand.size() > p_keep) {
      std::nth_element(cand.begin(), cand.begin() + p_keep, cand.end(),
                       bigger);
      cand.resize(p_keep);
    }
    std::sort(cand.begin(), cand.end());
    double dpiv = (state[i] && w[i] != 0.0) ? w[i] : row_norm * 1e-12;
    u_cols[unnz] = (int32_t)i;  // diagonal first
    u_vals[unnz] = dpiv;
    ++unnz;
    for (int32_t c : cand) {
      u_cols[unnz] = c;
      u_vals[unnz] = w[c];
      ++unnz;
    }
    u_ptr[i + 1] = unnz;
    udiag[i] = dpiv;
    for (int32_t c : pat) {
      state[c] = 0;
      w[c] = 0.0;
    }
  }
  return lnnz + unnz;
}

// ---------------------------------------------------------------------------
// ILU(k) symbolic level-of-fill (Ifpack2::IlukGraph analogue,
// packages/ifpack2/src/Ifpack2_IlukGraph.hpp): the augmented sparsity
// pattern with fill level <= kfill. Row-merge formulation: row i starts
// at the levels of A's entries (0); each pivot k < i in the working row
// (ascending; std::set insertions of j > k keep iterators valid) merges
// row k's stored strict-upper pattern at level lev(i,k)+lev(k,j)+1,
// keeping entries with level <= kfill. ILU(0) on this pattern (zeros at
// fill positions) IS ILU(k) — the classical reduction the Python side
// uses. Capacity protocol like tt_splu: returns required nnz; out
// arrays are fully valid only when the result <= cap (out_ptr is always
// filled, so the caller can retry with the exact size).
// ---------------------------------------------------------------------------

int64_t tt_iluk(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                int64_t kfill, int64_t cap,
                int64_t* out_ptr, int32_t* out_cols) {
  const int32_t ABSENT = INT32_MAX;
  std::vector<int32_t> lev(n, ABSENT);
  std::vector<int64_t> uptr(n + 1, 0);  // strict-upper pattern storage
  std::vector<int32_t> ucols;
  std::vector<int32_t> ulevs;
  ucols.reserve(a_ptr[n]);
  ulevs.reserve(a_ptr[n]);
  int64_t total = 0;
  out_ptr[0] = 0;
  std::set<int32_t> act;
  for (int64_t i = 0; i < n; ++i) {
    act.clear();
    for (int64_t p = a_ptr[i]; p < a_ptr[i + 1]; ++p) {
      const int32_t c = a_cols[p];
      if (lev[c] == ABSENT) act.insert(c);
      lev[c] = 0;
    }
    for (auto it = act.begin(); it != act.end(); ++it) {
      const int32_t k = *it;
      if (k >= i) break;
      const int32_t lk = lev[k];
      for (int64_t p = uptr[k]; p < uptr[k + 1]; ++p) {
        const int32_t j = ucols[p];
        const int64_t nl = (int64_t)lk + ulevs[p] + 1;
        if (nl <= kfill) {
          if (lev[j] == ABSENT) {
            act.insert(j);  // j > k: not yet visited in this traversal
            lev[j] = (int32_t)nl;
          } else if ((int32_t)nl < lev[j]) {
            lev[j] = (int32_t)nl;
          }
        }
      }
    }
    const int64_t cnt = (int64_t)act.size();
    if (total + cnt <= cap) {
      int64_t q = total;
      for (int32_t c : act) out_cols[q++] = c;
    }
    total += cnt;
    out_ptr[i + 1] = total;
    for (int32_t c : act) {  // ascending: store strict upper + levels
      if (c > i) {
        ucols.push_back(c);
        ulevs.push_back(lev[c]);
      }
      lev[c] = ABSENT;
    }
    uptr[i + 1] = (int64_t)ucols.size();
  }
  return total;
}

// ---------------------------------------------------------------------------
// Halo-plan ghost analysis: sorted-unique ghost gids + per-entry slots.
// Replaces the per-shard numpy unique/lexsort/argsort/searchsorted chain
// in parallel/distmatrix.distribute (one sort, one pass — the setup hot
// path at 10M+ rows; analogue of Tpetra makeColMap remote-GID handling,
// packages/tpetra/core/src/Tpetra_Details_makeColMap_def.hpp). Valid for
// CONTIGUOUS maps, where owner-major order == gid order.
// ---------------------------------------------------------------------------

int64_t tt_ghost_slots(int64_t nb, const int64_t* bc_cols,
                       int64_t* ghost_gids, int64_t* slots) {
  std::vector<int64_t> sorted(bc_cols, bc_cols + nb);
  std::sort(sorted.begin(), sorted.end());
  const int64_t ng =
      std::unique(sorted.begin(), sorted.end()) - sorted.begin();
  for (int64_t g = 0; g < ng; ++g) ghost_gids[g] = sorted[g];
  for (int64_t e = 0; e < nb; ++e)
    slots[e] = std::lower_bound(ghost_gids, ghost_gids + ng, bc_cols[e])
               - ghost_gids;
  return ng;
}

// ---------------------------------------------------------------------------
// Sparse Cholesky (LL^T): up-looking factorization with elimination-tree
// symbolic analysis — the algorithm class behind CHOLMOD / ShyLU-Tacho
// (reference consumer: Amesos2's Tacho/Cholmod adapters,
// packages/amesos2/src/Amesos2_Tacho_decl.hpp). A must be symmetric
// positive definite; the LOWER triangle of the CSR input is consumed.
//
// Output L is COLUMN-major (CSC) with the diagonal entry FIRST in each
// column, rows ascending after it. Two-call protocol like tt_splu:
// returns total nnz(L), or the negative required capacity when cap is
// too small, or -(10^15 + k) when the reduced diagonal at column k is
// not positive (matrix not SPD).
// ---------------------------------------------------------------------------

int64_t tt_spchol(int64_t n, const int64_t* a_ptr, const int32_t* a_cols,
                  const double* a_vals, int64_t cap,
                  int64_t* l_ptr, int32_t* l_cols, double* l_vals) {
  // phase 1: elimination tree (Liu's algorithm with path compression)
  std::vector<int32_t> parent(n, -1), ancestor(n, -1);
  for (int64_t k = 0; k < n; ++k)
    for (int64_t q = a_ptr[k]; q < a_ptr[k + 1]; ++q) {
      int32_t i = a_cols[q];
      if (i >= (int32_t)k) continue;
      while (i != -1 && i < (int32_t)k) {
        const int32_t next = ancestor[i];
        ancestor[i] = (int32_t)k;
        if (next == -1) { parent[i] = (int32_t)k; break; }
        i = next;
      }
    }
  // phase 2: up-looking numeric factorization. L columns grow by one
  // row per later step, so build them in dynamic per-column buffers.
  std::vector<std::vector<int32_t>> lrow(n);
  std::vector<std::vector<double>> lval(n);
  std::vector<double> diag(n, 0.0), x(n, 0.0);
  // separate path buffer: the global pattern fills stack from the top
  // while each etree walk builds from the bottom — one shared array can
  // collide on long chains (CSparse sizes this workspace 2n)
  std::vector<int32_t> flag(n, -1), stack(n), path(n);
  for (int64_t k = 0; k < n; ++k) {
    // ereach: pattern of L(k, 0..k-1) = union of etree paths from the
    // below-diagonal entries of A(:,k) up toward k, topological order
    int64_t top = n;
    flag[k] = (int32_t)k;
    double akk = 0.0;
    for (int64_t q = a_ptr[k]; q < a_ptr[k + 1]; ++q) {
      const int32_t j = a_cols[q];
      if (j > (int32_t)k) continue;
      if (j == (int32_t)k) { akk = a_vals[q]; continue; }
      x[j] = a_vals[q];
      int64_t len = 0;
      for (int32_t i = j; flag[i] != (int32_t)k; i = parent[i]) {
        path[len++] = i;
        flag[i] = (int32_t)k;
      }
      while (len > 0) stack[--top] = path[--len];
    }
    // sparse triangular solve over the pattern (children before parents)
    for (int64_t p = top; p < n; ++p) {
      const int32_t j = stack[p];
      const double lkj = x[j] / diag[j];
      x[j] = 0.0;
      const std::vector<int32_t>& rj = lrow[j];
      const std::vector<double>& vj = lval[j];
      for (size_t q = 0; q < rj.size(); ++q) x[rj[q]] -= vj[q] * lkj;
      akk -= lkj * lkj;
      lrow[j].push_back((int32_t)k);
      lval[j].push_back(lkj);
    }
    if (!(akk > 0.0)) return -(1000000000000000LL + k);
    diag[k] = std::sqrt(akk);
  }
  // emit CSC with the diagonal first per column
  int64_t total = n;
  for (int64_t j = 0; j < n; ++j) total += (int64_t)lrow[j].size();
  if (total > cap) return -total;
  int64_t at = 0;
  l_ptr[0] = 0;
  for (int64_t j = 0; j < n; ++j) {
    l_cols[at] = (int32_t)j;
    l_vals[at] = diag[j];
    ++at;
    for (size_t q = 0; q < lrow[j].size(); ++q) {
      l_cols[at] = lrow[j][q];
      l_vals[at] = lval[j][q];
      ++at;
    }
    l_ptr[j + 1] = at;
  }
  return total;
}

// Solves A x = b with the tt_spchol factor: L y = b, then L^T x = y.
void tt_spchol_solve(int64_t n, const int64_t* l_ptr,
                     const int32_t* l_cols, const double* l_vals,
                     const double* b, double* out) {
  std::vector<double> y(b, b + n);
  for (int64_t j = 0; j < n; ++j) {
    const double yj = y[j] / l_vals[l_ptr[j]];
    y[j] = yj;
    for (int64_t q = l_ptr[j] + 1; q < l_ptr[j + 1]; ++q)
      y[l_cols[q]] -= l_vals[q] * yj;
  }
  for (int64_t j = n - 1; j >= 0; --j) {
    double s = y[j];
    for (int64_t q = l_ptr[j] + 1; q < l_ptr[j + 1]; ++q)
      s -= l_vals[q] * y[l_cols[q]];
    y[j] = s / l_vals[l_ptr[j]];
  }
  for (int64_t i = 0; i < n; ++i) out[i] = y[i];
}

}  // extern "C"
