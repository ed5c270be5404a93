// Native host-side factorization kernels (C++17, C ABI via ctypes).
//
// These are the setup-phase hot loops that stay on the host in this
// design (SURVEY §7: "factorization on host, iteration on device"):
//   * level-set computation for the level-scheduled triangular solve
//   * ILU(0) numeric IKJ elimination on a fixed sorted pattern
//     (semantics of /root/reference/src/pc-iluk.cxx:347-409 — pivot clamps
//     included)
//   * ILU(k) level-of-fill symbolic phase (pc-iluk.cxx:22-135 semantics,
//     including the max-level update rule)
//   * dual-threshold ILUT (pc-ilut.cxx:51-286 semantics)
//
// The Python implementations in lssp_tpu/pc/ilu_host.py are the reference
// oracles; lssp_tpu/native/__init__.py builds this file on demand and
// dispatches here when available.  Outputs are bit-identical to the Python
// path (same elimination order, same drop rules).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <vector>

using std::int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Level-set computation: longest dependency chain per row of a strict
// triangular factor.  lower=1: rows 0..n-1 depend on smaller indices;
// lower=0: reverse sweep.
// ---------------------------------------------------------------------------
void lssp_levels(const int64_t* indptr, const int64_t* indices, int64_t n,
                 int lower, int64_t* lev_out) {
    if (lower) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t m = -1;
            for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
                m = std::max(m, lev_out[indices[k]]);
            lev_out[i] = m + 1;
        }
    } else {
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t m = -1;
            for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
                m = std::max(m, lev_out[indices[k]]);
            lev_out[i] = m + 1;
        }
    }
}

// ---------------------------------------------------------------------------
// ILU(0) numeric on a fixed *sorted* pattern (in place on data).
// ztol/zval: pivot clamp thresholds (reference mat_zero_diag_tol/_value).
// ---------------------------------------------------------------------------
void lssp_ilu0(const int64_t* indptr, const int64_t* indices, double* data,
               int64_t n, double ztol, double zval) {
    std::vector<double> invd(n, 0.0);
    std::vector<int64_t> pos(n, -1);

    double d0 = (n > 0 && indptr[1] > indptr[0] && indices[indptr[0]] == 0)
                    ? data[indptr[0]] : 0.0;
    if (std::fabs(d0) < ztol) d0 = d0 > 0 ? zval : -zval;
    if (n > 0) invd[0] = 1.0 / d0;

    for (int64_t i = 1; i < n; ++i) {
        const int64_t s = indptr[i], e = indptr[i + 1];
        for (int64_t k = s; k < e; ++k) pos[indices[k]] = k;
        int64_t kpos = s;
        for (; kpos < e && indices[kpos] < i; ++kpos) {
            const int64_t k = indices[kpos];
            const double a_ik = data[kpos] * invd[k];
            data[kpos] = a_ik;
            for (int64_t kk = indptr[k]; kk < indptr[k + 1]; ++kk) {
                const int64_t tp = pos[indices[kk]];
                if (tp > kpos) data[tp] -= a_ik * data[kk];
            }
        }
        for (int64_t k = s; k < e; ++k) pos[indices[k]] = -1;
        double di = zval;
        if (kpos < e && indices[kpos] == i) {
            if (std::fabs(data[kpos]) < ztol) data[kpos] = zval;
            di = data[kpos];
        }
        invd[i] = 1.0 / di;
    }
}

// ---------------------------------------------------------------------------
// ILU(k) symbolic: grown pattern returned through an opaque handle.
// ---------------------------------------------------------------------------
struct PatternHandle {
    std::vector<int64_t> indptr;
    std::vector<int64_t> indices;
    std::vector<double> data;
};

void* lssp_iluk_symbolic(const int64_t* indptr, const int64_t* indices,
                         int64_t n, int64_t level, int64_t* out_nnz) {
    auto* h = new PatternHandle();
    h->indptr.assign(n + 1, 0);

    // per factored row: strict-upper pattern + fill levels
    std::vector<std::vector<int64_t>> u_cols(n);
    std::vector<std::vector<int64_t>> u_lev(n);
    std::vector<std::vector<int64_t>> rows(n);

    std::vector<int64_t> lev_of(n, -1);     // workspace: level per col, -1 = absent
    std::vector<int64_t> touched;

    for (int64_t i = 0; i < n; ++i) {
        touched.clear();
        std::vector<int64_t> lower;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t c = indices[k];
            if (c == i) continue;
            if (lev_of[c] < 0) touched.push_back(c);
            lev_of[c] = 0;
            if (c < i) lower.push_back(c);
        }
        std::sort(lower.begin(), lower.end());
        // fills from U-row k are always > k, so insertion keeps order
        for (size_t p = 0; p < lower.size(); ++p) {
            const int64_t k = lower[p];
            const int64_t lk = lev_of[k];
            const auto& uc = u_cols[k];
            const auto& ul = u_lev[k];
            for (size_t j = 0; j < uc.size(); ++j) {
                const int64_t c = uc[j];
                const int64_t it = ul[j] + lk + 1;
                if (it > level || c == i) continue;
                if (lev_of[c] < 0) {
                    lev_of[c] = it;
                    touched.push_back(c);
                    if (c < i)
                        lower.insert(std::upper_bound(lower.begin() + p + 1,
                                                      lower.end(), c), c);
                } else if (lev_of[c] < it) {
                    lev_of[c] = it;          // reference max-update rule
                }
            }
        }
        auto& row = rows[i];
        row = touched;
        row.push_back(i);
        std::sort(row.begin(), row.end());
        row.erase(std::unique(row.begin(), row.end()), row.end());
        for (int64_t c : row) {
            if (c > i) {
                u_cols[i].push_back(c);
                u_lev[i].push_back(lev_of[c]);
            }
        }
        for (int64_t c : touched) lev_of[c] = -1;
        h->indptr[i + 1] = h->indptr[i] + (int64_t)row.size();
    }
    h->indices.reserve(h->indptr[n]);
    for (int64_t i = 0; i < n; ++i)
        h->indices.insert(h->indices.end(), rows[i].begin(), rows[i].end());
    *out_nnz = h->indptr[n];
    return h;
}

void lssp_pattern_fetch(void* handle, int64_t* indptr_out,
                        int64_t* indices_out, double* data_out) {
    auto* h = static_cast<PatternHandle*>(handle);
    std::memcpy(indptr_out, h->indptr.data(),
                h->indptr.size() * sizeof(int64_t));
    std::memcpy(indices_out, h->indices.data(),
                h->indices.size() * sizeof(int64_t));
    if (data_out && !h->data.empty())
        std::memcpy(data_out, h->data.data(), h->data.size() * sizeof(double));
}

void lssp_pattern_free(void* handle) {
    delete static_cast<PatternHandle*>(handle);
}

// ---------------------------------------------------------------------------
// Dual-threshold ILUT (Saad): drop new fill below tol·mean|row|, keep the
// p largest-|·| entries per L/U part, diagonal always kept (clamped).
// Row 0 copied verbatim.  Returns combined factor via handle.
// ---------------------------------------------------------------------------
void* lssp_ilut(const int64_t* indptr, const int64_t* indices,
                const double* data, int64_t n, double tol, int64_t p,
                double ztol, double zval, int64_t* out_nnz) {
    auto* h = new PatternHandle();
    h->indptr.assign(n + 1, 0);

    std::vector<std::vector<int64_t>> u_cols(n);
    std::vector<std::vector<double>> u_vals(n);
    std::vector<double> diag(n, 0.0);

    std::vector<std::vector<int64_t>> out_cols(n);
    std::vector<std::vector<double>> out_vals(n);

    // row 0 verbatim
    if (n > 0) {
        for (int64_t k = indptr[0]; k < indptr[1]; ++k) {
            out_cols[0].push_back(indices[k]);
            out_vals[0].push_back(data[k]);
            if (indices[k] > 0) {
                u_cols[0].push_back(indices[k]);
                u_vals[0].push_back(data[k]);
            }
        }
        double d0 = (indptr[1] > indptr[0] && indices[indptr[0]] == 0)
                        ? data[indptr[0]] : 0.0;
        if (std::fabs(d0) < ztol) d0 = d0 > 0 ? zval : -zval;
        diag[0] = d0;
    }

    std::vector<double> w(n, 0.0);
    std::vector<char> in_w(n, 0);

    for (int64_t i = 1; i < n; ++i) {
        const int64_t s = indptr[i], e = indptr[i + 1];
        double norm = 0.0;
        for (int64_t k = s; k < e; ++k) norm += std::fabs(data[k]);
        const double rel_tol = tol * norm / double(e - s);

        double wdiag = 0.0;
        std::vector<int64_t> lower, upper, touched;
        for (int64_t k = s; k < e; ++k) {
            const int64_t c = indices[k];
            if (c == i) { wdiag = data[k]; continue; }
            w[c] = data[k];
            in_w[c] = 1;
            touched.push_back(c);
            (c < i ? lower : upper).push_back(c);
        }
        std::sort(lower.begin(), lower.end());

        for (size_t pp = 0; pp < lower.size(); ++pp) {
            const int64_t k = lower[pp];
            const double a_ik = w[k] / diag[k];
            w[k] = a_ik;
            const auto& uc = u_cols[k];
            const auto& uv = u_vals[k];
            for (size_t j = 0; j < uc.size(); ++j) {
                const int64_t c = uc[j];
                const double mx = -a_ik * uv[j];
                if (c == i) { wdiag += mx; continue; }
                if (in_w[c]) {
                    w[c] += mx;
                } else {
                    if (std::fabs(mx) < rel_tol) continue;
                    w[c] = mx;
                    in_w[c] = 1;
                    touched.push_back(c);
                    if (c < i)
                        lower.insert(std::upper_bound(lower.begin() + pp + 1,
                                                      lower.end(), c), c);
                    else
                        upper.push_back(c);
                }
            }
        }

        if (std::fabs(wdiag) < ztol) wdiag = wdiag > 0 ? zval : -zval;
        diag[i] = wdiag;

        auto keep_top = [&](std::vector<int64_t>& cols) {
            if ((int64_t)cols.size() <= p) return;
            std::nth_element(cols.begin(), cols.begin() + p, cols.end(),
                             [&](int64_t a, int64_t b) {
                                 return std::fabs(w[a]) > std::fabs(w[b]);
                             });
            cols.resize(p);
        };
        keep_top(lower);
        keep_top(upper);
        std::sort(lower.begin(), lower.end());
        std::sort(upper.begin(), upper.end());

        auto& oc = out_cols[i];
        auto& ov = out_vals[i];
        for (int64_t c : lower) { oc.push_back(c); ov.push_back(w[c]); }
        oc.push_back(i); ov.push_back(wdiag);
        for (int64_t c : upper) {
            oc.push_back(c); ov.push_back(w[c]);
            u_cols[i].push_back(c); u_vals[i].push_back(w[c]);
        }
        // clear workspace: every column touched this row (including fill
        // later dropped by keep_top) was recorded in `touched`
        for (int64_t c : touched) in_w[c] = 0;
    }

    // fix indptr + flatten
    for (int64_t i = 0; i < n; ++i)
        h->indptr[i + 1] = h->indptr[i] + (int64_t)out_cols[i].size();
    h->indices.reserve(h->indptr[n]);
    h->data.reserve(h->indptr[n]);
    for (int64_t i = 0; i < n; ++i) {
        h->indices.insert(h->indices.end(), out_cols[i].begin(), out_cols[i].end());
        h->data.insert(h->data.end(), out_vals[i].begin(), out_vals[i].end());
    }
    *out_nnz = h->indptr[n];
    return h;
}

}  // extern "C"
