// Batched linear assignment (Jonker-Volgenant shortest augmenting path with
// dual potentials), the exact one-to-one assignment of the line benchmarks
// (gluefactory_torch/ops/lap.py): every row of an n x m cost matrix (n <= m)
// is assigned a distinct column at the least total cost. Infeasible pairs
// carry a large finite cost; the caller rejects them afterwards.
//
// A copy of the JAX package's native solver, step for step, so that both
// packages make the same choice on ties. The batch loop carries an OpenMP
// pragma; the port's host flags build without -fopenmp, so the batch runs in
// order (the line benchmarks solve one problem a call). No omp_* function is
// called, so the library links either way.
//
// Plain C interface, loaded with ctypes; built with -O2 -ffp-contract=off.

#include <cfloat>
#include <cstring>
#include <vector>

namespace {

// Shortest-augmenting-path assignment with dual potentials (JV/Dijkstra).
void solve_one(const float* cost, int n, int m, int* row_to_col) {
  std::vector<double> u(n, 0.0), v(m, 0.0);
  std::vector<int> col_to_row(m, -1);
  std::vector<int> row_assign(n, -1);
  std::vector<double> dist(m);
  std::vector<int> pred(m);
  std::vector<char> done(m);

  for (int r = 0; r < n; ++r) {
    for (int j = 0; j < m; ++j) {
      dist[j] = double(cost[size_t(r) * m + j]) - u[r] - v[j];
      pred[j] = r;
      done[j] = 0;
    }
    int sink = -1;
    double delta = 0.0;
    while (sink == -1) {
      double best = DBL_MAX;
      int jstar = -1;
      for (int j = 0; j < m; ++j) {
        if (!done[j] && dist[j] < best) {
          best = dist[j];
          jstar = j;
        }
      }
      if (jstar == -1) break;  // no augmenting path (all costs infinite)
      done[jstar] = 1;
      delta = best;
      if (col_to_row[jstar] == -1) {
        sink = jstar;
      } else {
        int i = col_to_row[jstar];
        for (int j = 0; j < m; ++j) {
          if (done[j]) continue;
          double nd = delta + double(cost[size_t(i) * m + j]) - u[i] - v[j];
          if (nd < dist[j]) {
            dist[j] = nd;
            pred[j] = i;
          }
        }
      }
    }
    if (sink == -1) continue;  // row stays unassigned
    // Dual update keeps all reduced costs non-negative.
    u[r] += delta;
    for (int j = 0; j < m; ++j) {
      if (!done[j] || j == sink) continue;
      int i = col_to_row[j];
      v[j] += dist[j] - delta;
      if (i != -1) u[i] += delta - dist[j];
    }
    // Augment along the predecessor chain.
    int j = sink;
    while (true) {
      int i = pred[j];
      col_to_row[j] = i;
      int jnext = row_assign[i];
      row_assign[i] = j;
      if (i == r) break;
      j = jnext;
    }
  }
  std::memcpy(row_to_col, row_assign.data(), sizeof(int) * n);
}

}  // namespace

extern "C" {

// costs: B x N x M row-major float32; out: B x N int32 (col per row, -1 none)
void batch_lap(const float* costs, int batch, int n, int m, int* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int b = 0; b < batch; ++b) {
    solve_one(costs + size_t(b) * n * m, n, m, out + size_t(b) * n);
  }
}

}  // extern "C"
