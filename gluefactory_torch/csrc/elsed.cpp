// ELSED-class line segment detector (Enhanced Line SEgment Drawing family) on
// float grey images in [0, 1]: Sobel gradients, anchors at the gradient's
// local maxima across the edge, strongest first; from each anchor a greedy
// 8-neighbour walk both ways along the edge, growing an incremental
// orthogonal least-squares line fit and stopping where its rms deviation
// exceeds dev_tol; segments shorter than min_len are released. Segments are
// scored by their mean gradient times their length and written, strongest
// first, into max_lines static slots.
//
// A copy of the JAX package's native detector, step for step, so that both
// give the same segments bit for bit on x86 (gluefactory_torch/models/lines/
// elsed.py). Plain C interface, loaded with ctypes; built with -O2
// -ffp-contract=off, which keeps every product rounded as the JAX package's
// -O3 build rounds it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Fit {
  // incremental orthogonal least squares over visited pixels
  double sx = 0, sy = 0, sxx = 0, syy = 0, sxy = 0;
  int n = 0;
  void add(double x, double y) {
    sx += x; sy += y; sxx += x * x; syy += y * y; sxy += x * y; ++n;
  }
  // principal direction + rms orthogonal deviation
  void line(double& cx, double& cy, double& ux, double& uy, double& rms) const {
    cx = sx / n; cy = sy / n;
    double vxx = sxx / n - cx * cx, vyy = syy / n - cy * cy,
           vxy = sxy / n - cx * cy;
    double tr = vxx + vyy, det = vxx * vyy - vxy * vxy;
    double disc = std::sqrt(std::max(tr * tr / 4 - det, 0.0));
    double l1 = tr / 2 + disc, l2 = tr / 2 - disc;
    if (std::abs(vxy) > 1e-12) { ux = l1 - vyy; uy = vxy; }
    else if (vxx >= vyy) { ux = 1; uy = 0; }
    else { ux = 0; uy = 1; }
    double nrm = std::sqrt(ux * ux + uy * uy);
    ux /= nrm; uy /= nrm;
    rms = std::sqrt(std::max(l2, 0.0));
  }
};

}  // namespace

extern "C" int elsed_detect(
    const float* img, int h, int w,
    float grad_th,      // minimum gradient magnitude for edge pixels
    float dev_tol,      // max rms orthogonal deviation of a segment (px)
    int min_len,        // minimum segment length (px)
    int max_lines,      // output slot count
    float* out_segs,    // (max_lines, 4) x0 y0 x1 y1
    float* out_scores)  // (max_lines,) mean gradient magnitude
{
  const int N = h * w;
  std::vector<float> gx(N, 0.f), gy(N, 0.f), mag(N, 0.f);
  // Sobel
  for (int y = 1; y < h - 1; ++y) {
    for (int x = 1; x < w - 1; ++x) {
      const int i = y * w + x;
      const float tl = img[i - w - 1], tc = img[i - w], tr_ = img[i - w + 1];
      const float ml = img[i - 1], mr = img[i + 1];
      const float bl = img[i + w - 1], bc = img[i + w], br = img[i + w + 1];
      gx[i] = (tr_ + 2 * mr + br - tl - 2 * ml - bl) * 0.25f;
      gy[i] = (bl + 2 * bc + br - tl - 2 * tc - tr_) * 0.25f;
      mag[i] = std::sqrt(gx[i] * gx[i] + gy[i] * gy[i]);
    }
  }
  // anchors: gradient local maxima across the edge direction
  std::vector<int> anchors;
  anchors.reserve(N / 16);
  for (int y = 2; y < h - 2; ++y) {
    for (int x = 2; x < w - 2; ++x) {
      const int i = y * w + x;
      if (mag[i] < grad_th) continue;
      // compare along gradient direction (horizontal vs vertical edge)
      bool horiz_edge = std::abs(gy[i]) >= std::abs(gx[i]);
      float a, b;
      if (horiz_edge) { a = mag[i - w]; b = mag[i + w]; }
      else            { a = mag[i - 1]; b = mag[i + 1]; }
      if (mag[i] >= a && mag[i] >= b) anchors.push_back(i);
    }
  }
  // sort anchors by magnitude, strongest first
  std::sort(anchors.begin(), anchors.end(),
            [&](int a, int b) { return mag[a] > mag[b]; });

  std::vector<uint8_t> used(N, 0);
  struct Seg { float x0, y0, x1, y1, score; };
  std::vector<Seg> segs;

  auto walk = [&](int start, int dir_sign, Fit& fit, double& score_sum,
                  int& count, std::vector<int>& visited) {
    int cur = start;
    int px = start % w, py = start / w;
    for (;;) {
      // edge direction = perpendicular to gradient
      const float ex = -gy[cur], ey = gx[cur];
      float nrm = std::sqrt(ex * ex + ey * ey);
      if (nrm < 1e-9f) break;
      const float dx = dir_sign * ex / nrm, dy = dir_sign * ey / nrm;
      // candidate next pixels: the 3 neighbours nearest the edge direction
      int bx = 0, by = 0; float best = -1.f;
      for (int oy = -1; oy <= 1; ++oy) {
        for (int ox = -1; ox <= 1; ++ox) {
          if (!ox && !oy) continue;
          const float align = ox * dx + oy * dy;
          if (align < 0.5f) continue;
          const int nx2 = px + ox, ny2 = py + oy;
          if (nx2 < 1 || ny2 < 1 || nx2 >= w - 1 || ny2 >= h - 1) continue;
          const int ni = ny2 * w + nx2;
          if (used[ni] || mag[ni] < grad_th) continue;
          if (mag[ni] > best) { best = mag[ni]; bx = ox; by = oy; }
        }
      }
      if (best < 0) break;
      px += bx; py += by;
      cur = py * w + px;
      // tentative: does the fit stay within tolerance?
      Fit trial = fit;
      trial.add(px, py);
      if (trial.n >= 4) {
        double cx, cy, ux, uy, rms;
        trial.line(cx, cy, ux, uy, rms);
        if (rms > dev_tol) break;  // direction change: stop this segment
      }
      fit = trial;
      used[cur] = 1;
      visited.push_back(cur);
      score_sum += mag[cur];
      ++count;
    }
  };

  for (int a : anchors) {
    if (used[a]) continue;
    Fit fit;
    fit.add(a % w, a / w);
    used[a] = 1;
    std::vector<int> visited{a};
    double score_sum = mag[a];
    int count = 1;
    walk(a, +1, fit, score_sum, count, visited);
    walk(a, -1, fit, score_sum, count, visited);
    if (fit.n < std::max(min_len, 4)) {
      // too short: release pixels so other anchors may claim them
      for (int i : visited) used[i] = 0;
      continue;
    }
    double cx, cy, ux, uy, rms;
    fit.line(cx, cy, ux, uy, rms);
    // extent along the principal direction
    double tmin = 1e18, tmax = -1e18;
    for (int i : visited) {
      const double t = (i % w - cx) * ux + (i / w - cy) * uy;
      tmin = std::min(tmin, t);
      tmax = std::max(tmax, t);
    }
    if (tmax - tmin < min_len) {
      for (int i : visited) used[i] = 0;
      continue;
    }
    segs.push_back({
        float(cx + tmin * ux), float(cy + tmin * uy),
        float(cx + tmax * ux), float(cy + tmax * uy),
        float(score_sum / count * (tmax - tmin)),
    });
  }
  // strongest first, fill static slots
  std::sort(segs.begin(), segs.end(),
            [](const Seg& a, const Seg& b) { return a.score > b.score; });
  const int n_out = std::min<int>(segs.size(), max_lines);
  std::memset(out_segs, 0, sizeof(float) * 4 * max_lines);
  std::memset(out_scores, 0, sizeof(float) * max_lines);
  for (int i = 0; i < n_out; ++i) {
    out_segs[i * 4 + 0] = segs[i].x0;
    out_segs[i * 4 + 1] = segs[i].y0;
    out_segs[i * 4 + 2] = segs[i].x1;
    out_segs[i * 4 + 3] = segs[i].y1;
    out_scores[i] = segs[i].score;
  }
  return n_out;
}
