// LSD line segment detector on 8-bit grey images, as OpenCV's
// createLineSegmentDetector(LSD_REFINE_STD) computes it (von Gioi et al.,
// "LSD: a Line Segment Detector", IPOL 2012, with OpenCV's changes):
//
//   1. a Gaussian blur (7x7, sigma 0.6 / 0.8) and a sub-sampling to scale
//      0.8, both in OpenCV's bit-exact 8-bit fixed point (GaussianBlur with
//      BORDER_REFLECT_101, resize with INTER_LINEAR_EXACT);
//   2. 2x2 gradients, their norm and their level-line angle (OpenCV's
//      fastAtan2 polynomial, in degrees, then radians);
//   3. the pixels ordered by gradient bin (1024 bins), highest first, and
//      row-major within a bin: a stable order, which OpenCV 5's segments
//      reproduce bit for bit and an unstable std::sort of the row-major list
//      does not;
//   4. region growing at 22.5 degrees, the rectangle fit, the standard
//      refinement (a tighter angle, then a shrinking radius until the
//      region's density reaches 0.7), no NFA;
//   5. the +0.5 pixel offset and the rescale by 1 / 0.8.
//
// Plain C interface, loaded with ctypes. Build with -O2 -ffp-contract=off
// and no -ffast-math, so that every host computes the same bits.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.1415926535897932384626433832795;
constexpr double k32Pi = 4.71238898038;  // 3/2 pi, as OpenCV's lsd.cpp spells it
constexpr double k2Pi = 6.28318530718;   // 2 pi, likewise
constexpr double kNotDef = -1024.0;      // angle of a pixel without a gradient
constexpr double kDegToRad = kPi / 180;
constexpr double kRelativeErrorFactor = 100.0;
constexpr unsigned char kNotUsed = 0;
constexpr unsigned char kUsed = 1;

// OpenCV's defaults
constexpr double kScale = 0.8;
constexpr double kSigmaScale = 0.6;
constexpr double kQuant = 2.0;
constexpr double kAngTh = 22.5;
constexpr double kDensityTh = 0.7;
constexpr int kBins = 1024;

// --- cv::fastAtan2: a degree-7 polynomial in float, result in [0, 360) -------
const float kAtanP1 = 0.9997878412794807f * (float)(180 / kPi);
const float kAtanP3 = -0.3258083974640975f * (float)(180 / kPi);
const float kAtanP5 = 0.1555786518463281f * (float)(180 / kPi);
const float kAtanP7 = -0.04432655554792128f * (float)(180 / kPi);

float fast_atan2(float y, float x) {
  float ax = std::fabs(x), ay = std::fabs(y), a, c, c2;
  if (ax >= ay) {
    c = ay / (ax + (float)DBL_EPSILON);
    c2 = c * c;
    a = (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  } else {
    c = ax / (ay + (float)DBL_EPSILON);
    c2 = c * c;
    a = 90.f - (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// --- step 1: blur and sub-sampling in 8-bit fixed point -----------------------

int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
  return i;
}

// The kernel in 8 fractional bits: the normalised Gaussian rounded, the
// centre tap taking what makes the sum exactly 1 (OpenCV's bit-exact
// kernel; for sigma 0.75 and 7 taps it is 0 4 56 136 56 4 0).
std::vector<uint32_t> gaussian_kernel(int n, double sigma) {
  std::vector<double> v(n);
  double sum = 0;
  for (int i = 0; i < n; ++i) {
    double x = i - (n - 1) * 0.5;
    v[i] = std::exp(-x * x / (2 * sigma * sigma));
    sum += v[i];
  }
  std::vector<uint32_t> k(n);
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (i == n / 2) continue;
    k[i] = (uint32_t)std::lrint(v[i] / sum * 256.0);
    total += k[i];
  }
  k[n / 2] = 256 - total;
  return k;
}

// cv::GaussianBlur(src, dst, Size(n, n), sigma) on CV_8U: rows then columns,
// each product summed exactly, the result rounded once.
std::vector<uint8_t> gaussian_blur(const uint8_t* src, int w, int h, int n, double sigma) {
  std::vector<uint32_t> k = gaussian_kernel(n, sigma);
  int r = n / 2;
  std::vector<uint32_t> rows((size_t)w * h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      uint32_t acc = 0;
      for (int j = 0; j < n; ++j) acc += k[j] * src[(size_t)y * w + reflect101(x + j - r, w)];
      rows[(size_t)y * w + x] = acc;  // 8 fractional bits
    }
  std::vector<uint8_t> out((size_t)w * h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      uint32_t acc = 0;
      for (int j = 0; j < n; ++j) acc += k[j] * rows[(size_t)reflect101(y + j - r, h) * w + x];
      uint32_t v = (acc + (1u << 15)) >> 16;  // 16 fractional bits, rounded
      out[(size_t)y * w + x] = (uint8_t)std::min<uint32_t>(v, 255);
    }
  return out;
}

// cv::resize(src, dst, Size(), s, s, INTER_LINEAR_EXACT) on CV_8U: each
// destination pixel's source position (d + 0.5) / s - 0.5, its two taps'
// weights in 8 fractional bits, rows then columns, rounded once.
std::vector<uint8_t> resize_linear_exact(const std::vector<uint8_t>& src, int w, int h,
                                         double s, int* ow, int* oh) {
  int dw = (int)std::lrint(w * s), dh = (int)std::lrint(h * s);
  auto taps = [s](int n_dst, int n_src, std::vector<int>& idx, std::vector<uint32_t>& c0,
                  std::vector<uint32_t>& c1) {
    idx.resize(n_dst);
    c0.resize(n_dst);
    c1.resize(n_dst);
    for (int d = 0; d < n_dst; ++d) {
      double pos = (d + 0.5) / s - 0.5;
      int i = (int)std::floor(pos);
      uint32_t f = (uint32_t)std::lrint((pos - i) * 256.0);
      if (i < 0) {
        i = 0;
        f = 0;
      }
      if (i >= n_src - 1) {
        i = n_src - 1;
        f = 0;
      }
      idx[d] = i;
      c0[d] = 256 - f;
      c1[d] = f;
    }
  };
  std::vector<int> xs, ys;
  std::vector<uint32_t> cx0, cx1, cy0, cy1;
  taps(dw, w, xs, cx0, cx1);
  taps(dh, h, ys, cy0, cy1);
  std::vector<uint32_t> rows((size_t)h * dw);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < dw; ++x) {
      int x1 = std::min(xs[x] + 1, w - 1);
      rows[(size_t)y * dw + x] =
          src[(size_t)y * w + xs[x]] * cx0[x] + src[(size_t)y * w + x1] * cx1[x];
    }
  std::vector<uint8_t> out((size_t)dh * dw);
  for (int y = 0; y < dh; ++y) {
    int y1 = std::min(ys[y] + 1, h - 1);
    for (int x = 0; x < dw; ++x) {
      uint32_t acc = rows[(size_t)ys[y] * dw + x] * cy0[y] + rows[(size_t)y1 * dw + x] * cy1[y];
      out[(size_t)y * dw + x] = (uint8_t)std::min<uint32_t>((acc + (1u << 15)) >> 16, 255);
    }
  }
  *ow = dw;
  *oh = dh;
  return out;
}

// Blur and sub-sample as OpenCV 5's LSD does: kernel size and sigma both
// follow sigma_scale / scale (OpenCV 4 blurred with sigma_scale itself).
std::vector<uint8_t> gaussian_sampler(const uint8_t* image, int w, int h, int* ow, int* oh) {
  const double sigma = kScale < 1 ? kSigmaScale / kScale : kSigmaScale;
  const double sprec = 3;
  const int r = (int)std::ceil(sigma * std::sqrt(2 * sprec * std::log(10.0)));
  std::vector<uint8_t> blurred = gaussian_blur(image, w, h, 1 + 2 * r, sigma);
  return resize_linear_exact(blurred, w, h, kScale, ow, oh);
}

// --- steps 2-5 -----------------------------------------------------------------

struct NormPoint {
  int x, y;
  int norm;
};

struct RegionPoint {
  int x, y;
  unsigned char* used;
  double angle;
  double modgrad;
};

struct Rect {
  double x1, y1, x2, y2, width, x, y, theta, dx, dy, prec, p;
};

inline double dist(double x1, double y1, double x2, double y2) {
  return std::sqrt((x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1));
}

inline double dist_sq(double x1, double y1, double x2, double y2) {
  return (x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1);
}

inline double angle_diff_signed(double a, double b) {
  double diff = a - b;
  while (diff <= -kPi) diff += k2Pi;
  while (diff > kPi) diff -= k2Pi;
  return diff;
}

inline double angle_diff(double a, double b) { return std::fabs(angle_diff_signed(a, b)); }

inline bool double_equal(double a, double b) {
  if (a == b) return true;
  double abs_diff = std::fabs(a - b);
  double aa = std::fabs(a), bb = std::fabs(b);
  double abs_max = aa > bb ? aa : bb;
  if (abs_max < DBL_MIN) abs_max = DBL_MIN;
  return abs_diff / abs_max <= kRelativeErrorFactor * DBL_EPSILON;
}

class Detector {
 public:
  Detector(const uint8_t* scaled, int w, int h) : img_(scaled), w_(w), h_(h) {}

  // Segments (x1, y1, x2, y2, width) in the frame of the sub-sampled image,
  // already offset by 0.5 and divided by the scale.
  std::vector<float> detect() {
    const double prec = kPi * kAngTh / 180;
    const double p = kAngTh / 180;
    const double rho = kQuant / std::sin(prec);  // gradient magnitude threshold
    ll_angle(rho);
    const double log_nt = 5 * (std::log10((double)w_) + std::log10((double)h_)) / 2 +
                          std::log10(11.0);
    const size_t min_reg_size = (size_t)(-log_nt / std::log10(p));
    used_.assign((size_t)w_ * h_, kNotUsed);
    std::vector<RegionPoint> reg;
    std::vector<float> out;
    for (const NormPoint& pt : ordered_) {
      size_t i = (size_t)pt.y * w_ + pt.x;
      if (used_[i] != kNotUsed || angles_[i] == kNotDef) continue;
      double reg_angle;
      region_grow(pt.x, pt.y, reg, reg_angle, prec);
      if (reg.size() < min_reg_size) continue;
      Rect rec;
      region2rect(reg, reg_angle, prec, p, rec);
      if (!refine(reg, reg_angle, prec, p, rec, kDensityTh)) continue;
      rec.x1 += 0.5;
      rec.y1 += 0.5;
      rec.x2 += 0.5;
      rec.y2 += 0.5;
      rec.x1 /= kScale;
      rec.y1 /= kScale;
      rec.x2 /= kScale;
      rec.y2 /= kScale;
      rec.width /= kScale;
      out.insert(out.end(), {(float)rec.x1, (float)rec.y1, (float)rec.x2, (float)rec.y2,
                             (float)rec.width});
    }
    return out;
  }

 private:
  const uint8_t* img_;
  int w_, h_;
  std::vector<double> angles_, modgrad_;
  std::vector<unsigned char> used_;
  std::vector<NormPoint> ordered_;

  void ll_angle(double threshold) {
    angles_.assign((size_t)w_ * h_, kNotDef);
    modgrad_.assign((size_t)w_ * h_, 0.0);
    double max_grad = -1;
    for (int y = 0; y < h_ - 1; ++y) {
      const uint8_t* row = img_ + (size_t)y * w_;
      const uint8_t* next = row + w_;
      for (int x = 0; x < w_ - 1; ++x) {
        int DA = next[x + 1] - row[x];
        int BC = row[x + 1] - next[x];
        int gx = DA + BC;
        int gy = DA - BC;
        double norm = std::sqrt((gx * gx + gy * gy) / 4.0);
        size_t i = (size_t)y * w_ + x;
        modgrad_[i] = norm;
        if (norm <= threshold) {
          angles_[i] = kNotDef;
        } else {
          angles_[i] = fast_atan2((float)gx, (float)-gy) * kDegToRad;
          if (norm > max_grad) max_grad = norm;
        }
      }
    }
    // a counting sort by bin, highest first, row-major within a bin
    double bin_coef = max_grad > 0 ? double(kBins - 1) / max_grad : 0;
    std::vector<int> bins((size_t)(w_ - 1) * (h_ - 1));
    std::vector<size_t> start(kBins + 1, 0);
    for (int y = 0; y < h_ - 1; ++y)
      for (int x = 0; x < w_ - 1; ++x) {
        int b = (int)(modgrad_[(size_t)y * w_ + x] * bin_coef);
        bins[(size_t)y * (w_ - 1) + x] = b;
        ++start[kBins - 1 - b + 1];
      }
    for (int b = 0; b < kBins; ++b) start[b + 1] += start[b];
    ordered_.assign(bins.size(), NormPoint{0, 0, 0});
    for (int y = 0; y < h_ - 1; ++y)
      for (int x = 0; x < w_ - 1; ++x) {
        int b = bins[(size_t)y * (w_ - 1) + x];
        ordered_[start[kBins - 1 - b]++] = {x, y, b};
      }
  }

  bool is_aligned(int x, int y, double theta, double prec) const {
    if (x < 0 || y < 0 || x >= w_ || y >= h_) return false;
    double a = angles_[(size_t)y * w_ + x];
    if (a == kNotDef) return false;
    double n_theta = theta - a;
    if (n_theta < 0) n_theta = -n_theta;
    if (n_theta > k32Pi) {
      n_theta -= k2Pi;
      if (n_theta < 0) n_theta = -n_theta;
    }
    return n_theta <= prec;
  }

  void region_grow(int sx, int sy, std::vector<RegionPoint>& reg, double& reg_angle,
                   double prec) {
    reg.clear();
    size_t si = (size_t)sy * w_ + sx;
    reg_angle = angles_[si];
    reg.push_back({sx, sy, &used_[si], reg_angle, modgrad_[si]});
    float sumdx = (float)std::cos(reg_angle);
    float sumdy = (float)std::sin(reg_angle);
    used_[si] = kUsed;
    for (size_t i = 0; i < reg.size(); ++i) {
      int px = reg[i].x, py = reg[i].y;
      int xx_min = std::max(px - 1, 0), xx_max = std::min(px + 1, w_ - 1);
      int yy_min = std::max(py - 1, 0), yy_max = std::min(py + 1, h_ - 1);
      for (int yy = yy_min; yy <= yy_max; ++yy)
        for (int xx = xx_min; xx <= xx_max; ++xx) {
          size_t j = (size_t)yy * w_ + xx;
          if (used_[j] != kUsed && is_aligned(xx, yy, reg_angle, prec)) {
            double angle = angles_[j];
            used_[j] = kUsed;
            reg.push_back({xx, yy, &used_[j], angle, modgrad_[j]});
            sumdx += std::cos((float)angle);
            sumdy += std::sin((float)angle);
            reg_angle = fast_atan2(sumdy, sumdx) * kDegToRad;
          }
        }
    }
  }

  double get_theta(const std::vector<RegionPoint>& reg, double x, double y, double reg_angle,
                   double prec) const {
    double Ixx = 0.0, Iyy = 0.0, Ixy = 0.0;
    for (const RegionPoint& r : reg) {
      double dx = (double)r.x - x;
      double dy = (double)r.y - y;
      Ixx += dy * dy * r.modgrad;
      Iyy += dx * dx * r.modgrad;
      Ixy -= dx * dy * r.modgrad;
    }
    (void)double_equal;  // OpenCV asserts a non-null inertia matrix here
    double lambda = 0.5 * (Ixx + Iyy - std::sqrt((Ixx - Iyy) * (Ixx - Iyy) + 4.0 * Ixy * Ixy));
    double theta = std::fabs(Ixx) > std::fabs(Iyy)
                       ? double(fast_atan2((float)(lambda - Ixx), (float)Ixy))
                       : double(fast_atan2((float)Ixy, (float)(lambda - Iyy)));
    theta *= kDegToRad;
    if (angle_diff(theta, reg_angle) > prec) theta += kPi;
    return theta;
  }

  void region2rect(const std::vector<RegionPoint>& reg, double reg_angle, double prec, double p,
                   Rect& rec) const {
    double x = 0, y = 0, sum = 0;
    for (const RegionPoint& r : reg) {
      x += double(r.x) * r.modgrad;
      y += double(r.y) * r.modgrad;
      sum += r.modgrad;
    }
    x /= sum;
    y /= sum;
    double theta = get_theta(reg, x, y, reg_angle, prec);
    double dx = std::cos(theta), dy = std::sin(theta);
    double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
    for (const RegionPoint& r : reg) {
      double regdx = double(r.x) - x;
      double regdy = double(r.y) - y;
      double l = regdx * dx + regdy * dy;
      double w = -regdx * dy + regdy * dx;
      if (l > l_max)
        l_max = l;
      else if (l < l_min)
        l_min = l;
      if (w > w_max)
        w_max = w;
      else if (w < w_min)
        w_min = w;
    }
    rec.x1 = x + l_min * dx;
    rec.y1 = y + l_min * dy;
    rec.x2 = x + l_max * dx;
    rec.y2 = y + l_max * dy;
    rec.width = w_max - w_min;
    rec.x = x;
    rec.y = y;
    rec.theta = theta;
    rec.dx = dx;
    rec.dy = dy;
    rec.prec = prec;
    rec.p = p;
    if (rec.width < 1.0) rec.width = 1.0;
  }

  bool reduce_region_radius(std::vector<RegionPoint>& reg, double reg_angle, double prec,
                            double p, Rect& rec, double density, double density_th) {
    double xc = double(reg[0].x), yc = double(reg[0].y);
    double rad1 = dist_sq(xc, yc, rec.x1, rec.y1);
    double rad2 = dist_sq(xc, yc, rec.x2, rec.y2);
    double rad = rad1 > rad2 ? rad1 : rad2;
    while (density < density_th) {
      rad *= 0.75 * 0.75;  // the radius to 75% of its value
      for (size_t i = 0; i < reg.size(); ++i) {
        if (dist_sq(xc, yc, double(reg[i].x), double(reg[i].y)) > rad) {
          *(reg[i].used) = kNotUsed;
          std::swap(reg[i], reg[reg.size() - 1]);
          reg.pop_back();
          --i;  // (wraps at 0 and comes back with ++i) not to skip the swapped point
        }
      }
      if (reg.size() < 2) return false;
      region2rect(reg, reg_angle, prec, p, rec);
      density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    }
    return true;
  }

  bool refine(std::vector<RegionPoint>& reg, double reg_angle, double prec, double p, Rect& rec,
              double density_th) {
    double density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    if (density >= density_th) return true;
    // a tighter angle tolerance: twice the spread of the angles near the seed
    double xc = double(reg[0].x), yc = double(reg[0].y);
    const double ang_c = reg[0].angle;
    double sum = 0, s_sum = 0;
    int n = 0;
    for (RegionPoint& r : reg) {
      *(r.used) = kNotUsed;
      if (dist(xc, yc, r.x, r.y) < rec.width) {
        double ang_d = angle_diff_signed(r.angle, ang_c);
        sum += ang_d;
        s_sum += ang_d * ang_d;
        ++n;
      }
    }
    double mean_angle = sum / double(n);
    double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean_angle * sum) / double(n) +
                                 mean_angle * mean_angle);
    region_grow(reg[0].x, reg[0].y, reg, reg_angle, tau);
    if (reg.size() < 2) return false;
    region2rect(reg, reg_angle, prec, p, rec);
    density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
    if (density < density_th)
      return reduce_region_radius(reg, reg_angle, prec, p, rec, density, density_th);
    return true;
  }
};

}  // namespace

extern "C" {

// Detect the segments of a (h, w) row-major 8-bit image. Returns a handle to
// them and their count in *count; lsd_take copies them (5 floats each: x1,
// y1, x2, y2, width, in OpenCV's order) into out and frees the handle.
void* lsd_detect(const uint8_t* image, int w, int h, int* count) {
  int sw = 0, sh = 0;
  std::vector<uint8_t> scaled = gaussian_sampler(image, w, h, &sw, &sh);
  auto* segments = new std::vector<float>(Detector(scaled.data(), sw, sh).detect());
  *count = (int)(segments->size() / 5);
  return segments;
}

void lsd_take(void* handle, float* out) {
  auto* segments = static_cast<std::vector<float>*>(handle);
  std::memcpy(out, segments->data(), segments->size() * sizeof(float));
  delete segments;
}

// The blurred and sub-sampled image that LSD works on (for the tests):
// writes it into out (capacity at least w * h) and its size into ow, oh.
void lsd_scaled_image(const uint8_t* image, int w, int h, uint8_t* out, int* ow, int* oh) {
  std::vector<uint8_t> scaled = gaussian_sampler(image, w, h, ow, oh);
  std::memcpy(out, scaled.data(), scaled.size());
}

float lsd_fast_atan2(float y, float x) { return fast_atan2(y, x); }

}  // extern "C"
