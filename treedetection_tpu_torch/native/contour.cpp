// Native contour tracer: binary mask -> boundary polygons.
//
// Replaces cv2.findContours in the mask->polygon stage (reference
// prediction.py:232-234).  Implements Suzuki-Abe style border following with
// 8-connectivity for both outer borders and hole borders, plus
// CHAIN_APPROX_SIMPLE-style compression of collinear runs, so output matches
// OpenCV closely enough that downstream simplify(tolerance) produces
// equivalent crowns.
//
// C ABI (ctypes):
//   int td_trace_contours(const uint8_t* mask, int h, int w,
//                         int32_t* out_xy, int32_t* out_sizes,
//                         uint8_t* out_is_hole,
//                         int max_points, int max_contours);
// Returns the number of contours written; points are interleaved x,y pixel
// coordinates, contour c occupying sizes[c] points.
//
// Also exports td_lzw_decode (TIFF LZW fast path for geo/tiff.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// 8-neighborhood in clockwise order starting east.
const int DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

struct Tracer {
  const uint8_t* mask;
  int h, w;
  std::vector<int32_t> labels;  // border bookkeeping per Suzuki-Abe

  Tracer(const uint8_t* m, int hh, int ww) : mask(m), h(hh), w(ww),
      labels(static_cast<size_t>(hh) * ww, 0) {}

  inline bool fg(int y, int x) const {
    return y >= 0 && y < h && x >= 0 && x < w && mask[(size_t)y * w + x] != 0;
  }

  // Follow one border starting at (y, x); `start_dir` points at the background
  // pixel that triggered the trace.  Suzuki-Abe steps 3.1-3.5: clockwise scan
  // for the first neighbor, then repeated counter-clockwise scans; terminate
  // when the walk re-enters (start, first-neighbor).  Emits (x, y) points.
  void follow(int y, int x, int start_dir, int32_t nbd,
              std::vector<int32_t>& out_xy) {
    labels[(size_t)y * w + x] = nbd;
    // 3.1: clockwise search from start_dir for the first foreground neighbor
    int s = -1;
    for (int k = 0; k < 8; ++k) {
      int d = (start_dir + k) % 8;
      if (fg(y + DY[d], x + DX[d])) { s = d; break; }
    }
    if (s < 0) {  // isolated pixel
      out_xy.push_back(x);
      out_xy.push_back(y);
      return;
    }
    const int y1 = y + DY[s], x1 = x + DX[s];   // (i1, j1)
    int y2 = y1, x2 = x1;                        // (i2, j2)
    int y3 = y, x3 = x;                          // (i3, j3)
    const size_t max_steps = 4 * (size_t)h * w + 64;
    size_t steps = 0;
    while (steps++ < max_steps) {
      // 3.3: counter-clockwise search around (i3) starting after dir(i3->i2)
      int d0 = -1;
      for (int k = 0; k < 8; ++k) {
        if (y3 + DY[k] == y2 && x3 + DX[k] == x2) { d0 = k; break; }
      }
      int nd = -1;
      for (int k = 1; k <= 8; ++k) {
        int d = (d0 - k + 16) % 8;
        if (fg(y3 + DY[d], x3 + DX[d])) { nd = d; break; }
      }
      const int y4 = y3 + DY[nd], x4 = x3 + DX[nd];
      out_xy.push_back(x3);
      out_xy.push_back(y3);
      labels[(size_t)y3 * w + x3] = nbd;
      // 3.5: full cycle when the next pixel is the start and the current one
      // is the first neighbor
      if (y4 == y && x4 == x && y3 == y1 && x3 == x1) break;
      y2 = y3; x2 = x3;
      y3 = y4; x3 = x4;
    }
  }
};

// CHAIN_APPROX_SIMPLE: drop points collinear with their neighbors along
// horizontal/vertical/diagonal runs.
void compress(const std::vector<int32_t>& in, std::vector<int32_t>& out) {
  size_t n = in.size() / 2;
  if (n <= 2) { out = in; return; }
  for (size_t i = 0; i < n; ++i) {
    size_t p = (i + n - 1) % n, q = (i + 1) % n;
    int32_t ax = in[2 * p], ay = in[2 * p + 1];
    int32_t bx = in[2 * i], by = in[2 * i + 1];
    int32_t cx = in[2 * q], cy = in[2 * q + 1];
    long cross = (long)(bx - ax) * (cy - ay) - (long)(by - ay) * (cx - ax);
    if (cross != 0 || (ax == cx && ay == cy)) {
      out.push_back(bx);
      out.push_back(by);
    }
  }
  if (out.size() < 6) out = in;
}

}  // namespace

extern "C" {

// Bilinear-resize a soft uint8 mask (e.g. the model's 28x28 sigmoid*255)
// to (out_h, out_w) and threshold to a 0/1 binary mask in one pass —
// half-pixel-center sampling (align_corners=False bilinear interpolation).
int td_resize_threshold(const uint8_t* mask, int in_h, int in_w,
                        uint8_t* out, int out_h, int out_w, float thresh) {
  // double precision + the EXACT weighted-sum form of a numpy bilinear resize and
  // association order (a00*(1-ly)*(1-lx) + a01*(1-ly)*lx + ... summed left
  // to right): the float32 lerp form differed by rounding, which could flip
  // the threshold on values within float32 eps of 127.5.
  std::vector<int> x0(out_w), x1(out_w);
  std::vector<double> lx(out_w);
  for (int j = 0; j < out_w; ++j) {
    double sx = (j + 0.5) * in_w / out_w - 0.5;
    double fl = std::floor(sx);
    int xx0 = (int)fl;
    if (xx0 < 0) xx0 = 0;
    if (xx0 > in_w - 1) xx0 = in_w - 1;
    double f = sx - xx0;                 // numpy: ys - CLIPPED y0
    if (f < 0.) f = 0.;
    if (f > 1.) f = 1.;
    int xx1 = xx0 + 1 < in_w ? xx0 + 1 : in_w - 1;
    x0[j] = xx0; x1[j] = xx1; lx[j] = f;
  }
  const double dthresh = (double)thresh;
  for (int i = 0; i < out_h; ++i) {
    double sy = (i + 0.5) * in_h / out_h - 0.5;
    double flv = std::floor(sy);
    int y0 = (int)flv;
    if (y0 < 0) y0 = 0;
    if (y0 > in_h - 1) y0 = in_h - 1;
    double fy = sy - y0;
    if (fy < 0.) fy = 0.;
    if (fy > 1.) fy = 1.;
    int y1 = y0 + 1 < in_h ? y0 + 1 : in_h - 1;
    const uint8_t* r0 = mask + (size_t)y0 * in_w;
    const uint8_t* r1 = mask + (size_t)y1 * in_w;
    uint8_t* orow = out + (size_t)i * out_w;
    for (int j = 0; j < out_w; ++j) {
      double v = ((double)r0[x0[j]] * (1.0 - fy) * (1.0 - lx[j])
                  + (double)r0[x1[j]] * (1.0 - fy) * lx[j])
                 + (double)r1[x0[j]] * fy * (1.0 - lx[j]);
      v = v + (double)r1[x1[j]] * fy * lx[j];
      orow[j] = v > dthresh ? 1 : 0;
    }
  }
  return 0;
}

int td_trace_contours(const uint8_t* mask, int h, int w,
                      int32_t* out_xy, int32_t* out_sizes,
                      uint8_t* out_is_hole,
                      int max_points, int max_contours) {
  Tracer tr(mask, h, w);
  int n_contours = 0;
  int points_used = 0;
  int32_t nbd = 1;
  std::vector<int32_t> raw, simple;
  for (int y = 0; y < h && n_contours < max_contours; ++y) {
    const uint8_t* row = mask + (size_t)y * w;
    for (int x = 0; x < w && n_contours < max_contours; ++x) {
      // fast-skip runs of background: the raster scan dominates large
      // sparse masks, so hop 8 bytes at a time over zero words
      while (x + 8 <= w) {
        uint64_t word;
        std::memcpy(&word, row + x, 8);
        if (word != 0) break;
        x += 8;
      }
      if (x >= w) break;
      if (!tr.fg(y, x)) continue;
      size_t idx = (size_t)y * w + x;
      bool outer = !tr.fg(y, x - 1) && tr.labels[idx] == 0;
      bool hole = tr.fg(y, x) && !tr.fg(y, x + 1) &&
                  tr.labels[(size_t)y * w + x] == 0 && !outer;
      // Only start traces at unvisited outer-border pixels; holes get their
      // own trace so downstream can choose to drop them (reference keeps all
      // contours as separate polygons, prediction.py:235-251).
      int start_dir;
      if (outer) start_dir = 4;          // background to the west
      else if (hole) start_dir = 0;      // background to the east
      else continue;
      ++nbd;
      raw.clear();
      simple.clear();
      tr.follow(y, x, start_dir, nbd, raw);
      compress(raw, simple);
      int npts = (int)(simple.size() / 2);
      if (points_used + npts > max_points) return n_contours;
      std::memcpy(out_xy + 2 * points_used, simple.data(),
                  simple.size() * sizeof(int32_t));
      out_sizes[n_contours] = npts;
      out_is_hole[n_contours] = hole ? 1 : 0;
      ++n_contours;
      points_used += npts;
    }
  }
  return n_contours;
}

// --- Douglas-Peucker ring simplification -----------------------------------
//
// Exact native twin of vector/polygon.py:simplify_polygon (shapely
// ``simplify`` semantics, reference helpers.py:463-464): anchor the ring at
// vertex 0 and its farthest vertex, then stack-DP both chains with
// clamped point-to-segment distance.  All arithmetic in double, same
// operation order and first-max tie-breaking as the numpy version, so the
// keep set is bit-identical.
//
//   int td_simplify_dp(const double* xy, int n, double tol2, uint8_t* keep);
//
// xy: open ring, n points, interleaved x,y.  Writes keep flags (0/1) for all
// n vertices.  Returns the number kept, or n when pivot==0 (caller keeps the
// ring unchanged, matching the Python early return).

int td_simplify_dp(const double* xy, int n, double tol2, uint8_t* keep) {
  if (n < 4) {
    for (int i = 0; i < n; ++i) keep[i] = 1;
    return n;
  }
  // farthest vertex from vertex 0 (first max wins, like np.argmax)
  const double x0 = xy[0], y0 = xy[1];
  int pivot = 0;
  double best = 0.0;
  for (int i = 0; i < n; ++i) {
    const double dx = xy[2 * i] - x0, dy = xy[2 * i + 1] - y0;
    const double d2 = dx * dx + dy * dy;
    if (d2 > best) { best = d2; pivot = i; }
  }
  if (pivot == 0) {
    for (int i = 0; i < n; ++i) keep[i] = 1;
    return n;
  }
  std::memset(keep, 0, (size_t)n);
  keep[0] = keep[pivot] = 1;

  // index n wraps to vertex 0 (the Python version appends c[0] to pts)
  auto px = [&](int i) { return i == n ? xy[0] : xy[2 * i]; };
  auto py = [&](int i) { return i == n ? xy[1] : xy[2 * i + 1]; };

  std::vector<std::pair<int, int>> stack;
  stack.reserve(64);
  stack.emplace_back(0, pivot);
  stack.emplace_back(pivot, n);
  int kept = 2;
  while (!stack.empty()) {
    const int i = stack.back().first, j = stack.back().second;
    stack.pop_back();
    if (j - i < 2) continue;
    const double ax = px(i), ay = py(i);
    const double abx = px(j) - ax, aby = py(j) - ay;
    const double denom = abx * abx + aby * aby;
    int kmax = -1;
    double dmax = -1.0;
    for (int m = i + 1; m < j; ++m) {
      const double rx = px(m) - ax, ry = py(m) - ay;
      double d2;
      if (denom < 1e-18) {
        d2 = rx * rx + ry * ry;
      } else {
        double t = (rx * abx + ry * aby) / denom;
        if (t < 0.0) t = 0.0;
        if (t > 1.0) t = 1.0;
        const double dx = rx - t * abx, dy = ry - t * aby;
        d2 = dx * dx + dy * dy;
      }
      if (d2 > dmax) { dmax = d2; kmax = m; }
    }
    if (kmax >= 0 && dmax > tol2) {
      if (!keep[kmax % n]) { keep[kmax % n] = 1; ++kept; }
      stack.emplace_back(i, kmax);
      stack.emplace_back(kmax, j);
    }
  }
  return kept;
}

// --- TIFF LZW decoder (MSB-first, early change) ---------------------------

int td_lzw_decode(const uint8_t* src, long src_len, uint8_t* dst,
                  long dst_cap) {
  const int CLEAR = 256, EOI = 257;
  // dictionary as (prev_code, suffix byte); strings materialized on emit
  std::vector<int32_t> prev(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack;
  stack.reserve(4096);

  int next_code = 258;
  int nbits = 9;
  long bitpos = 0;
  long total_bits = src_len * 8;
  long out = 0;
  int prev_code = -1;

  auto emit = [&](int code) -> int {  // returns first byte of string
    stack.clear();
    int c = code;
    while (c >= 258) {
      stack.push_back(suffix[c]);
      c = prev[c];
    }
    uint8_t first = (uint8_t)c;
    if (out < dst_cap) dst[out++] = first;
    for (auto it = stack.rbegin(); it != stack.rend(); ++it) {
      if (out < dst_cap) dst[out++] = *it;
    }
    return first;
  };

  while (bitpos + nbits <= total_bits && out < dst_cap) {
    long byte_idx = bitpos >> 3;
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      v = (v << 8) | (byte_idx + i < src_len ? src[byte_idx + i] : 0);
    }
    int code = (v >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1);
    bitpos += nbits;
    if (code == EOI) break;
    if (code == CLEAR) {
      next_code = 258;
      nbits = 9;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      emit(code);
      prev_code = code;
    } else {
      int first;
      if (code < next_code) {
        first = emit(code);
      } else if (code == next_code) {
        // KwKwK case: emit prev + first(prev)
        stack.clear();
        int c = prev_code;
        while (c >= 258) { stack.push_back(suffix[c]); c = prev[c]; }
        first = (uint8_t)c;
        emit(prev_code);
        if (out < dst_cap) dst[out++] = (uint8_t)first;
      } else {
        return -1;  // corrupt stream
      }
      if (next_code < 4096) {
        prev[next_code] = prev_code;
        suffix[next_code] = (uint8_t)first;
        ++next_code;
      }
      prev_code = code;
    }
    // early change, decoder side: one entry earlier than the encoder's
    // (1<<n)-1 because the decoder's table lags by one pending entry
    if (next_code >= (1 << nbits) - 2 && nbits < 12) ++nbits;
  }
  return (int)out;  // bytes written; -1 already returned on corrupt streams
}

}  // extern "C"
