// BAL text-format parser: one strtod / strtol sweep over the whole file
// (https://grail.cs.washington.edu/projects/bal/):
//
//   num_cameras num_points num_observations
//   cam_idx point_idx x y            (x num_observations)
//   <9 camera params>                (x num_cameras)
//   <3 point params>                 (x num_points)
//
// Plain C interface, loaded with ctypes (native/bal_loader.py). A file it
// cannot read or parse gives a negative code, and the caller takes the
// NumPy parser (graphite_tpu_torch/io/bal.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

struct FileBuf {
  char *data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
  bool read(const char *path) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n < 0) {
      std::fclose(f);
      return false;
    }
    data = static_cast<char *>(std::malloc(static_cast<size_t>(n) + 1));
    if (!data) {
      std::fclose(f);
      return false;
    }
    size = std::fread(data, 1, static_cast<size_t>(n), f);
    data[size] = '\0';
    std::fclose(f);
    return true;
  }
};

inline double next_double(const char *&p, bool *ok) {
  char *end = nullptr;
  double v = std::strtod(p, &end);
  if (end == p) {
    *ok = false;
    return 0.0;
  }
  p = end;
  return v;
}

inline long next_long(const char *&p, bool *ok) {
  char *end = nullptr;
  long v = std::strtol(p, &end, 10);
  if (end == p) {
    *ok = false;
    return 0;
  }
  p = end;
  return v;
}

}  // namespace

extern "C" {

// The three counts of the header. Returns 0, or -1 (no file) / -2 (no
// header).
int bal_header(const char *path, int64_t *n_cam, int64_t *n_pt,
               int64_t *n_obs) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  long c, p, o;
  int got = std::fscanf(f, "%ld %ld %ld", &c, &p, &o);
  std::fclose(f);
  if (got != 3) return -2;
  *n_cam = c;
  *n_pt = p;
  *n_obs = o;
  return 0;
}

// The whole file into arrays sized by bal_header's counts. Returns 0, or
// -1 (no file), -2 (header), -3 (an observation), -4 (a camera), -5 (a
// point).
int bal_parse(const char *path, int64_t n_cam, int64_t n_pt, int64_t n_obs,
              int32_t *cam_idx, int32_t *pt_idx, double *obs, double *cams,
              double *pts) {
  FileBuf buf;
  if (!buf.read(path)) return -1;
  const char *p = buf.data;
  bool ok = true;
  next_long(p, &ok);
  next_long(p, &ok);
  next_long(p, &ok);
  if (!ok) return -2;
  for (int64_t i = 0; i < n_obs; ++i) {
    cam_idx[i] = static_cast<int32_t>(next_long(p, &ok));
    pt_idx[i] = static_cast<int32_t>(next_long(p, &ok));
    obs[2 * i] = next_double(p, &ok);
    obs[2 * i + 1] = next_double(p, &ok);
    if (!ok) return -3;
  }
  for (int64_t i = 0; i < n_cam * 9; ++i) {
    cams[i] = next_double(p, &ok);
    if (!ok) return -4;
  }
  for (int64_t i = 0; i < n_pt * 3; ++i) {
    pts[i] = next_double(p, &ok);
    if (!ok) return -5;
  }
  return 0;
}

}  // extern "C"
