// Native batch S2 cell geometry.
//
// The port's own copy of geoestimation_tpu/geo/cpp/s2geo.cpp, so the
// PyTorch package builds and loads it without the JAX package: a C++
// implementation of the S2 subset the system needs -- cube-face projection
// with the quadratic ST<->UV transform and Hilbert-curve cell ids -- as
// flat batch functions for multi-million-point partitioning and assignment
// (create_cells / assign_classes over ~4.7M MP-16 points). It mirrors
// geoestimation_tpu_torch/geo/s2.py exactly; the tests diff the two
// (tests/test_torch_port_partitioning.py). It is host code, not a kernel.
//
// API (ctypes, see geoestimation_tpu_torch/geo/native.py): all functions
// operate on contiguous arrays, thread-parallel over elements.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxLevel = 30;
constexpr int kPosBits = 2 * kMaxLevel + 1;  // 61
constexpr uint64_t kMaxSize = 1ull << kMaxLevel;
constexpr int kLookupBits = 4;
constexpr uint32_t kSwapMask = 0x01;
constexpr uint32_t kInvertMask = 0x02;

const int kPosToIJ[4][4] = {
    {0, 1, 3, 2}, {0, 2, 3, 1}, {3, 2, 0, 1}, {3, 1, 0, 2}};
const uint32_t kPosToOrientation[4] = {kSwapMask, 0, 0,
                                       kInvertMask | kSwapMask};

uint16_t lookup_pos[1 << (2 * kLookupBits + 2)];
uint16_t lookup_ij[1 << (2 * kLookupBits + 2)];

void init_cell(int level, int i, int j, int orig_orientation,
               int orientation, int pos) {
  if (level == kLookupBits) {
    int ij = (i << kLookupBits) + j;
    lookup_pos[(ij << 2) + orig_orientation] =
        static_cast<uint16_t>((pos << 2) + orientation);
    lookup_ij[(pos << 2) + orig_orientation] =
        static_cast<uint16_t>((ij << 2) + orientation);
    return;
  }
  level++;
  i <<= 1;
  j <<= 1;
  pos <<= 2;
  const int* r = kPosToIJ[orientation];
  for (int index = 0; index < 4; ++index) {
    init_cell(level, i + (r[index] >> 1), j + (r[index] & 1),
              orig_orientation, orientation ^ kPosToOrientation[index],
              pos + index);
  }
}

struct LookupInit {
  LookupInit() {
    for (int orientation = 0; orientation < 4; ++orientation) {
      init_cell(0, 0, 0, orientation, orientation, 0);
    }
  }
} lookup_init;

inline double uv_to_st(double u) {
  return u >= 0 ? 0.5 * std::sqrt(1.0 + 3.0 * u)
                : 1.0 - 0.5 * std::sqrt(1.0 - 3.0 * u);
}

inline double st_to_uv(double s) {
  return s >= 0.5 ? (1.0 / 3.0) * (4.0 * s * s - 1.0)
                  : (1.0 / 3.0) * (1.0 - 4.0 * (1.0 - s) * (1.0 - s));
}

inline uint32_t st_to_ij(double s) {
  double v = std::floor(kMaxSize * s);
  v = std::clamp(v, 0.0, static_cast<double>(kMaxSize - 1));
  return static_cast<uint32_t>(v);
}

inline uint64_t from_face_ij(int face, uint32_t i, uint32_t j) {
  uint64_t n = static_cast<uint64_t>(face) << (kPosBits - 1);
  uint64_t bits = face & kSwapMask;
  constexpr uint32_t mask = (1 << kLookupBits) - 1;
  for (int k = 7; k >= 0; --k) {
    bits += static_cast<uint64_t>((i >> (k * kLookupBits)) & mask)
            << (kLookupBits + 2);
    bits += static_cast<uint64_t>((j >> (k * kLookupBits)) & mask) << 2;
    bits = lookup_pos[bits];
    n |= (bits >> 2) << (k * 2 * kLookupBits);
    bits &= (kSwapMask | kInvertMask);
  }
  return n * 2 + 1;
}

inline uint64_t latlng_to_cell(double lat_deg, double lng_deg) {
  const double lat = lat_deg * (M_PI / 180.0);
  const double lng = lng_deg * (M_PI / 180.0);
  const double cos_lat = std::cos(lat);
  const double x = cos_lat * std::cos(lng);
  const double y = cos_lat * std::sin(lng);
  const double z = std::sin(lat);

  const double ax = std::abs(x), ay = std::abs(y), az = std::abs(z);
  int face;
  double u, v;
  if (ax >= ay && ax >= az) {
    face = x >= 0 ? 0 : 3;
    u = x >= 0 ? y / x : z / x;
    v = x >= 0 ? z / x : y / x;
  } else if (ay >= az) {
    face = y >= 0 ? 1 : 4;
    u = y >= 0 ? -x / y : z / y;
    v = y >= 0 ? z / y : -x / y;
  } else {
    face = z >= 0 ? 2 : 5;
    u = z >= 0 ? -x / z : -y / z;
    v = z >= 0 ? -y / z : -x / z;
  }
  return from_face_ij(face, st_to_ij(uv_to_st(u)), st_to_ij(uv_to_st(v)));
}

inline void to_face_ij(uint64_t id, int* face, uint32_t* pi, uint32_t* pj) {
  *face = static_cast<int>(id >> kPosBits);
  uint64_t bits = *face & kSwapMask;
  uint32_t i = 0, j = 0;
  for (int k = 7; k >= 0; --k) {
    const int nbits = (k == 7) ? (kMaxLevel - 7 * kLookupBits) : kLookupBits;
    bits += ((id >> (k * 2 * kLookupBits + 1)) &
             ((1ull << (2 * nbits)) - 1))
            << 2;
    bits = lookup_ij[bits];
    i += static_cast<uint32_t>(bits >> (kLookupBits + 2)) << (k * kLookupBits);
    j += static_cast<uint32_t>((bits >> 2) & ((1 << kLookupBits) - 1))
         << (k * kLookupBits);
    bits &= (kSwapMask | kInvertMask);
  }
  *pi = i;
  *pj = j;
}

inline void face_uv_to_xyz(int face, double u, double v, double* x,
                           double* y, double* z) {
  switch (face) {
    case 0: *x = 1; *y = u; *z = v; break;
    case 1: *x = -u; *y = 1; *z = v; break;
    case 2: *x = -u; *y = -v; *z = 1; break;
    case 3: *x = -1; *y = -v; *z = -u; break;
    case 4: *x = v; *y = -1; *z = -u; break;
    default: *x = v; *y = u; *z = -1; break;
  }
}

void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 0) {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(n, 1)));
  if (n_threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back([=, &fn]() { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void s2_latlng_to_cell_id(const double* lat, const double* lng, int64_t n,
                          uint64_t* out, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) out[k] = latlng_to_cell(lat[k], lng[k]);
  });
}

void s2_parent_at_level(const uint64_t* ids, int64_t n, int level,
                        uint64_t* out, int n_threads) {
  const uint64_t new_lsb = 1ull << (2 * (kMaxLevel - level));
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      out[k] = (ids[k] & (~new_lsb + 1)) | new_lsb;
    }
  });
}

void s2_cell_level(const uint64_t* ids, int64_t n, int32_t* out,
                   int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      out[k] = kMaxLevel - (__builtin_ctzll(ids[k]) >> 1);
    }
  });
}

void s2_cell_id_to_latlng(const uint64_t* ids, int64_t n, double* lat,
                          double* lng, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      const uint64_t id = ids[k];
      int face;
      uint32_t i, j;
      to_face_ij(id, &face, &i, &j);
      const bool leaf = (id & 1) != 0;
      const uint64_t parity = (i ^ (id >> 2)) & 1;
      const uint64_t delta = leaf ? 1 : (parity ? 2 : 0);
      const double s =
          (2.0 * i + delta) / (2.0 * static_cast<double>(kMaxSize));
      const double t =
          (2.0 * j + delta) / (2.0 * static_cast<double>(kMaxSize));
      double x, y, z;
      face_uv_to_xyz(face, st_to_uv(s), st_to_uv(t), &x, &y, &z);
      lat[k] = std::atan2(z, std::hypot(x, y)) * (180.0 / M_PI);
      lng[k] = std::atan2(y, x) * (180.0 / M_PI);
    }
  });
}

}  // extern "C"
