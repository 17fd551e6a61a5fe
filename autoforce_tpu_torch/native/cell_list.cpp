// Cell-list neighbor search (native core of autoforce_tpu_torch.neighbors).
//
// Replaces the role of ASE's C-backed NeighborList in the reference
// (theforce/descriptor/atoms.py:348-363) with a padded-output builder:
// for each atom, all periodic-image neighbors within the cutoff, written
// straight into the (n, kpad) tables the device consumes.
//
// Strategy: replicate atoms into the needed periodic images, bin the
// image cloud on a uniform grid with cell edge >= cutoff, then scan the
// 27 surrounding bins per base atom.  O(N * local density).
//
// Build: g++ -O3 -march=native -shared -fPIC cell_list.cpp -o libcelllist.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// returns the maximum neighbor count (may exceed kpad -> caller retries);
// on success fills idx (n*kpad), off (n*kpad*3), mask (n*kpad)
int cell_list_neighbors(
    const double* positions,  // (n, 3)
    int n,
    const double* cell,  // (3, 3) rows are lattice vectors
    const int* pbc,      // (3,)
    const int* reps,     // (3,) image repetitions per axis
    double cutoff,
    int kpad,
    int32_t* idx,
    int32_t* off,
    uint8_t* mask) {
  const double rc2 = cutoff * cutoff;

  // ---- build image cloud ----------------------------------------------
  const int ra = reps[0], rb = reps[1], rcn = reps[2];
  const int n_img = (2 * ra + 1) * (2 * rb + 1) * (2 * rcn + 1);
  std::vector<double> img(3ull * n_img * n);
  std::vector<int8_t> ioff(3ull * n_img);
  {
    int m = 0;
    for (int a = -ra; a <= ra; ++a)
      for (int b = -rb; b <= rb; ++b)
        for (int c = -rcn; c <= rcn; ++c, ++m) {
          ioff[3 * m] = (int8_t)a;
          ioff[3 * m + 1] = (int8_t)b;
          ioff[3 * m + 2] = (int8_t)c;
          const double sx = a * cell[0] + b * cell[3] + c * cell[6];
          const double sy = a * cell[1] + b * cell[4] + c * cell[7];
          const double sz = a * cell[2] + b * cell[5] + c * cell[8];
          double* dst = &img[3ull * m * n];
          for (int i = 0; i < n; ++i) {
            dst[3 * i] = positions[3 * i] + sx;
            dst[3 * i + 1] = positions[3 * i + 1] + sy;
            dst[3 * i + 2] = positions[3 * i + 2] + sz;
          }
        }
  }
  const long total = (long)n_img * n;

  // ---- bounding box of base atoms, expanded by cutoff ------------------
  double lo[3], hi[3];
  for (int d = 0; d < 3; ++d) {
    lo[d] = 1e300;
    hi[d] = -1e300;
  }
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      const double x = positions[3 * i + d];
      if (x < lo[d]) lo[d] = x;
      if (x > hi[d]) hi[d] = x;
    }
  for (int d = 0; d < 3; ++d) {
    lo[d] -= cutoff * 1.001;
    hi[d] += cutoff * 1.001;
  }
  int nb[3];
  for (int d = 0; d < 3; ++d) {
    nb[d] = (int)std::floor((hi[d] - lo[d]) / cutoff);
    if (nb[d] < 1) nb[d] = 1;
  }
  const double inv[3] = {nb[0] / (hi[0] - lo[0]), nb[1] / (hi[1] - lo[1]),
                         nb[2] / (hi[2] - lo[2])};
  const int ncells = nb[0] * nb[1] * nb[2];

  // ---- bin image points (counting sort); points outside the box are
  //      irrelevant (farther than cutoff from every base atom) -----------
  std::vector<int> cell_of(total, -1);
  std::vector<int> count(ncells + 1, 0);
  for (long p = 0; p < total; ++p) {
    const double* q = &img[3 * p];
    int cx = (int)((q[0] - lo[0]) * inv[0]);
    int cy = (int)((q[1] - lo[1]) * inv[1]);
    int cz = (int)((q[2] - lo[2]) * inv[2]);
    if (cx < 0 || cy < 0 || cz < 0 || cx >= nb[0] || cy >= nb[1] ||
        cz >= nb[2])
      continue;
    const int c = (cx * nb[1] + cy) * nb[2] + cz;
    cell_of[p] = c;
    ++count[c + 1];
  }
  for (int c = 0; c < ncells; ++c) count[c + 1] += count[c];
  std::vector<int> order(count[ncells]);
  {
    std::vector<int> cursor(count.begin(), count.end() - 1);
    for (long p = 0; p < total; ++p) {
      const int c = cell_of[p];
      if (c >= 0) order[cursor[c]++] = (int)p;
    }
  }

  // ---- per-atom scan of 27 bins ----------------------------------------
  int kmax = 0;
  const int zero_img = ((ra * (2 * rb + 1)) + rb) * (2 * rcn + 1) + rcn;
  for (int i = 0; i < n; ++i) {
    const double xi = positions[3 * i];
    const double yi = positions[3 * i + 1];
    const double zi = positions[3 * i + 2];
    const int cx = (int)((xi - lo[0]) * inv[0]);
    const int cy = (int)((yi - lo[1]) * inv[1]);
    const int cz = (int)((zi - lo[2]) * inv[2]);
    int k = 0;
    int32_t* idx_i = idx ? &idx[(long)i * kpad] : nullptr;
    int32_t* off_i = off ? &off[(long)i * kpad * 3] : nullptr;
    uint8_t* msk_i = mask ? &mask[(long)i * kpad] : nullptr;
    for (int dx = -1; dx <= 1; ++dx) {
      const int gx = cx + dx;
      if (gx < 0 || gx >= nb[0]) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int gy = cy + dy;
        if (gy < 0 || gy >= nb[1]) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int gz = cz + dz;
          if (gz < 0 || gz >= nb[2]) continue;
          const int c = (gx * nb[1] + gy) * nb[2] + gz;
          for (int s = count[c]; s < count[c + 1]; ++s) {
            const long p = order[s];
            const int m = (int)(p / n);
            const int j = (int)(p % n);
            if (m == zero_img && j == i) continue;  // self
            const double* q = &img[3 * p];
            const double ddx = q[0] - xi, ddy = q[1] - yi, ddz = q[2] - zi;
            const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 <= rc2) {
              if (k < kpad && idx_i) {
                idx_i[k] = j;
                off_i[3 * k] = ioff[3 * m];
                off_i[3 * k + 1] = ioff[3 * m + 1];
                off_i[3 * k + 2] = ioff[3 * m + 2];
                msk_i[k] = 1;
              }
              ++k;
            }
          }
        }
      }
    }
    if (k > kmax) kmax = k;
  }
  return kmax;
}

}  // extern "C"
