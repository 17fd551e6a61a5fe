// Cell-list pair search for the on-device neighbor table, hand-written for
// Hopper.
//
// Replaces no Pallas kernel: the JAX package rebuilds its table with a
// chunked brute-force minimum-image search in plain jnp
// (autoforce_tpu/neighbors_device.py, device_neighbor_table), and the port
// kept that as its plain version (neighbors_device.device_neighbor_table_
// plain).  On the card that search tests every row against every atom: at
// 62,500 atoms 3.9e9 pair tests per rebuild, each block of 512 rows
// materialising (512, N, 3) temporaries in device memory, ~1 s of device
// time per rebuild.  These kernels find the same (j, off) pairs per row
// from a cell list, with no pair temporaries in device memory.
//
//   off = -rint(f_j - f_i),  rvec = (f_j - f_i + off) @ cell,
//   pair iff |rvec|^2 <= cutoff^2 and not (j == i and off == 0),
//
// with f = positions @ inv(cell) given by the caller (possibly unwrapped),
// exactly as the plain version computes them.
//
// The grid.  G_d = floor(width_d / (cutoff (1 + kBinMargin))) bins along
// lattice vector d, width_d being the perpendicular width of the cell,
// computed on the card from the current cell (the moving cell of NPT and
// variable-cell FIRE needs no host read).  A pair within the cutoff has
// |f_j - f_i + off|_d <= cutoff / width_d, so its atoms lie in the same or
// adjacent bins of the wrapped fractional coordinates; the margin covers
// the rounding of unwrapped fractional coordinates (up to ~1000 boxes in
// float32).  The bin arrays are sized by max_bins (the candidate count,
// known from shapes): a cell that asks for more bins gets fewer, wider
// ones, which is always correct.  Each dimension visits the distinct bins
// among {-1, 0, +1} mod G_d (3 when G_d >= 3, else all G_d), so every
// candidate is tested once, whatever the cell: under the minimum-image
// gate (width >= 2 cutoff) and without it.
//
// The kernels.  cell_bin_kernel gives each candidate atom its key
// r * (nb + 1) + bin (nb = G_x G_y G_z; masked atoms take bin nb, which no
// row visits).  The caller sorts the keys stably (torch.sort), so each
// bin holds its atoms in index order and the table is deterministic.
// cell_gather_kernel copies the fractional coordinates and ids into bin
// order and finds each key's first position by binary search.
// cell_pair_kernel gives each row one warp: it walks the stencil's bins in
// a fixed order (for each z and y neighbor bin, the x bins as one or two
// contiguous ranges of the sorted arrays), 32 candidates at a time, and
// compacts the pairs into the row's slots with a warp ballot and prefix
// count.  Pairs past kpad are counted and not written; empty slots point
// at their own row with off 0 and mask 0.  Nothing is allocated here and
// nothing waits for the host.
//
// What bounds it on an H100 (62,500 Cu atoms, cutoff 7.2 A, kpad 176, 12^3
// bins of ~36 atoms): the pair kernel writes the table, 62,500 x 176 x 8
// bytes (idx, off, mask) = 88 MB, 26 us at 3.35 TB/s, and tests ~6.1e7
// candidates (27 bins x ~36) at ~20 operations each, 18 us at 67 TFLOP/s:
// bytes, narrowly.  The sorted coordinates and ids (1 MB) stay in L2, so a
// candidate costs one 16-byte L2 read for each row that visits its bin;
// the table's writes are contiguous within a row, and each row issues
// one atomic.  The pair kernel takes ~0.35 ms there (PERF.md), far from
// that bound: a warp walks its row's ~36 rounds of 32 candidates one
// after another (load, test, ballot, write), so the time is that chain's
// latency over ~7 waves of warps.  At ~35 rebuilds per 1,000 MD steps
// that is ~0.01 ms per step, so it is left simple.  The sort and the
// gather are O(N) and take a few tens of us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kBinMargin = 1e-3;
constexpr int kPairWarps = 8;  // rows (warps) per block of the pair kernel

struct Grid {
  int g[3];
  int nb;  // g[0] g[1] g[2]
};

// Bins per lattice vector of ``cell`` (rows = lattice vectors) at
// ``cutoff``, at most ``max_bins`` in all.  Every kernel computes it from
// the same inputs, so all agree without a buffer.
template <typename T>
__device__ Grid grid_of(const T* cell, double cutoff, int max_bins) {
  double a[9];
  for (int k = 0; k < 9; ++k) a[k] = (double)cell[k];
  // |a_e x a_f| for the two vectors other than d; width_d = |det| / that
  double cx[3][3];
  for (int d = 0; d < 3; ++d) {
    const double* u = a + 3 * ((d + 1) % 3);
    const double* v = a + 3 * ((d + 2) % 3);
    cx[d][0] = u[1] * v[2] - u[2] * v[1];
    cx[d][1] = u[2] * v[0] - u[0] * v[2];
    cx[d][2] = u[0] * v[1] - u[1] * v[0];
  }
  double det = fabs(a[0] * cx[0][0] + a[1] * cx[0][1] + a[2] * cx[0][2]);
  Grid G;
  for (int d = 0; d < 3; ++d) {
    double area = sqrt(cx[d][0] * cx[d][0] + cx[d][1] * cx[d][1] +
                       cx[d][2] * cx[d][2]);
    double q = det / (area * cutoff * (1.0 + kBinMargin));
    // NaN and every q < 2 give one bin; q is capped before the cast
    G.g[d] = q >= 2.0 ? (int)fmin(floor(q), (double)max_bins) : 1;
  }
  long long prod = (long long)G.g[0] * G.g[1] * G.g[2];
  if (prod > max_bins) {
    double s = cbrt((double)max_bins / (double)prod);
    for (int d = 0; d < 3; ++d) G.g[d] = max(1, (int)(G.g[d] * s));
    while ((long long)G.g[0] * G.g[1] * G.g[2] > max_bins) {
      int d = G.g[0] >= G.g[1] ? (G.g[0] >= G.g[2] ? 0 : 2)
                               : (G.g[1] >= G.g[2] ? 1 : 2);
      G.g[d] -= 1;
    }
  }
  G.nb = G.g[0] * G.g[1] * G.g[2];
  return G;
}

// Bin of one wrapped fractional coordinate (in double: exact for the
// wrap of a float32 or float64 value).
__device__ __forceinline__ int bin_coord(double f, int g) {
  double w = f - floor(f);
  if (!(w >= 0.0)) w = 0.0;  // NaN or infinite coordinates: bin 0
  int b = (int)(w * g);
  return b >= g ? g - 1 : b;
}

template <typename T>
__global__ void cell_bin_kernel(const T* __restrict__ frac,
                                const T* __restrict__ cell,
                                const double* __restrict__ cut2,
                                const uint8_t* __restrict__ amask, int R,
                                int N, int max_bins, int* __restrict__ key) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)R * N) return;
  int r = (int)(t / N);
  Grid G = grid_of(cell, sqrt(*cut2), max_bins);
  int b = G.nb;
  if (amask[t]) {
    const T* f = frac + 3 * t;
    int bx = bin_coord((double)f[0], G.g[0]);
    int by = bin_coord((double)f[1], G.g[1]);
    int bz = bin_coord((double)f[2], G.g[2]);
    b = (bz * G.g[1] + by) * G.g[0] + bx;
  }
  key[t] = r * (G.nb + 1) + b;
}

template <typename T>
__global__ void cell_gather_kernel(const T* __restrict__ frac,
                                   const T* __restrict__ cell,
                                   const double* __restrict__ cut2,
                                   const int* __restrict__ skey,
                                   const long long* __restrict__ order,
                                   int R, int N, int max_bins,
                                   T* __restrict__ sfrac,
                                   int* __restrict__ sidx,
                                   int* __restrict__ start) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long total = (long long)R * N;
  if (t < total) {
    long long o = order[t];
    sidx[t] = (int)(o % N);
    for (int k = 0; k < 3; ++k) sfrac[3 * t + k] = frac[3 * o + k];
  }
  Grid G = grid_of(cell, sqrt(*cut2), max_bins);
  long long nkeys = (long long)R * (G.nb + 1);
  if (t <= nkeys) {  // first sorted position with key >= t
    long long lo = 0, hi = total;
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (skey[mid] < t) lo = mid + 1; else hi = mid;
    }
    start[t] = (int)lo;
  }
}

// Rounded products and sums as torch computes rvec = h @ cell (one fused
// multiply-add chain per component) and (rvec * rvec).sum(-1), so that
// borderline pairs fall as in the plain version on the card.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rint_t(float x) { return rintf(x); }
__device__ __forceinline__ double rint_t(double x) { return rint(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ int8_t clamp_i8(T v) {
  return (int8_t)(v < (T)-128 ? (T)-128 : (v > (T)127 ? (T)127 : v));
}

template <typename T>
__global__ void __launch_bounds__(32 * kPairWarps)
cell_pair_kernel(const T* __restrict__ frac, const T* __restrict__ cell,
                 const double* __restrict__ cut2,
                 const int* __restrict__ row_ids,
                 const uint8_t* __restrict__ rmask,
                 const T* __restrict__ sfrac, const int* __restrict__ sidx,
                 const int* __restrict__ start, int R, int N, int n,
                 int max_bins, int kpad, int* __restrict__ idx,
                 int8_t* __restrict__ off, uint8_t* __restrict__ mask,
                 int* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;  // row
  if (w >= (long long)R * n) return;  // uniform across the warp
  const int r = (int)(w / n);
  const int t = (int)(w % n);
  const int i = row_ids ? row_ids[t] : t;
  const double c2d = *cut2;
  const T c2 = (T)c2d;
  const Grid G = grid_of(cell, sqrt(c2d), max_bins);
  T c[9];
  for (int k = 0; k < 9; ++k) c[k] = cell[k];
  int* idx_row = idx + w * kpad;
  int8_t* off_row = off + w * kpad * 3;
  uint8_t* mask_row = mask + w * kpad;
  int count = 0;
  bool over = false;
  if (rmask[w]) {
    const T* fp = frac + 3 * ((long long)r * N + i);
    const T fi0 = fp[0], fi1 = fp[1], fi2 = fp[2];
    const int bx = bin_coord((double)fi0, G.g[0]);
    const int by = bin_coord((double)fi1, G.g[1]);
    const int bz = bin_coord((double)fi2, G.g[2]);
    const int* st = start + (long long)r * (G.nb + 1);
    const int gx = G.g[0], gy = G.g[1], gz = G.g[2];
    // x bins as contiguous ranges [lo, hi) of one (y, z) row of bins
    int xlo[2], xhi[2], nx;
    if (gx <= 3) {
      xlo[0] = 0; xhi[0] = gx; nx = 1;
    } else if (bx == 0) {
      xlo[0] = gx - 1; xhi[0] = gx; xlo[1] = 0; xhi[1] = 2; nx = 2;
    } else if (bx == gx - 1) {
      xlo[0] = gx - 2; xhi[0] = gx; xlo[1] = 0; xhi[1] = 1; nx = 2;
    } else {
      xlo[0] = bx - 1; xhi[0] = bx + 2; nx = 1;
    }
    const int nz = gz < 3 ? gz : 3, ny = gy < 3 ? gy : 3;
    for (int a = 0; a < nz; ++a) {
      const int cz = gz >= 3 ? (bz + a - 1 + gz) % gz : a;
      for (int b = 0; b < ny; ++b) {
        const int cy = gy >= 3 ? (by + b - 1 + gy) % gy : b;
        const int base = (cz * gy + cy) * gx;
        for (int s = 0; s < nx; ++s) {
          const int p1 = st[base + xhi[s]];
          for (int p0 = st[base + xlo[s]]; p0 < p1; p0 += 32) {
            const int p = p0 + lane;
            bool valid = false;
            int j = 0;
            T o0 = 0, o1 = 0, o2 = 0;
            if (p < p1) {
              j = sidx[p];
              const T* fj = sfrac + 3 * (long long)p;
              const T g0 = fj[0] - fi0, g1 = fj[1] - fi1, g2 = fj[2] - fi2;
              o0 = -rint_t(g0); o1 = -rint_t(g1); o2 = -rint_t(g2);
              const T h0 = g0 + o0, h1 = g1 + o1, h2 = g2 + o2;
              const T rx = fma_rn(h2, c[6], fma_rn(h1, c[3], mul_rn(h0, c[0])));
              const T ry = fma_rn(h2, c[7], fma_rn(h1, c[4], mul_rn(h0, c[1])));
              const T rz = fma_rn(h2, c[8], fma_rn(h1, c[5], mul_rn(h0, c[2])));
              const T d2 = add_rn(add_rn(mul_rn(rx, rx), mul_rn(ry, ry)),
                                  mul_rn(rz, rz));
              const bool self = j == i && o0 == 0 && o1 == 0 && o2 == 0;
              valid = d2 <= c2 && !self;
              over |= valid && (abs_t(o0) > (T)127 || abs_t(o1) > (T)127 ||
                                abs_t(o2) > (T)127);
            }
            const unsigned bal = __ballot_sync(0xffffffffu, valid);
            const int slot = count + __popc(bal & ((1u << lane) - 1u));
            if (valid && slot < kpad) {
              idx_row[slot] = j;
              off_row[3 * slot + 0] = clamp_i8(o0);
              off_row[3 * slot + 1] = clamp_i8(o1);
              off_row[3 * slot + 2] = clamp_i8(o2);
              mask_row[slot] = 1;
            }
            count += __popc(bal);
          }
        }
      }
    }
  }
  for (int s = (count < kpad ? count : kpad) + lane; s < kpad; s += 32) {
    idx_row[s] = i;
    off_row[3 * s + 0] = 0;
    off_row[3 * s + 1] = 0;
    off_row[3 * s + 2] = 0;
    mask_row[s] = 0;
  }
  over = __any_sync(0xffffffffu, over);
  if (lane == 0) {
    if (count > 0) atomicMax(stats, count);
    if (over) atomicOr(stats + 1, 1);
  }
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

template <typename T>
int launch_bin(const void* frac, const void* cell, const double* cut2,
               const uint8_t* amask, int R, int N, int max_bins, int* key,
               cudaStream_t st) {
  cell_bin_kernel<T><<<blocks_for((long long)R * N, 256), 256, 0, st>>>(
      (const T*)frac, (const T*)cell, cut2, amask, R, N, max_bins, key);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const void* frac, const void* cell, const double* cut2,
                  const int* skey, const long long* order, int R, int N,
                  int max_bins, void* sfrac, int* sidx, int* start,
                  cudaStream_t st) {
  long long threads = (long long)R * N;
  long long keys = (long long)R * (max_bins + 1) + 1;
  if (keys > threads) threads = keys;
  cell_gather_kernel<T><<<blocks_for(threads, 256), 256, 0, st>>>(
      (const T*)frac, (const T*)cell, cut2, skey, order, R, N, max_bins,
      (T*)sfrac, sidx, start);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pairs(const void* frac, const void* cell, const double* cut2,
                 const int* row_ids, const uint8_t* rmask, const void* sfrac,
                 const int* sidx, const int* start, int R, int N, int n,
                 int max_bins, int kpad, int* idx, int8_t* off, uint8_t* mask,
                 int* stats, cudaStream_t st) {
  cell_pair_kernel<T><<<blocks_for((long long)R * n, kPairWarps),
                        32 * kPairWarps, 0, st>>>(
      (const T*)frac, (const T*)cell, cut2, row_ids, rmask, (const T*)sfrac,
      sidx, start, R, N, n, max_bins, kpad, idx, off, mask, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on the caller's stream and returns
// cudaGetLastError().  frac (R, N, 3) and cell (3, 3) are float64 when
// is_f64, else float32; cut2 is one float64 on the card.

int cell_bin(int is_f64, const void* frac, const void* cell,
             const double* cut2, const uint8_t* amask, int R, int N,
             int max_bins, int* key, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch_bin<double>(frac, cell, cut2, amask, R, N, max_bins, key, st);
  return launch_bin<float>(frac, cell, cut2, amask, R, N, max_bins, key, st);
}

int cell_gather(int is_f64, const void* frac, const void* cell,
                const double* cut2, const int* skey, const long long* order,
                int R, int N, int max_bins, void* sfrac, int* sidx,
                int* start, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch_gather<double>(frac, cell, cut2, skey, order, R, N,
                                 max_bins, sfrac, sidx, start, st);
  return launch_gather<float>(frac, cell, cut2, skey, order, R, N, max_bins,
                              sfrac, sidx, start, st);
}

int cell_pairs(int is_f64, const void* frac, const void* cell,
               const double* cut2, const int* row_ids, const uint8_t* rmask,
               const void* sfrac, const int* sidx, const int* start, int R,
               int N, int n, int max_bins, int kpad, int* idx, int8_t* off,
               uint8_t* mask, int* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch_pairs<double>(frac, cell, cut2, row_ids, rmask, sfrac, sidx,
                                start, R, N, n, max_bins, kpad, idx, off,
                                mask, stats, st);
  return launch_pairs<float>(frac, cell, cut2, row_ids, rmask, sfrac, sidx,
                             start, R, N, n, max_bins, kpad, idx, off, mask,
                             stats, st);
}

}  // extern "C"
