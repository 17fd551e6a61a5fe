// SOAP expansion coefficients and their gradient, hand-written for Hopper.
//
// Replaces the two Pallas TPU kernels of autoforce_tpu/descriptor/pallas_soap.py:
//   soap_fwd_kernel  <- _fwd_kernel  (launched by _fwd)
//   soap_bwd_kernel  <- _bwd_kernel  (launched by _bwd_rule, the custom_vjp)
//
//   cR[i, (s,n,l,m)] = sum_k [sidx_k == s] f_n(d_k) Re[r^l Ylm](x_k)   (cI: Im)
//   f_n(d) = (1 - d_phys/rc)^cut_n exp(-d^2/2) d^(2n),  x = rvec / radius(s)
//
// Channel layout (s, n, l, m), CH = S (nmax+1) L L with L = lmax + 1; the
// m > l channels are written as zero.  Masked slots become an inert dummy
// at (2 rc, 0, 0) before the radius scaling, as in the TPU kernel, and a
// species index outside [0, S) keeps unit radius and adds to no channel.
//
// Live slots.  A slot adds to the coefficients, and gets a gradient, only
// if it is kept by the mask, its species lies in [0, S) and its physical
// distance is below rc: elsewhere the cutoff and its derivative are exactly
// zero.  On the MD path the table is built at rc + skin, so only ~57 % of
// the valid slots (and ~45 % of all K slots) are live.  Both kernels find
// the live slots of a block with warp ballots and a block prefix sum (the
// order stays that of the slots, so the sums are deterministic) and give
// each thread one live slot; the backward writes zeros for the others.
//
// What bounds them on an H100 (float32, the MD shapes N ~ 1000, K = 176,
// L = 4, nmax = 3, S = 1): the forward must read the mask byte of every
// slot and the species and coordinates (4 + 3*4 bytes) of each kept one,
// and write 2 N CH 4 bytes (2.9 MB, ~0.9 us at 3.35 TB/s); it does ~250
// operations per live slot (~0.3 us at 67 TFLOP/s): bytes.  The backward
// reads the same plus the live cotangents and writes N K 3 (4.8 MB,
// ~1.4 us) and needs ~870 operations per live slot (~1.0 us): bytes too,
// once the dead slots are skipped.  Neither reaches that bound: one atom's
// work is a chain of dependent steps (load the rows, rank the live slots,
// harmonics, contraction or gradient), each ending at a block barrier, so
// at ~1000 atoms the time is that chain's latency, and at 10k atoms the
// forward's loads, ranking and output writes alone take two thirds of its
// time (PERF.md).  The designs below shorten the chain and cut the work on
// it.
//
// Forward.  One block per atom, one thread per slot of the row (K <= 256
// takes one round of loads; a longer row is walked in chunks whose loads
// are issued before the previous chunk is computed).  Persistent blocks
// that copy the next atom's rows into a second shared stage with cp.async
// while this one is computed were measured slower at every timing shape
// (PERF.md has the times and the likely reasons).  Live slots are
// ranked by (species, slot), so each species' slots form one segment of
// the chunk; their scaled coordinates go to shared memory, then thread t
// computes the radials f_n and the L(L+1)/2 harmonics of live slot t into
// a radial row F (padded to a multiple of 4 orders) and a harmonic row Y
// (odd stride: no bank conflicts).  The contraction is register-tiled: a
// thread takes one (l, m), 4 radial orders of one species and both the
// real and the imaginary part, and sums over one of up to 16 parts of that
// species' segment only; each step is one 16-byte load of F, two loads of
// Y and 8 FMAs, the lanes of one part read the same F row, and no chain is
// longer than a few terms.  The parts are added in a fixed order
// (deterministic) into the atom's outputs in shared memory, which are
// written as whole rows at the end.  Tensor cores are not used: per atom
// the contraction is a (nf x K_s)(K_s x 2 LM) product of ~14 MFLOP in all
// at the MD shape, the float32 route to wgmma is TF32, which the package
// turns off, and the kernel is not bound by FLOP/s.
//
// Backward.  A block of 256 threads takes as few atoms as still fill the
// card in one wave (at most about 2 x 256 slots), so the 1008-atom MD
// shape is ~500 blocks.  Each thread issues the loads of both its slots
// before using either; the atoms' live cotangents (m <= l only,
// [s][lm][n][re, im]) and the live slots' scaled coordinates are staged in
// shared memory, and each thread takes one live slot.  The sum over n is
// taken first: for each (l, m) the polynomial H(d^2) = sum_n cb_n d^(2n)
// and its derivative are evaluated by Horner (4 FMAs per n), so the
// angular work is done once per (l, m), not once per (n, l, m).  The
// angular gradient comes from the degree l-1 harmonics (grad R_lm is a
// combination of R_(l-1)(m-1..m+1)), so no Legendre partials are carried:
// registers stay low and more warps stay resident.
//
// Both are templated on the scalar type (float, double) and on L.  Plain C
// interface (loaded with ctypes); each entry point launches on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdMaxThreads = 256;
constexpr int kNB = 4;        // radial orders summed together in the forward
constexpr int kMaxParts = 16;  // parts of a segment summed apart
constexpr int kBwdThreads = 256;
constexpr int kBwdSlots = 2;  // slots each backward thread loads per round
constexpr int kBwdMaxAtoms = 16;
constexpr int kSmemDefault = 48 * 1024;  // without opting in
constexpr int kSmemOptIn = 232448;       // sm_90: 227 KB per block

__device__ __forceinline__ double coef_a(int l, int m) {
  return sqrt((4.0 * l * l - 1.0) / (double)(l * l - m * m));
}
__device__ __forceinline__ double coef_b(int l, int m) {
  return -sqrt(((l - 1.0) * (l - 1.0) - m * m) / (4.0 * (l - 1.0) * (l - 1.0) - 1.0));
}
__device__ __forceinline__ double coef_c(int l) { return sqrt(2.0 * l + 1.0); }
__device__ __forceinline__ double coef_d(int l) { return -sqrt(1.0 + 1.0 / (2.0 * l)); }

// Gradient of R_lm = r^l Y_l^m (orthonormal, Condon-Shortley phase) from the
// degree l-1 harmonics, with k = sqrt((2l+1)/(2l-1)):
//   d/dz R_lm           =  k sqrt((l-m)(l+m))     R_(l-1)m
//   (d/dx + i d/dy) R_lm =  k sqrt((l-m)(l-m-1))   R_(l-1)(m+1)
//   (d/dx - i d/dy) R_lm = -k sqrt((l+m)(l+m-1))   R_(l-1)(m-1)
// with R_(l-1)(-1) = -conj R_(l-1)1.  grad_z_coef is the first factor; the
// other two carry the 1/2 of d/dx = (D+ + D-)/2, d/dy = (D+ - D-)/(2i).
__device__ __forceinline__ double grad_k(int l) {
  return sqrt((2.0 * l + 1.0) / (2.0 * l - 1.0));
}
__device__ __forceinline__ double grad_z_coef(int l, int m) {
  return grad_k(l) * sqrt((double)((l - m) * (l + m)));
}
__device__ __forceinline__ double grad_p_coef(int l, int m) {
  return 0.5 * grad_k(l) * sqrt((double)((l - m) * (l - m - 1)));
}
__device__ __forceinline__ double grad_m_coef(int l, int m) {
  return -0.5 * grad_k(l) * sqrt((double)((l + m) * (l + m - 1)));
}

template <typename T>
__device__ __forceinline__ T ipow(T x, int e) {
  T r = T(1);
  for (int i = 0; i < e; ++i) r *= x;
  return r;
}

// A slot is live when it is kept, its species is in [0, S) and its physical
// distance is below rc; then (x, y, z) are its radius-scaled coordinates.
template <typename T>
__device__ __forceinline__ bool slot_live(T x0, T y0, T z0, bool keep, int s,
                                          int S, const T* radii, T rc, T& x,
                                          T& y, T& z, T& unit) {
  if (!keep || s < 0 || s >= S) return false;
  unit = radii[s];
  x = x0 / unit;
  y = y0 / unit;
  z = z0 / unit;
  return sqrt(x * x + y * y + z * z) * unit < rc;
}

// P~[l][m] (scaled associated Legendre), C_m = Re (x+iy)^m, S_m = Im.
template <typename T, int L>
__device__ __forceinline__ void harmonics(T x, T y, T z, T d2, T (&P)[L][L],
                                          T (&Cm)[L], T (&Sm)[L]) {
  P[0][0] = T(0.28209479177387814);  // sqrt(1 / (4 pi))
#pragma unroll
  for (int l = 1; l < L; ++l) {
#pragma unroll
    for (int m = 0; m < l - 1; ++m)
      P[l][m] = T(coef_a(l, m)) * (z * P[l - 1][m] + d2 * T(coef_b(l, m)) * P[l - 2][m]);
    P[l][l - 1] = T(coef_c(l)) * z * P[l - 1][l - 1];
    P[l][l] = T(coef_d(l)) * P[l - 1][l - 1];
  }
  Cm[0] = T(1);
  Sm[0] = T(0);
#pragma unroll
  for (int m = 1; m < L; ++m) {
    Cm[m] = x * Cm[m - 1] - y * Sm[m - 1];
    Sm[m] = y * Cm[m - 1] + x * Sm[m - 1];
  }
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Ranks of this thread's NS predicates among the block's, ordered by
// (predicate index, thread), and their number; every thread of the block
// must call it.  `wcount` holds NS ints per warp.
template <int NS>
__device__ __forceinline__ int block_rank(const bool (&pred)[NS], int* wcount,
                                          int (&rank)[NS]) {
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned b[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    b[c] = __ballot_sync(0xffffffffu, pred[c]);
    if ((threadIdx.x & 31) == 0) wcount[c * nw + warp] = __popc(b[c]);
  }
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    int before = 0, tot = 0;
    for (int w = 0; w < nw; ++w) {
      const int n = wcount[c * nw + w];
      before += w < warp ? n : 0;
      tot += n;
    }
    rank[c] = base + before + __popc(b[c] & lanes_below());
    base += tot;
  }
  __syncthreads();  // wcount may be reused at once
  return base;
}

// four consecutive values of a 16-byte aligned shared row
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
// (re, im) cotangent pair of an 8- (float) or 16-byte (double) aligned row
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ double2 load2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// ---------------------------------------------------------------- forward

// Shared rows of a forward block of nt threads: F (radial orders, padded to
// a multiple of kNB), Y (2 LM harmonics, odd stride), the live slots'
// scaled coordinates, the accumulated outputs, the contraction's partial
// sums, then the ints (per-warp counts, species segments).
struct FwdLayout {
  int NB, FS, YS, nitem, NP, W;
  size_t f, y, x, acc, part, ints, bytes;
  __host__ __device__ FwdLayout(size_t esize, int nt, int S, int nf, int L) {
    NB = (nf + kNB - 1) / kNB;
    FS = kNB * NB;
    YS = L * (L + 1) + 1;
    nitem = S * NB * (L * (L + 1) / 2);  // contraction items: (s, n block, lm)
    NP = nt / nitem;                      // parts of a species segment
    NP = NP < 1 ? 1 : (NP > kMaxParts ? kMaxParts : NP);
    W = nitem * NP;
    f = 0;
    y = f + (size_t)nt * FS;
    x = y + (size_t)nt * YS;
    acc = x + (size_t)nt * 4;
    part = acc + (size_t)nitem * 2 * kNB;
    ints = (part + (size_t)W * 2 * kNB) * esize;
    bytes = ints + (size_t)(S * (nt / 32) + S + 1) * sizeof(int);
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(kFwdMaxThreads)
soap_fwd_kernel(const T* __restrict__ rvec, const int* __restrict__ sidx,
                const uint8_t* __restrict__ mask, const T* __restrict__ radii,
                T* __restrict__ cr, T* __restrict__ ci, int K, int S, int nmax,
                T rc, int cut_n) {
  constexpr int LL = L * L;
  constexpr int LM = L * (L + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int tid = threadIdx.x;
  const int nf = nmax + 1;
  const FwdLayout lay(sizeof(T), nt, S, nf, L);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* sF = sm + lay.f;
  T* sY = sm + lay.y;
  T* sX = sm + lay.x;
  T* sAcc = sm + lay.acc;    // [item][Re, Im][n % kNB]
  T* sPart = sm + lay.part;  // [part][item][Re, Im][n % kNB]
  int* wcount = reinterpret_cast<int*>(smem_raw + lay.ints);  // S x nw
  int* seg = wcount + S * nw;  // S + 1: species segments of the chunk
  const int FS = lay.FS, YS = lay.YS, NP = lay.NP;
  const int atom = blockIdx.x;
  for (int i = tid; i < lay.nitem * 2 * kNB; i += nt) sAcc[i] = T(0);

  const size_t row = (size_t)atom * K;
  // the first chunk's slot of this thread
  bool nkeep = false;
  int ns = -1;
  T nx = T(0), ny = T(0), nz = T(0);
  if (tid < K) {
    const size_t k = row + tid;
    nkeep = mask[k] != 0;
    ns = sidx[k];
    nx = rvec[3 * k];
    ny = rvec[3 * k + 1];
    nz = rvec[3 * k + 2];
  }
  for (int k0 = 0; k0 < K; k0 += nt) {
    const bool keep = nkeep;
    const int s = ns;
    const T x0 = nx, y0 = ny, z0 = nz;
    // issue the next chunk's loads before this chunk is computed
    if (k0 + nt + tid < K) {
      const size_t k = row + k0 + nt + tid;
      nkeep = mask[k] != 0;
      ns = sidx[k];
      nx = rvec[3 * k];
      ny = rvec[3 * k + 1];
      nz = rvec[3 * k + 2];
    }
    T x = T(0), y = T(0), z = T(0), unit = T(1);
    const bool live =
        k0 + tid < K && slot_live(x0, y0, z0, keep, s, S, radii, rc, x, y, z, unit);
    // rank the live slots by (species, slot): one ballot per species
    const int warp = tid >> 5;
    unsigned mine = 0;
    for (int q = 0; q < S; ++q) {
      const unsigned b = __ballot_sync(0xffffffffu, live && s == q);
      if ((tid & 31) == 0) wcount[q * nw + warp] = __popc(b);
      if (live && s == q) mine = b;
    }
    __syncthreads();
    int pos = 0, ntile = 0;
    for (int q = 0; q < S; ++q)
      for (int w = 0; w < nw; ++w) {
        const int c = wcount[q * nw + w];
        pos += (q < s || (q == s && w < warp)) ? c : 0;
        ntile += c;
      }
    for (int q0 = tid; q0 <= S; q0 += nt) {
      int a = 0;
      for (int q = 0; q < q0; ++q)
        for (int w = 0; w < nw; ++w) a += wcount[q * nw + w];
      seg[q0] = a;
    }
    if (live) {
      pos += __popc(mine & lanes_below());
      sX[4 * pos] = x;
      sX[4 * pos + 1] = y;
      sX[4 * pos + 2] = z;
      sX[4 * pos + 3] = unit;
    }
    __syncthreads();
    // radials and harmonics, one live slot per thread
    if (tid < ntile) {
      const T xs = sX[4 * tid], ys = sX[4 * tid + 1], zs = sX[4 * tid + 2];
      const T d2 = xs * xs + ys * ys + zs * zs;
      const T t = T(1) - sqrt(d2) * sX[4 * tid + 3] / rc;
      T fn = ipow(t, cut_n) * exp(T(-0.5) * d2);
      for (int nb = 0; nb < FS; nb += kNB) {
        T f4[kNB];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          f4[i] = nb + i < nf ? fn : T(0);
          fn *= d2;
        }
        store4(sF + tid * FS + nb, f4);
      }
      T P[L][L], Cm[L], Sm[L];
      harmonics<T, L>(xs, ys, zs, d2, P, Cm, Sm);
      T* Y = sY + tid * YS;
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int m = 0; m <= l; ++m) {
          Y[l * (l + 1) / 2 + m] = P[l][m] * Cm[m];
          Y[LM + l * (l + 1) / 2 + m] = P[l][m] * Sm[m];
        }
      }
    }
    __syncthreads();
    // contraction: an item is (species, block of kNB radial orders, lm),
    // summed over one of NP parts of that species' segment; the lanes of
    // one part take neighbouring items, so they read the same F row
    for (int u = tid; u < lay.W; u += nt) {
      const int item = u % lay.nitem;
      const int part = u / lay.nitem;
      const int lm = item % LM;
      const int sb = item / LM;  // s * NB + n block
      const int q = sb / lay.NB;
      const int st = seg[q], len = seg[q + 1] - st;
      const int p1 = st + len * (part + 1) / NP;
      const T* F = sF + (sb % lay.NB) * kNB;
      const T* Y = sY + lm;
      T ar[kNB] = {}, ai[kNB] = {};
#pragma unroll 2
      for (int p = st + len * part / NP; p < p1; ++p) {
        T f4[kNB];
        load4(F + p * FS, f4);
        const T yr = Y[p * YS], yi = Y[p * YS + LM];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          ar[i] += f4[i] * yr;
          ai[i] += f4[i] * yi;
        }
      }
      store4(sPart + u * 2 * kNB, ar);
      store4(sPart + u * 2 * kNB + kNB, ai);
    }
    __syncthreads();
    for (int v = tid; v < lay.nitem * 2 * kNB; v += nt) {
      T a = sAcc[v];
      for (int part = 0; part < NP; ++part) a += sPart[part * lay.nitem * 2 * kNB + v];
      sAcc[v] = a;
    }
    __syncthreads();  // the next chunk reuses the shared rows
  }

  // whole rows of cR and cI, zero in the m > l channels
  const size_t base = (size_t)atom * S * nf * LL;
  for (int c = tid; c < S * nf * LL; c += nt) {
    const int m = c % L, l = (c / L) % L, n = (c / LL) % nf, q = c / (nf * LL);
    T vr = T(0), vi = T(0);
    if (m <= l) {
      const int lm = l * (l + 1) / 2 + m;
      const int a = ((q * lay.NB + n / kNB) * LM + lm) * 2 * kNB + n % kNB;
      vr = sAcc[a];
      vi = sAcc[a + kNB];
    }
    cr[base + c] = vr;
    ci[base + c] = vi;
  }
}

// --------------------------------------------------------------- backward

// Shared rows of a backward block of A atoms: the live cotangents, then for
// each live slot its scaled coordinates and radius, its slot index and its
// species, then the per-warp counts.
struct BwdLayout {
  int BW;
  size_t coords, ints, bytes;
  __host__ __device__ BwdLayout(size_t esize, int A, int K, int S, int nf, int L) {
    BW = S * nf * L * (L + 1);  // [s][lm][n][re, im] of one atom
    coords = (size_t)A * BW;
    ints = (coords + (size_t)4 * A * K) * esize;
    bytes = ints + (size_t)(2 * A * K + kBwdSlots * (kBwdThreads / 32)) * sizeof(int);
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(kBwdThreads)
soap_bwd_kernel(const T* __restrict__ rvec, const int* __restrict__ sidx,
                const uint8_t* __restrict__ mask, const T* __restrict__ radii,
                const T* __restrict__ crb, const T* __restrict__ cib,
                T* __restrict__ rbar, int N, int K, int S, int nmax, T rc,
                int cut_n, int A) {
  constexpr int LL = L * L;
  constexpr int LM = L * (L + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int nf = nmax + 1;
  const int CH = S * nf * LL;
  const BwdLayout lay(sizeof(T), A, K, S, nf, L);
  const int BW = lay.BW;
  T* sB = reinterpret_cast<T*>(smem_raw);   // A x [s][lm][n][re, im]
  T* sC = sB + lay.coords;                  // A K x (x, y, z, radius)
  int* list = reinterpret_cast<int*>(smem_raw + lay.ints);  // A K slots
  int* lsp = list + A * K;                                  // A K species
  int* wcount = lsp + A * K;
  const int a0 = blockIdx.x * A;
  const int na = min(A, N - a0);

  for (int i = tid; i < na * BW; i += nt) {
    const int a = i / BW;
    const int r = i - a * BW;
    const int im = r & 1;
    const int n = (r >> 1) % nf;
    const int slm = (r >> 1) / nf;
    const int s = slm / LM, lm = slm % LM;
    int l = 0;
    while ((l + 1) * (l + 2) / 2 <= lm) ++l;
    const int c = (s * nf + n) * LL + l * L + (lm - l * (l + 1) / 2);
    sB[i] = (im ? cib : crb)[(size_t)(a0 + a) * CH + c];
  }

  // compact the live slots of the block's rows (all of a round's loads are
  // issued before any is used); dead slots get zeros
  const int nslots = na * K;
  const size_t first = (size_t)a0 * K;
  int nlive = 0;
  for (int j0 = 0; j0 < nslots; j0 += kBwdSlots * nt) {
    bool keep[kBwdSlots];
    int sp[kBwdSlots];
    T x0[kBwdSlots], y0[kBwdSlots], z0[kBwdSlots];
#pragma unroll
    for (int c = 0; c < kBwdSlots; ++c) {
      const int j = j0 + c * nt + tid;
      keep[c] = false;
      sp[c] = -1;
      x0[c] = y0[c] = z0[c] = T(0);
      if (j < nslots) {
        const size_t k = first + j;
        keep[c] = mask[k] != 0;
        sp[c] = sidx[k];
        x0[c] = rvec[3 * k];
        y0[c] = rvec[3 * k + 1];
        z0[c] = rvec[3 * k + 2];
      }
    }
    bool live[kBwdSlots];
    T x[kBwdSlots], y[kBwdSlots], z[kBwdSlots], unit[kBwdSlots];
#pragma unroll
    for (int c = 0; c < kBwdSlots; ++c) {
      const int j = j0 + c * nt + tid;
      live[c] = slot_live(x0[c], y0[c], z0[c], keep[c], sp[c], S, radii, rc,
                          x[c], y[c], z[c], unit[c]);
      if (!live[c] && j < nslots) {
        const size_t k = first + j;
        rbar[3 * k] = T(0);
        rbar[3 * k + 1] = T(0);
        rbar[3 * k + 2] = T(0);
      }
    }
    int rank[kBwdSlots];
    const int total = block_rank<kBwdSlots>(live, wcount, rank);
#pragma unroll
    for (int c = 0; c < kBwdSlots; ++c) {
      if (live[c]) {
        const int p = nlive + rank[c];
        list[p] = j0 + c * nt + tid;
        lsp[p] = sp[c];
        sC[4 * p] = x[c];
        sC[4 * p + 1] = y[c];
        sC[4 * p + 2] = z[c];
        sC[4 * p + 3] = unit[c];
      }
    }
    nlive += total;
  }
  __syncthreads();

  for (int p = tid; p < nlive; p += nt) {
    const int j = list[p];
    const int s = lsp[p];
    const T x = sC[4 * p], y = sC[4 * p + 1], z = sC[4 * p + 2], unit = sC[4 * p + 3];
    const T d2 = x * x + y * y + z * z;
    const T d = sqrt(d2);
    const T t = T(1) - d * unit / rc;
    const T cut = ipow(t, cut_n);
    const T dcut = cut_n > 0 ? (T(-cut_n) / rc) * ipow(t, cut_n - 1) : T(0);
    const T expf = exp(T(-0.5) * d2);
    const T g = cut * expf;
    const T inv_d = T(1) / (d > T(1e-30) ? d : T(1e-30));
    // d g / d x_a = x_a * dg_common
    const T dg_common = (dcut * unit * inv_d) * expf - cut * expf;

    T P[L][L], Cm[L], Sm[L];
    harmonics<T, L>(x, y, z, d2, P, Cm, Sm);
    const T* bS = sB + (j / K) * BW + s * LM * nf * 2;
    // radial part: sum_lm (Hr Re R + Hi Im R) and the same with H'
    T rad = T(0), radd = T(0);
    // angular part over g: sum_lm Re[(Hr - i Hi) grad R_lm]
    T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int m = 0; m <= l; ++m) {
        // H(d^2) = sum_n c_n d^(2n) and dH/d(d^2), by Horner
        const T* c = bS + (l * (l + 1) / 2 + m) * nf * 2;
        T hr = T(0), hi = T(0), hdr = T(0), hdi = T(0);
        for (int n = nf - 1; n >= 0; --n) {
          const auto cn = load2(c + 2 * n);
          hdr = hdr * d2 + hr;
          hdi = hdi * d2 + hi;
          hr = hr * d2 + cn.x;
          hi = hi * d2 + cn.y;
        }
        const T rr = P[l][m] * Cm[m], ri = P[l][m] * Sm[m];
        rad += hr * rr + hi * ri;
        radd += hdr * rr + hdi * ri;
        if (l > 0) {
          if (m < l) {  // d/dz: R_(l-1)m
            const T qr = P[l - 1][m] * Cm[m], qi = P[l - 1][m] * Sm[m];
            gz += T(grad_z_coef(l, m)) * (hr * qr + hi * qi);
          }
          if (m + 1 <= l - 1) {  // D+: R_(l-1)(m+1)
            const T qr = P[l - 1][m + 1] * Cm[m + 1], qi = P[l - 1][m + 1] * Sm[m + 1];
            const T cp = T(grad_p_coef(l, m));
            gx += cp * (hr * qr + hi * qi);
            gy += cp * (hr * qi - hi * qr);
          }
          if (m >= 1 || l >= 2) {  // D-: R_(l-1)(m-1), R_(l-1)(-1) = -conj R_(l-1)1
            T qr, qi;
            if (m >= 1) {
              qr = P[l - 1][m - 1] * Cm[m - 1];
              qi = P[l - 1][m - 1] * Sm[m - 1];
            } else {
              qr = -(P[l - 1][1] * Cm[1]);
              qi = P[l - 1][1] * Sm[1];
            }
            const T cm = T(grad_m_coef(l, m));
            gx += cm * (hr * qr + hi * qi);
            gy -= cm * (hr * qi - hi * qr);
          }
        }
      }
    }
    // d f_n / d x_a = x_a (dg_common d^(2n) + 2 n g d^(2n-2)); back to rvec
    const T w = (dg_common * rad + T(2) * g * radd) / unit;
    const T ga = g / unit;
    const size_t k = first + j;
    rbar[3 * k] = w * x + ga * gx;
    rbar[3 * k + 1] = w * y + ga * gy;
    rbar[3 * k + 2] = w * z + ga * gz;
  }
}

// ------------------------------------------------------------- launchers

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// one thread per slot of a row, as far as the shared rows fit
inline int fwd_threads(size_t esize, int S, int nf, int L, int K) {
  int nt = round_up(K < 64 ? 64 : K, 32);
  nt = nt > kFwdMaxThreads ? kFwdMaxThreads : nt;
  while (nt > 32 && FwdLayout(esize, nt, S, nf, L).bytes > (size_t)kSmemOptIn) nt -= 32;
  return nt;
}

inline size_t fwd_smem(size_t esize, int S, int nf, int L, int K) {
  return FwdLayout(esize, fwd_threads(esize, S, nf, L, K), S, nf, L).bytes;
}

// most atoms per backward block: about kBwdSlots slots per thread, within
// the default shared-memory size where one atom fits in it
inline int bwd_atoms(size_t esize, int S, int nf, int L, int K) {
  int A = K > 0 ? kBwdSlots * kBwdThreads / K : kBwdMaxAtoms;
  A = A < 1 ? 1 : (A > kBwdMaxAtoms ? kBwdMaxAtoms : A);
  while (A > 1 && BwdLayout(esize, A, K, S, nf, L).bytes > (size_t)kSmemDefault) --A;
  return A;
}

inline size_t bwd_smem(size_t esize, int S, int nf, int L, int K) {
  return BwdLayout(esize, bwd_atoms(esize, S, nf, L, K), K, S, nf, L).bytes;
}

template <typename K_>
cudaError_t allow_smem(K_ kernel, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// blocks of `kernel` the card `dev` holds at once
template <typename K_>
cudaError_t resident_blocks(K_ kernel, int dev, int threads, size_t smem, int& blocks) {
  int sms = 0, per = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  blocks = per * sms;
  return err == cudaSuccess && blocks < 1 ? cudaErrorInvalidConfiguration : err;
}

template <typename T, int L>
cudaError_t launch_fwd(const void* rvec, const int* sidx, const uint8_t* mask,
                       const void* radii, void* cr, void* ci, int N, int K,
                       int S, int nmax, double rc, int cut_n,
                       cudaStream_t stream) {
  const int nf = nmax + 1;
  const size_t smem = fwd_smem(sizeof(T), S, nf, L, K);
  cudaError_t err = allow_smem(soap_fwd_kernel<T, L>, smem);
  if (err != cudaSuccess) return err;
  soap_fwd_kernel<T, L><<<N, fwd_threads(sizeof(T), S, nf, L, K), smem, stream>>>(
      static_cast<const T*>(rvec), sidx, mask, static_cast<const T*>(radii),
      static_cast<T*>(cr), static_cast<T*>(ci), K, S, nmax, T(rc), cut_n);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_bwd(const void* rvec, const int* sidx, const uint8_t* mask,
                       const void* radii, const void* crb, const void* cib,
                       void* rbar, int N, int K, int S, int nmax, double rc,
                       int cut_n, cudaStream_t stream) {
  const int nf = nmax + 1;
  const int most = bwd_atoms(sizeof(T), S, nf, L, K);
  const size_t most_smem = BwdLayout(sizeof(T), most, K, S, nf, L).bytes;
  // the opt-in and the card's capacity are asked of the runtime once per
  // (device, shared size) in each host thread, not at every launch
  static thread_local int c_dev = -1, c_cap = 0;
  static thread_local size_t c_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != c_dev || most_smem != c_smem) {
    err = allow_smem(soap_bwd_kernel<T, L>, most_smem);
    if (err == cudaSuccess)
      err = resident_blocks(soap_bwd_kernel<T, L>, dev, kBwdThreads, most_smem, c_cap);
    if (err != cudaSuccess) {
      c_dev = -1;
      return err;
    }
    c_dev = dev;
    c_smem = most_smem;
  }
  // as few atoms per block as still fill the card in one wave
  const int cap = c_cap;
  int A = (N + cap - 1) / cap;
  A = A < 1 ? 1 : (A > most ? most : A);
  const size_t smem = BwdLayout(sizeof(T), A, K, S, nf, L).bytes;
  soap_bwd_kernel<T, L><<<(N + A - 1) / A, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(rvec), sidx, mask, static_cast<const T*>(radii),
      static_cast<const T*>(crb), static_cast<const T*>(cib),
      static_cast<T*>(rbar), N, K, S, nmax, T(rc), cut_n, A);
  return cudaGetLastError();
}

}  // namespace

#define SOAP_DISPATCH_L(FN, T, ...)                 \
  switch (lmax) {                                   \
    case 0: return (int)FN<T, 1>(__VA_ARGS__);      \
    case 1: return (int)FN<T, 2>(__VA_ARGS__);      \
    case 2: return (int)FN<T, 3>(__VA_ARGS__);      \
    case 3: return (int)FN<T, 4>(__VA_ARGS__);      \
    case 4: return (int)FN<T, 5>(__VA_ARGS__);      \
    case 5: return (int)FN<T, 6>(__VA_ARGS__);      \
    case 6: return (int)FN<T, 7>(__VA_ARGS__);      \
    case 7: return (int)FN<T, 8>(__VA_ARGS__);      \
    default: return -1;                             \
  }

extern "C" {

// Limits the wrapper checks before launching (kept here beside the code
// that relies on them).
int soap_max_lmax() { return 7; }
long long soap_smem_limit() { return kSmemOptIn; }
long long soap_fwd_smem_bytes(int esize, int S, int lmax, int nmax, int K) {
  return (long long)fwd_smem(esize, S, nmax + 1, lmax + 1, K);
}
long long soap_bwd_smem_bytes(int esize, int S, int lmax, int nmax, int K) {
  return (long long)bwd_smem(esize, S, nmax + 1, lmax + 1, K);
}

int soap_coeff_fwd(int is_f64, const void* rvec, const int* sidx,
                   const uint8_t* mask, const void* radii, void* cr, void* ci,
                   int N, int K, int S, int lmax, int nmax, double rc,
                   int cut_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    SOAP_DISPATCH_L(launch_fwd, double, rvec, sidx, mask, radii, cr, ci, N,
                    K, S, nmax, rc, cut_n, st)
  }
  SOAP_DISPATCH_L(launch_fwd, float, rvec, sidx, mask, radii, cr, ci, N, K,
                  S, nmax, rc, cut_n, st)
}

int soap_coeff_bwd(int is_f64, const void* rvec, const int* sidx,
                   const uint8_t* mask, const void* radii, const void* crb,
                   const void* cib, void* rbar, int N, int K, int S, int lmax,
                   int nmax, double rc, int cut_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    SOAP_DISPATCH_L(launch_bwd, double, rvec, sidx, mask, radii, crb, cib,
                    rbar, N, K, S, nmax, rc, cut_n, st)
  }
  SOAP_DISPATCH_L(launch_bwd, float, rvec, sidx, mask, radii, crb, cib, rbar,
                  N, K, S, nmax, rc, cut_n, st)
}

}  // extern "C"
