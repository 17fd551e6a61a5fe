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
// What bounds them on an H100 (float32, the MD shapes N ~ 1000, K = 176,
// L = 4, nmax = 3, S = 1): the forward reads N K (3*4 + 4 + 1) bytes and
// writes 2 N CH 4 (3.5 MB, ~1.1 us at 3.35 TB/s) and does ~250 operations
// per occupied slot (~0.5 us at 67 TFLOP/s): bytes.  The backward reads the
// same plus the live cotangents, writes N K 3 (5.5 MB, ~1.6 us) and needs
// ~870 operations per occupied slot once the sum over n is taken before
// the angular partials (~1.8 us): operations.  This kernel redoes the
// angular work for each n (~1700 operations per slot).
//
// Design.  The TPU kernel keeps an 8-atom block of (N, K) intermediates in
// VMEM; here one thread block serves one atom, so N blocks spread over the
// 132 SMs, and nothing of size (N, K) other than the inputs and the
// gradient reaches device memory.
//   forward:  one thread per live output channel (m <= l; 2 S nf L(L+1)/2
//             of them, 80 at S = 1).  Slots are staged kTile at a time:
//             a thread per slot writes its radials into a species-expanded
//             row F[s nf + n] (zero for other species and masked slots) and
//             its L(L+1)/2 real and imaginary harmonics into a row Y, both
//             padded to an odd stride so the stores do not collide in one
//             shared-memory bank.  Each thread then sums F[its (s,n)] *
//             Y[its (l,m)] over the tile in a register: no branch, no
//             atomics.  The m > l channels are written as zero at the end.
//   backward: the atom's cotangent rows (2 CH values) are loaded into
//             shared memory once; each thread owns one slot, recomputes
//             its radial and harmonic terms with their partials in
//             registers (the loops over l, m are unrolled by the template
//             on L) and writes its 3 gradient components.
// Both are templated on the scalar type (float, double) and on L.
// Plain C interface (loaded with ctypes); each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdMaxThreads = 512;
constexpr int kMaxOut = 8;  // live output channels per thread: <= 4096 in all
constexpr int kTile = 64;   // neighbor slots staged per forward tile
constexpr int kBwdMaxThreads = 256;

__device__ __forceinline__ double coef_a(int l, int m) {
  return sqrt((4.0 * l * l - 1.0) / (double)(l * l - m * m));
}
__device__ __forceinline__ double coef_b(int l, int m) {
  return -sqrt(((l - 1.0) * (l - 1.0) - m * m) / (4.0 * (l - 1.0) * (l - 1.0) - 1.0));
}
__device__ __forceinline__ double coef_c(int l) { return sqrt(2.0 * l + 1.0); }
__device__ __forceinline__ double coef_d(int l) { return -sqrt(1.0 + 1.0 / (2.0 * l)); }

template <typename T>
__device__ __forceinline__ T ipow(T x, int e) {
  T r = T(1);
  for (int i = 0; i < e; ++i) r *= x;
  return r;
}

// Scaled slot coordinates: masked slots -> dummy at 2 rc; species outside
// [0, S) keep unit radius (their terms are dropped by the caller).
template <typename T>
__device__ __forceinline__ void slot_coords(const T* rv, bool keep, int s, int S,
                                            const T* radii, T rc, T& x, T& y,
                                            T& z, T& unit) {
  T x0 = keep ? rv[0] : T(2) * rc;
  T y0 = keep ? rv[1] : T(0);
  T z0 = keep ? rv[2] : T(0);
  unit = (s >= 0 && s < S) ? radii[s] : T(1);
  x = x0 / unit;
  y = y0 / unit;
  z = z0 / unit;
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

__host__ __device__ constexpr int fwd_f_stride(int S, int nf) { return (S * nf) | 1; }
__host__ __device__ constexpr int fwd_y_stride(int L) { return L * (L + 1) + 1; }

template <typename T, int L>
__global__ void __launch_bounds__(kFwdMaxThreads)
soap_fwd_kernel(const T* __restrict__ rvec, const int* __restrict__ sidx,
                const uint8_t* __restrict__ mask, const T* __restrict__ radii,
                T* __restrict__ cr, T* __restrict__ ci, int K, int S, int nmax,
                T rc, int cut_n) {
  constexpr int LL = L * L;
  constexpr int LM = L * (L + 1) / 2;
  constexpr int YS = fwd_y_stride(L);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nf = nmax + 1;
  const int FS = fwd_f_stride(S, nf);
  T* sF = reinterpret_cast<T*>(smem_raw);  // kTile x FS
  T* sY = sF + kTile * FS;                 // kTile x YS
  const int atom = blockIdx.x;
  const int CH = S * nf * LL;
  const int half = S * nf * LM;  // live channels of cR (and of cI)
  const int nlive = 2 * half;
  const int nj = (nlive + blockDim.x - 1) / blockDim.x;  // uniform

  // this thread's live outputs: F column, Y column, output channel
  T acc[kMaxOut];
  int fcol[kMaxOut], ycol[kMaxOut], chan[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = threadIdx.x + j * blockDim.x;
    const int imag = o >= half;
    const int r = (o < nlive) ? o - imag * half : 0;
    const int sn = r / LM, lm = r % LM;
    int l = 0;
    while ((l + 1) * (l + 2) / 2 <= lm) ++l;
    const int m = lm - l * (l + 1) / 2;
    fcol[j] = sn;
    ycol[j] = imag * LM + lm;
    chan[j] = (o < nlive) ? imag * CH + sn * LL + l * L + m : -1;
    acc[j] = T(0);
  }

  const size_t row = (size_t)atom * K;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int tk = min(kTile, K - k0);
    for (int kk = threadIdx.x; kk < tk; kk += blockDim.x) {
      const size_t k = row + k0 + kk;
      const bool keep = mask[k] != 0;
      const int s = sidx[k];
      const bool valid = keep && s >= 0 && s < S;
      T x, y, z, unit;
      slot_coords(rvec + k * 3, keep, s, S, radii, rc, x, y, z, unit);
      const T d2 = x * x + y * y + z * z;
      const T dphys = sqrt(d2) * unit;
      const T t = T(1) - dphys / rc;
      const T cut = dphys < rc ? ipow(t, cut_n) : T(0);
      const T g = valid ? cut * exp(T(-0.5) * d2) : T(0);
      T* F = sF + kk * FS;
      for (int q = 0; q < S * nf; ++q) F[q] = T(0);
      if (valid) {
        T dn = T(1);
        for (int n = 0; n < nf; ++n) {
          F[s * nf + n] = g * dn;
          dn *= d2;
        }
      }
      T P[L][L], Cm[L], Sm[L];
      harmonics<T, L>(x, y, z, d2, P, Cm, Sm);
      T* Y = sY + kk * YS;
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
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      if (j < nj) {
        const T* F = sF + fcol[j];
        const T* Y = sY + ycol[j];
        T a = acc[j];
        for (int kk = 0; kk < tk; ++kk) a += F[kk * FS] * Y[kk * YS];
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const size_t base = (size_t)atom * CH;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    if (j < nj && chan[j] >= 0) {
      const int c = chan[j];
      if (c < CH)
        cr[base + c] = acc[j];
      else
        ci[base + c - CH] = acc[j];
    }
  }
  // the m > l channels
  for (int c = threadIdx.x; c < CH; c += blockDim.x) {
    const int m = c % L, l = (c / L) % L;
    if (m > l) {
      cr[base + c] = T(0);
      ci[base + c] = T(0);
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kBwdMaxThreads)
soap_bwd_kernel(const T* __restrict__ rvec, const int* __restrict__ sidx,
                const uint8_t* __restrict__ mask, const T* __restrict__ radii,
                const T* __restrict__ crb, const T* __restrict__ cib,
                T* __restrict__ rbar, int K, int S, int nmax, T rc, int cut_n) {
  constexpr int LL = L * L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // [crb row | cib row]
  const int atom = blockIdx.x;
  const int nf = nmax + 1;
  const int CH = S * nf * LL;
  for (int i = threadIdx.x; i < CH; i += blockDim.x) {
    sB[i] = crb[(size_t)atom * CH + i];
    sB[CH + i] = cib[(size_t)atom * CH + i];
  }
  __syncthreads();

  const size_t row = (size_t)atom * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const bool keep = mask[row + k] != 0;
    const int s = sidx[row + k];
    T x, y, z, unit;
    slot_coords(rvec + (row + k) * 3, keep, s, S, radii, rc, x, y, z, unit);
    T gx = T(0), gy = T(0), gz = T(0);
    if (keep && s >= 0 && s < S) {
      const T d2 = x * x + y * y + z * z;
      const T d = sqrt(d2);
      const T dphys = d * unit;
      const T t = T(1) - dphys / rc;
      const bool inside = dphys < rc;
      const T cut = inside ? ipow(t, cut_n) : T(0);
      const T dcut = (inside && cut_n > 0)
                         ? (T(-cut_n) / rc) * ipow(t, cut_n - 1) : T(0);
      const T expf = exp(T(-0.5) * d2);
      const T g = cut * expf;
      const T inv_d = T(1) / (d > T(1e-30) ? d : T(1e-30));
      // d g / d x_a = x_a * dg_common
      const T dg_common = (dcut * unit * inv_d) * expf - cut * expf;

      T P[L][L], Cm[L], Sm[L];
      T dPx[L][L], dPy[L][L], dPz[L][L];
      harmonics<T, L>(x, y, z, d2, P, Cm, Sm);
      dPx[0][0] = dPy[0][0] = dPz[0][0] = T(0);
#pragma unroll
      for (int l = 1; l < L; ++l) {
#pragma unroll
        for (int m = 0; m < l - 1; ++m) {
          const T a = T(coef_a(l, m)), b = T(coef_b(l, m));
          dPx[l][m] = a * (z * dPx[l - 1][m] + b * (T(2) * x * P[l - 2][m] + d2 * dPx[l - 2][m]));
          dPy[l][m] = a * (z * dPy[l - 1][m] + b * (T(2) * y * P[l - 2][m] + d2 * dPy[l - 2][m]));
          dPz[l][m] = a * (P[l - 1][m] + z * dPz[l - 1][m] +
                           b * (T(2) * z * P[l - 2][m] + d2 * dPz[l - 2][m]));
        }
        const T c = T(coef_c(l)), dd = T(coef_d(l));
        dPx[l][l - 1] = c * z * dPx[l - 1][l - 1];
        dPy[l][l - 1] = c * z * dPy[l - 1][l - 1];
        dPz[l][l - 1] = c * (P[l - 1][l - 1] + z * dPz[l - 1][l - 1]);
        dPx[l][l] = dd * dPx[l - 1][l - 1];
        dPy[l][l] = dd * dPy[l - 1][l - 1];
        dPz[l][l] = dd * dPz[l - 1][l - 1];
      }

      const T* bR = sB + s * nf * LL;
      const T* bI = sB + CH + s * nf * LL;
      T dn = T(1), dnm1 = T(0);  // d^(2n), d^(2n-2)
      for (int n = 0; n < nf; ++n) {
        // f_n = g d^{2n};  d f_n / d x_a = x_a * dfn
        const T dfn = dg_common * dn + (n > 0 ? g * T(2 * n) * dnm1 : T(0));
        const T fn = g * dn;
#pragma unroll
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int m = 0; m <= l; ++m) {
            const T cb = bR[n * LL + l * L + m];
            const T ib = bI[n * LL + l * L + m];
            const T Yr = P[l][m] * Cm[m];
            const T Yi = P[l][m] * Sm[m];
            const T w = cb * (dfn * Yr) + ib * (dfn * Yi);
            gx += w * x;
            gy += w * y;
            gz += w * z;
            T dCx = T(0), dCy = T(0), dSx = T(0), dSy = T(0);
            if (m > 0) {
              dCx = T(m) * Cm[m - 1];
              dCy = -T(m) * Sm[m - 1];
              dSx = T(m) * Sm[m - 1];
              dSy = T(m) * Cm[m - 1];
            }
            const T p = P[l][m];
            gx += fn * (cb * (dPx[l][m] * Cm[m] + p * dCx) + ib * (dPx[l][m] * Sm[m] + p * dSx));
            gy += fn * (cb * (dPy[l][m] * Cm[m] + p * dCy) + ib * (dPy[l][m] * Sm[m] + p * dSy));
            gz += fn * (cb * (dPz[l][m] * Cm[m]) + ib * (dPz[l][m] * Sm[m]));
          }
        }
        dnm1 = dn;
        dn *= d2;
      }
      // scaled coords -> physical rvec: d/d rvec = (1/unit) d/dx
      gx /= unit;
      gy /= unit;
      gz /= unit;
    }
    T* out = rbar + (row + k) * 3;
    out[0] = gx;
    out[1] = gy;
    out[2] = gz;
  }
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline int fwd_threads(int S, int nf, int L) {
  const int nlive = S * nf * L * (L + 1);
  int t = round_up(nlive, 32);
  t = t < 64 ? 64 : t;
  return t > kFwdMaxThreads ? kFwdMaxThreads : t;
}

inline size_t fwd_smem(size_t esize, int S, int nf, int L) {
  return (size_t)kTile * (fwd_f_stride(S, nf) + fwd_y_stride(L)) * esize;
}

template <typename T, int L>
cudaError_t launch_fwd(const void* rvec, const int* sidx, const uint8_t* mask,
                       const void* radii, void* cr, void* ci, int N, int K,
                       int S, int nmax, double rc, int cut_n,
                       cudaStream_t stream) {
  const int nf = nmax + 1;
  soap_fwd_kernel<T, L><<<N, fwd_threads(S, nf, L), fwd_smem(sizeof(T), S, nf, L),
                          stream>>>(
      static_cast<const T*>(rvec), sidx, mask, static_cast<const T*>(radii),
      static_cast<T*>(cr), static_cast<T*>(ci), K, S, nmax, T(rc), cut_n);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_bwd(const void* rvec, const int* sidx, const uint8_t* mask,
                       const void* radii, const void* crb, const void* cib,
                       void* rbar, int N, int K, int S, int nmax, double rc,
                       int cut_n, cudaStream_t stream) {
  const size_t smem = (size_t)2 * S * (nmax + 1) * L * L * sizeof(T);
  int threads = round_up(K, 32);
  threads = threads > kBwdMaxThreads ? kBwdMaxThreads : threads;
  soap_bwd_kernel<T, L><<<N, threads, smem, stream>>>(
      static_cast<const T*>(rvec), sidx, mask, static_cast<const T*>(radii),
      static_cast<const T*>(crb), static_cast<const T*>(cib),
      static_cast<T*>(rbar), K, S, nmax, T(rc), cut_n);
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
int soap_fwd_max_outputs() { return kFwdMaxThreads * kMaxOut; }
long long soap_fwd_smem_bytes(int esize, int S, int lmax, int nmax) {
  return (long long)fwd_smem(esize, S, nmax + 1, lmax + 1);
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
