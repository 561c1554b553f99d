// Probes P1 and P2: the gather microbenchmarks of tools/profile_shapes.py.
//
// Replaces the only Pallas kernels of the repository,
// tools/profile_shapes.py:74 pgather (body gk, :68): out = xsrc[idx], a
// 1-D gather of a (121,856,) source by (4, 238, 512) int32 indices; and
// :103 pgather2 (body gk2, :98): out[r, c] = xs[r, idx[r, c]], a gather
// along the rows of an (8, 121,856) source.  On the TPU they probed whether
// a gather from a VMEM-resident source lowers (K1's neighbour gather); here
// they measure the same access pattern beside K1.
//
// Bound: device-memory bandwidth: one index read and one value written per
// output, the source read once (0.5-1 MB a row, served by L2 after the
// first touch).  Design: one thread per output, indices and outputs
// coalesced, the source read through the read-only path.
#include "common.cuh"

template <typename T>
__global__ void pgather_kernel(const int* __restrict__ idx, const T* __restrict__ xsrc,
                               T* __restrict__ out, long long n_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_out) out[i] = __ldg(xsrc + idx[i]);
}

template <typename T>
__global__ void pgather2_kernel(const int* __restrict__ idx, const T* __restrict__ xs,
                                T* __restrict__ out, long long ncols) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)blockIdx.y * ncols;
  if (c < ncols) out[row + c] = __ldg(xs + row + idx[row + c]);
}

template <typename T>
static int pgather_launch(const int* idx, const T* xsrc, T* out, int n_out, void* stream) {
  pgather_kernel<T><<<knp_blocks(n_out), KNP_THREADS, 0, (cudaStream_t)stream>>>(idx, xsrc, out,
                                                                                 n_out);
  return (int)cudaGetLastError();
}

template <typename T>
static int pgather2_launch(const int* idx, const T* xs, T* out, int rows, int ncols,
                           void* stream) {
  pgather2_kernel<T><<<dim3(knp_blocks(ncols), rows), KNP_THREADS, 0, (cudaStream_t)stream>>>(
      idx, xs, out, ncols);
  return (int)cudaGetLastError();
}

#define PROBE_ENTRIES(T, SFX)                                                                \
  extern "C" int knp_pgather_##SFX(const int* idx, const T* xsrc, T* out, int n_out,        \
                                   void* stream) {                                           \
    return pgather_launch<T>(idx, xsrc, out, n_out, stream);                                 \
  }                                                                                          \
  extern "C" int knp_pgather2_##SFX(const int* idx, const T* xs, T* out, int rows, int ncols, \
                                    void* stream) {                                          \
    return pgather2_launch<T>(idx, xs, out, rows, ncols, stream);                            \
  }

PROBE_ENTRIES(float, f32)
PROBE_ENTRIES(double, f64)
