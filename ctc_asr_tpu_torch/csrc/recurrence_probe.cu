// The step barrier of the persistent recurrence kernels, alone: a
// cooperative launch of the same grid shape that does nothing but `steps`
// group barriers (recurrence.cuh), and in clusters of two blocks a cluster
// barrier a step too, as the clustered K3 meets its partner once a pass.
// Its time over the step count is the floor that the barriers set under a
// step of the recurrence kernels (lstm_fwd.cu, lstm_bwd.cu, gru_fwd.cu,
// gru_bwd.cu).

#include <cuda_runtime.h>

#include "recurrence.cuh"

namespace {

namespace rc = recurrence;

struct Params {
  unsigned* sync;   // [nd, row blocks] barrier counters, zeroed
  int steps;
  int cluster;      // blocks a cluster along x
};

__global__ void __launch_bounds__(rc::THREADS, 1)
recurrence_barrier_kernel(const Params p) {
  unsigned* counter = p.sync + blockIdx.z * gridDim.y + blockIdx.y;
  const unsigned group = gridDim.x;
  for (int s = 0; s < p.steps; ++s) {
    if (p.cluster > 1) rc::cluster_sync();
    __syncthreads();
    if (threadIdx.x == 0) {
      rc::group_arrive(counter);
      rc::group_wait(counter, (unsigned)(s + 1) * group);
    }
    __syncthreads();
  }
}

}  // namespace

// `steps` barriers on a grid of (blocks along x, row blocks, nd) blocks
// in clusters of `cluster` along x, with smem_bytes of dynamic shared
// memory each, so that the blocks spread over the SMs as the real
// kernel's do. sync is [nd * row_blocks] uint32, zeroed by the caller.
// Returns cudaError_t.
extern "C" int recurrence_barrier_probe(void* sync, int unit_tiles,
                                        int row_blocks, int nd, int steps,
                                        int cluster, int smem_bytes,
                                        void* stream) {
  static bool ready[rc::MAX_DEVICES] = {};
  if (unit_tiles <= 0 || row_blocks <= 0 || nd <= 0 || steps <= 0)
    return (int)cudaSuccess;
  if (smem_bytes < 0 || cluster < 1) return (int)cudaErrorInvalidValue;
  Params p = {(unsigned*)sync, steps, cluster};
  void* args[] = {&p};
  return (int)rc::launch_persistent(
      reinterpret_cast<const void*>(&recurrence_barrier_kernel), ready,
      dim3(unit_tiles, row_blocks, nd), (size_t)smem_bytes, args,
      (cudaStream_t)stream, cluster);
}
