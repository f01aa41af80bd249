// Which gated slices a block runs, shared by the kernels whose launchers
// build no compaction table (d2ft_rglru_*.cu through d2ft_rglru_common.cuh,
// d2ft_ssd_*.cu through d2ft_ssd_common.cuh).
//
// Slice s runs when its gate is not 0 and, if the launcher bounds the
// dispatch (n_disp < n slices), fewer than n_disp live slices come before
// it: the live slices among the first n_disp entries of the stable
// live-first permutation that kernels/contract.py::live_permutation builds.
// A block that holds a slice that does not run writes that slice's exact
// zeros itself, so the launchers allocate unfilled outputs.
//
// Every function here is block-uniform: all threads of the block call it
// with the same arguments and get the same answer.
#pragma once

namespace gating {

// Live gates among gate[0, s): a block-wide count.
template <int NTHREADS>
__device__ __forceinline__ int live_before(const float* __restrict__ gate,
                                           int s) {
  int before = 0;
  for (int i0 = 0; i0 < s; i0 += NTHREADS) {
    const int i = i0 + threadIdx.x;
    before += __syncthreads_count(i < s && gate[i] != 0.f);
  }
  return before;
}

// Whether slice s runs.
template <int NTHREADS>
__device__ __forceinline__ bool slice_runs(const float* __restrict__ gate,
                                           int n, int n_disp, int s) {
  if (gate[s] == 0.f) return false;
  if (n_disp >= n) return true;
  return live_before<NTHREADS>(gate, s) < n_disp;
}

// Which of the slices s0 .. s0 + cnt - 1 (cnt <= 32) run: bit j for
// slice s0 + j.
template <int NTHREADS>
__device__ __forceinline__ unsigned runs_mask(const float* __restrict__ gate,
                                              int n, int n_disp, int s0,
                                              int cnt) {
  int before = n_disp < n ? live_before<NTHREADS>(gate, s0) : 0;
  unsigned mask = 0u;
  for (int j = 0; j < cnt; ++j) {
    const bool live = gate[s0 + j] != 0.f;
    if (live && (n_disp >= n || before < n_disp)) mask |= 1u << j;
    before += live;
  }
  return mask;
}

// Whether any of the slices s0 .. s0 + cnt - 1 runs.
template <int NTHREADS>
__device__ __forceinline__ bool any_runs(const float* __restrict__ gate,
                                         int n, int n_disp, int s0,
                                         int cnt) {
  int before = n_disp < n ? live_before<NTHREADS>(gate, s0) : 0;
  for (int j = 0; j < cnt; ++j) {
    if (gate[s0 + j] != 0.f) {
      if (n_disp >= n || before < n_disp) return true;
      ++before;
    }
  }
  return false;
}

}  // namespace gating
