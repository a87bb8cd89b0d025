// Stand-in for CUDA's cooperative groups: this_grid().sync() is a barrier
// over every emulated thread of the grid (see cuda_runtime.h beside it).
#pragma once
#include <barrier>

extern std::barrier<>* emulated_grid_barrier;

namespace cooperative_groups {
struct grid_group {
  void sync() const { emulated_grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
