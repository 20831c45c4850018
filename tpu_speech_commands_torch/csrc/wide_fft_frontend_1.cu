// Route ct's wide register FFT, build unit 1 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 1 modulo
// WIDE_UNITS (n_fft 4608, 6656, 8960, 11008, 13056, 15104).  The kernel,
// its contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)        \
  X(2304, 36, 3, 16, 16, 3, 3)   \
  X(3328, 52, 3, 16, 16, 13)     \
  X(4480, 35, 4, 16, 8, 5, 7)    \
  X(5504, 43, 3, 16, 8, 43)      \
  X(6528, 51, 3, 16, 8, 3, 17)   \
  X(7552, 59, 2, 16, 8, 59)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_1, TSC_WIDE_PLANS)
