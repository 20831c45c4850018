// Route ct's wide register FFT, build unit 2 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 2 modulo
// WIDE_UNITS (n_fft 4864, 6912, 9216, 11264, 13312, 15360).  The kernel,
// its contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)          \
  X(2432, 38, 4, 16, 8, 19)        \
  X(3456, 54, 3, 16, 8, 3, 3, 3)   \
  X(4608, 36, 4, 8, 8, 8, 3, 3)    \
  X(5632, 44, 3, 8, 8, 8, 11)      \
  X(6656, 52, 3, 8, 8, 8, 13)      \
  X(7680, 60, 3, 8, 8, 8, 3, 5)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_2, TSC_WIDE_PLANS)
