// Route ct's wide register FFT, build unit 0 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 0 modulo
// WIDE_UNITS (n_fft 4352, 6400, 8704, 10752, 12800, 14848).  The kernel,
// its contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)        \
  X(2176, 34, 4, 16, 8, 17)      \
  X(3200, 50, 3, 16, 8, 5, 5)    \
  X(4352, 34, 4, 16, 16, 17)     \
  X(5376, 42, 4, 16, 16, 3, 7)   \
  X(6400, 50, 3, 16, 16, 5, 5)   \
  X(7424, 58, 3, 16, 16, 29)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_0, TSC_WIDE_PLANS)
