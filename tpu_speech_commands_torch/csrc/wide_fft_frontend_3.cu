// Route ct's wide register FFT, build unit 3 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 3 modulo
// WIDE_UNITS (n_fft 5120, 7168, 9472, 11520, 13568, 15616).  The kernel,
// its contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)          \
  X(2560, 40, 4, 8, 8, 8, 5)       \
  X(3584, 56, 3, 8, 8, 8, 7)       \
  X(4736, 37, 4, 16, 8, 37)        \
  X(5760, 45, 3, 16, 8, 3, 3, 5)   \
  X(6784, 53, 3, 16, 8, 53)        \
  X(7808, 61, 2, 16, 8, 61)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_3, TSC_WIDE_PLANS)
