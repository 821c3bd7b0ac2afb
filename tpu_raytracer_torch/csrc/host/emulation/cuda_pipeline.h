// Host emulation of <cuda_pipeline.h>: the cp.async calls live in the
// emulated cuda_runtime.h.
#pragma once

#include "cuda_runtime.h"
