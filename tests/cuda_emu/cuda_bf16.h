// CPU stand-in for <cuda_bf16.h>: the bf16 type and its conversions live in
// the stand-in cuda_runtime.h here.
#pragma once
#include <cuda_runtime.h>
