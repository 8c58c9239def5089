// The head-size switch of the flash kernels' entry points, shared by
// flash_attention.cu, flash_attention_mma.cu and flash_attention_tf32.cu:
// f(std::integral_constant<int, D>{}) for D = 64 or 128, whose result (a
// cudaError_t) is returned as an int; any other head size is refused with
// cudaErrorInvalidValue.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

template <typename F>
int dispatch_head_dim(int d, F f) {
  if (d == 64) return (int)f(std::integral_constant<int, 64>{});
  if (d == 128) return (int)f(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}
