// Pieces shared by the GEMM kernels of quant_gemm.cu and moe_gemm.cu: the
// block geometry, the 16-byte unions, and the e4m3 -> float decode. Every
// source that includes this header is rebuilt when it changes (the build
// hashes the headers with the source, ops/cuda_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BN = 128;
constexpr int NOT_SUPPORTED = 100000;

union Bytes16 {
  uint4 v;
  uint8_t b[16];
};

union Words4 {
  uint4 v;
  uint32_t u[4];
};

// two floats -> two bf16 (round to nearest even) in one word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // one cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 e4m3 bytes -> 16 floats (the card converts e4m3 natively)
__device__ __forceinline__ void decode_e4m3x16(uint4 raw, float* f) {
  Bytes16 u;
  u.v = raw;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_fp8x2_storage_t pair =
        (__nv_fp8x2_storage_t)(u.b[2 * i] | ((unsigned)u.b[2 * i + 1] << 8));
    __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
    float2 v = __half22float2(*reinterpret_cast<__half2*>(&hr));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline int aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace
