// Batched Viterbi decoder for the DAB K=7 rate-1/4 code, one warp per
// codeword (the GPU counterpart of the reference's SPIRAL SSE decoder,
// viterbi.cpp:298-357).
//
// Layout: lane l keeps the path metrics of states l and l+32 in registers
// as exact int32 (soft bits are integers with |s| <= 127, so the largest
// metric, 508 * steps, stays far inside int32 and needs no
// renormalization).  New state n has predecessors n>>1 and (n>>1)|32, so
// lane l reads both metrics of lane l>>1 (for state l) and of lane
// 16+(l>>1) (for state l+32) with four shuffles per step.  The branch
// metric of register value r = n | (d<<6) is one __dp4a of the step's four
// int8 soft values against r's four +-1 expected-bit signs.
//
// The 64 decisions of a step leave as two __ballot_sync words (states 0..31
// and 32..63); lane j of a 32-step chunk keeps step j's pair and the chunk
// is written with one coalesced store.  Traceback runs in the same kernel
// from state 0, reading a chunk back per 32 steps and walking it with
// shuffles; decoded bits leave as one ballot word per chunk.
//
// Tie-breaking is that of viterbi_decode_np: strict >, a tie picks
// decision 0.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMinusInf = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;

// Four int8 expected-bit signs of register value r: byte k is +1 when
// output k (parity of r & poly_k) is 1, else -1.
__device__ __forceinline__ int sign_word(unsigned r, unsigned polys) {
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned poly = (polys >> (8 * k)) & 0x7fu;
    const unsigned bit = __popc(r & poly) & 1u;
    w |= (bit ? 0x01u : 0xffu) << (8 * k);
  }
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
viterbi_k7_kernel(const int* __restrict__ soft, unsigned* __restrict__ bits,
                  uint2* __restrict__ dec, int batch, int steps, int padded,
                  unsigned polys) {
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cw >= batch) return;  // whole warp leaves together
  soft += static_cast<size_t>(cw) * padded;
  dec += static_cast<size_t>(cw) * padded;
  bits += static_cast<size_t>(cw) * (padded / 32);

  const int sg_lo0 = sign_word(lane, polys);
  const int sg_lo1 = sign_word(lane | 64, polys);
  const int sg_hi0 = sign_word(lane + 32, polys);
  const int sg_hi1 = sign_word((lane + 32) | 64, polys);
  const int src_lo = lane >> 1;
  const int src_hi = 16 + (lane >> 1);
  int pm_lo = lane == 0 ? 0 : kMinusInf;
  int pm_hi = kMinusInf;

  for (int c = 0; c < padded; c += 32) {
    const int my_soft = soft[c + lane];
    unsigned my_lo = 0, my_hi = 0;
    const int n = min(32, steps - c);
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, my_soft, j);
      const int a0 = __shfl_sync(kFull, pm_lo, src_lo);
      const int a1 = __shfl_sync(kFull, pm_hi, src_lo);
      const int b0 = __shfl_sync(kFull, pm_lo, src_hi);
      const int b1 = __shfl_sync(kFull, pm_hi, src_hi);
      const int m0 = __dp4a(s, sg_lo0, a0);
      const int m1 = __dp4a(s, sg_lo1, a1);
      const int q0 = __dp4a(s, sg_hi0, b0);
      const int q1 = __dp4a(s, sg_hi1, b1);
      const bool d_lo = m1 > m0;
      const bool d_hi = q1 > q0;
      pm_lo = d_lo ? m1 : m0;
      pm_hi = d_hi ? q1 : q0;
      const unsigned w_lo = __ballot_sync(kFull, d_lo);
      const unsigned w_hi = __ballot_sync(kFull, d_hi);
      if (lane == j) {
        my_lo = w_lo;
        my_hi = w_hi;
      }
    }
    dec[c + lane] = make_uint2(my_lo, my_hi);
  }

  // Each lane reads back only the words it wrote itself.
  int state = 0;
  for (int c = padded - 32; c >= 0; c -= 32) {
    const uint2 my = dec[c + lane];
    unsigned my_bit = 0;
    for (int j = min(31, steps - 1 - c); j >= 0; --j) {
      const unsigned lo = __shfl_sync(kFull, my.x, j);
      const unsigned hi = __shfl_sync(kFull, my.y, j);
      if (lane == j) my_bit = state & 1;
      const unsigned word = (state & 32) ? hi : lo;
      state = (state >> 1) | (static_cast<int>((word >> (state & 31)) & 1u)
                              << 5);
    }
    const unsigned out = __ballot_sync(kFull, my_bit);
    if (lane == 0) bits[c / 32] = out;
  }
}

ffi::Error ViterbiK7(cudaStream_t stream, ffi::Buffer<ffi::S8> soft,
                     ffi::ResultBuffer<ffi::U32> bits,
                     ffi::ResultBuffer<ffi::U32> dec, int32_t steps,
                     int32_t polys) {
  const auto dims = soft.dimensions();
  if (dims.size() != 3 || dims[2] != 4) {
    return ffi::Error::InvalidArgument("soft must be int8 [batch, steps, 4]");
  }
  const int64_t batch = dims[0];
  const int64_t padded = dims[1];
  if (padded % 32 != 0 || steps < 1 || steps > padded ||
      padded - steps >= 32) {
    return ffi::Error::InvalidArgument(
        "step axis must be steps rounded up to a multiple of 32");
  }
  if (batch == 0) return ffi::Error::Success();
  const int64_t grid = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_k7_kernel<<<static_cast<unsigned>(grid), 32 * kWarpsPerBlock, 0,
                      stream>>>(
      reinterpret_cast<const int*>(soft.typed_data()), bits->typed_data(),
      reinterpret_cast<uint2*>(dec->typed_data()), static_cast<int>(batch),
      steps, static_cast<int>(padded), static_cast<unsigned>(polys));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DabjaxViterbiK7, ViterbiK7,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("steps")
                                  .Attr<int32_t>("polys"));
