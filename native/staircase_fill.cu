// XLA FFI binding of the staircase fill kernel (staircase_fill.cuh).
// Built by repeatresolver_tpu/ops/cuda_fill.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> staircase_fill.cu
#include <cuda_runtime.h>

#include <string>

#include "staircase_fill.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

template <int K>
cudaError_t launch(cudaStream_t stream, int n_rows, int smem,
                   const int32_t* gap, const int32_t* ins,
                   const int32_t* ns, const int8_t* own, const int32_t* gp,
                   const int32_t* c4, const int8_t* seqs,
                   const int32_t* lob, const int32_t* a_chunks,
                   const int32_t* lengths, const int32_t* ncols,
                   int n_cols, int lpad, int n_chunks, int w, int chunk,
                   int w2, int32_t* codes, int32_t* band, int32_t* fa) {
  rr::staircase_fill_kernel<K><<<n_rows, rr::kThreads, smem, stream>>>(
      gap, ins, ns, own, gp, c4, seqs, lob, a_chunks, lengths, ncols,
      n_rows, n_cols, lpad, n_chunks, w, chunk, w2, codes, band, fa);
  return cudaGetLastError();
}

ffi::Error Fill(cudaStream_t stream, ffi::Buffer<ffi::S32> gap,
                ffi::Buffer<ffi::S32> ins, ffi::Buffer<ffi::S32> ns,
                ffi::Buffer<ffi::S8> own, ffi::Buffer<ffi::S32> gp,
                ffi::Buffer<ffi::S32> c4, ffi::Buffer<ffi::S8> seqs,
                ffi::Buffer<ffi::S32> lob, ffi::Buffer<ffi::S32> a_chunks,
                ffi::Buffer<ffi::S32> lengths, ffi::Buffer<ffi::S32> ncols,
                ffi::ResultBuffer<ffi::S32> codes,
                ffi::ResultBuffer<ffi::S32> final_band,
                ffi::ResultBuffer<ffi::S32> final_a, int64_t bandwidth,
                int64_t chunk) {
  const auto gd = gap.dimensions();
  const auto sd = seqs.dimensions();
  const auto cd = codes->dimensions();
  if (gd.size() != 2 || sd.size() != 2 || cd.size() != 3)
    return ffi::Error::InvalidArgument("staircase fill: bad ranks");
  const int n_rows = static_cast<int>(gd[0]);
  const int n_cols = static_cast<int>(gd[1]);
  const int lpad = static_cast<int>(sd[1]);
  const int w2 = static_cast<int>(cd[2]);
  const int w = static_cast<int>(bandwidth);
  const int t = static_cast<int>(chunk);
  if (t <= 0 || t % 16 != 0 || lpad % t != 0 || sd[0] != n_rows ||
      cd[0] != lpad / 16 || cd[1] != n_rows ||
      a_chunks.dimensions()[1] != lpad / t ||
      gp.dimensions()[1] != n_cols + 1)
    return ffi::Error::InvalidArgument("staircase fill: bad shapes");
  const int smem = rr::smem_ints(w2, t) * static_cast<int>(sizeof(int));
  const int per_thread = (w2 + rr::kThreads - 1) / rr::kThreads;
  cudaError_t err;
#define RR_LAUNCH(K)                                                        \
  err = launch<K>(stream, n_rows, smem, gap.typed_data(), ins.typed_data(), \
                  ns.typed_data(), own.typed_data(), gp.typed_data(),       \
                  c4.typed_data(), seqs.typed_data(), lob.typed_data(),     \
                  a_chunks.typed_data(), lengths.typed_data(),              \
                  ncols.typed_data(), n_cols, lpad, lpad / t, w, t, w2,     \
                  codes->typed_data(), final_band->typed_data(),            \
                  final_a->typed_data())
  if (per_thread <= 1) RR_LAUNCH(1);
  else if (per_thread <= 2) RR_LAUNCH(2);
  else if (per_thread <= 4) RR_LAUNCH(4);
  else if (per_thread <= 8) RR_LAUNCH(8);
  else if (per_thread <= 12) RR_LAUNCH(12);
  else if (per_thread <= 16) RR_LAUNCH(16);
  else if (per_thread <= 20) RR_LAUNCH(20);
  else return ffi::Error::InvalidArgument("staircase fill: band too wide");
#undef RR_LAUNCH
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("staircase fill launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RrStaircaseFill, Fill,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // gap
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ins
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ns
                                  .Arg<ffi::Buffer<ffi::S8>>()   // own
                                  .Arg<ffi::Buffer<ffi::S32>>()  // gp
                                  .Arg<ffi::Buffer<ffi::S32>>()  // c4
                                  .Arg<ffi::Buffer<ffi::S8>>()   // seqs
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lob
                                  .Arg<ffi::Buffer<ffi::S32>>()  // a_chunks
                                  .Arg<ffi::Buffer<ffi::S32>>()  // lengths
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ncols
                                  .Ret<ffi::Buffer<ffi::S32>>()  // codes
                                  .Ret<ffi::Buffer<ffi::S32>>()  // band
                                  .Ret<ffi::Buffer<ffi::S32>>()  // final_a
                                  .Attr<int64_t>("bandwidth")
                                  .Attr<int64_t>("chunk"));
