// Batched JPEG decode onto the card with nvJPEG, for ImageRecordIter's
// native route on a CUDA device.
//
// Replaces no TPU kernel: the JAX package decodes on the host with the
// libjpeg worker team (src/io/jpeg_decode_pool.cc, bound by
// mxnet_tpu/io/native_decode.py), which this port keeps for the CPU.  A
// machine with the card but without libjpeg's headers decodes here
// instead: nvJPEG (the CUDA toolkit's decoding library) turns a batch of
// encoded buffers into interleaved RGB uint8 images in device memory, on
// the caller's stream.  The shorter-side resize, crop, mirror and the
// float conversion then run on the card as torch ops
// (mxnet_tpu_torch/io/native_decode.py, NvjpegDecodePool).
//
// What bounds it: the entropy (Huffman) decode, which nvJPEG's default
// backend runs on the host inside the batched call (on an H100 with 8
// host cores, tools/torch_data_probe.py: 101-109 ms for 128 images of
// ~420 x 420 at quality 90 on one thread, 44-53 ms on 4 workers).  So the decoder keeps one nvJPEG state per host worker and
// splits each batch into contiguous chunks, one std::thread a chunk, as
// the libjpeg team splits its batch: the handle is shared (nvJPEG allows
// that), each state belongs to one worker.  Every chunk is decoded on
// the caller's stream and every worker is joined before the call
// returns, so work queued on that stream afterwards sees the images.
// Output bytes are h * w * 3 an image.
//
// Plain C interface for ctypes: an opaque decoder (handle + states), the
// image sizes of a batch, and one batched decode into caller-allocated
// device buffers.  Every function returns 0 or an nvjpegStatus_t code.

#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  std::vector<nvjpegJpegState_t> states;   // one per host worker
};

void destroy(Decoder* d) {
  for (nvjpegJpegState_t s : d->states) nvjpegJpegStateDestroy(s);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

// Decode images [lo, hi) with one state (one worker's share).
nvjpegStatus_t decode_chunk(nvjpegHandle_t handle, nvjpegJpegState_t state,
                            const uint8_t* const* bufs, const size_t* lens,
                            int lo, int hi, uint8_t* const* outs,
                            const int32_t* widths, cudaStream_t stream) {
  const int n = hi - lo;
  nvjpegStatus_t st = nvjpegDecodeBatchedInitialize(handle, state, n, 1,
                                                    NVJPEG_OUTPUT_RGBI);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  std::vector<nvjpegImage_t> dst(n);
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
      dst[i].channel[c] = nullptr;
      dst[i].pitch[c] = 0;
    }
    dst[i].channel[0] = outs[lo + i];
    dst[i].pitch[0] = (size_t)widths[lo + i] * 3;
  }
  return nvjpegDecodeBatched(handle, state, bufs + lo, lens + lo, dst.data(),
                             stream);
}

}  // namespace

extern "C" int mx_nvjpeg_create(int n_threads, void** out) {
  *out = nullptr;
  if (n_threads < 1) n_threads = 1;
  Decoder* d = new Decoder();
  nvjpegStatus_t st = nvjpegCreateSimple(&d->handle);
  for (int t = 0; t < n_threads && st == NVJPEG_STATUS_SUCCESS; ++t) {
    nvjpegJpegState_t state = nullptr;
    st = nvjpegJpegStateCreate(d->handle, &state);
    if (st == NVJPEG_STATUS_SUCCESS) d->states.push_back(state);
  }
  if (st != NVJPEG_STATUS_SUCCESS) {
    destroy(d);
    return (int)st;
  }
  *out = d;
  return 0;
}

extern "C" void mx_nvjpeg_free(void* p) {
  if (p) destroy(static_cast<Decoder*>(p));
}

// hw[2 i], hw[2 i + 1] = height, width of image i (its first component);
// rcs[i] = nvjpegGetImageInfo's status for it.  Returns 0.
extern "C" int mx_nvjpeg_info(void* p, const uint8_t* const* bufs,
                              const size_t* lens, int n, int32_t* hw,
                              int32_t* rcs) {
  Decoder* d = static_cast<Decoder*>(p);
  if (!d || n < 0) return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  for (int i = 0; i < n; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t st = nvjpegGetImageInfo(d->handle, bufs[i], lens[i],
                                           &comps, &sub, widths, heights);
    rcs[i] = (int32_t)st;
    hw[2 * i] = heights[0];
    hw[2 * i + 1] = widths[0];
  }
  return 0;
}

// Decode n images into outs[i] (device, h_i x w_i x 3 uint8, row pitch
// w_i * 3) as interleaved RGB, on *stream*, split over the decoder's
// workers.  Returns the first failing chunk's status, else 0.
extern "C" int mx_nvjpeg_decode(void* p, const uint8_t* const* bufs,
                                const size_t* lens, int n,
                                uint8_t* const* outs, const int32_t* widths,
                                void* stream) {
  Decoder* d = static_cast<Decoder*>(p);
  if (!d || n < 1) return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int workers = (int)d->states.size() < n ? (int)d->states.size() : n;
  const int chunk = (n + workers - 1) / workers;
  std::vector<nvjpegStatus_t> rcs(workers, NVJPEG_STATUS_SUCCESS);
  std::vector<std::thread> threads;
  for (int t = 1; t < workers; ++t) {
    const int lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=, &rcs] {
      rcs[t] = decode_chunk(d->handle, d->states[t], bufs, lens, lo, hi,
                            outs, widths, st);
    });
  }
  rcs[0] = decode_chunk(d->handle, d->states[0], bufs, lens, 0,
                        chunk < n ? chunk : n, outs, widths, st);
  for (std::thread& t : threads) t.join();
  for (nvjpegStatus_t rc : rcs)
    if (rc != NVJPEG_STATUS_SUCCESS) return (int)rc;
  return 0;
}
