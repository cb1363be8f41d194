// Host-to-device copy in pieces, one piece queued at a time (host code; no
// kernel).
//
// The card serves the host-to-device copies queued on one stream before it
// turns to another stream's: a 16 MB copy issued just after a 761 MB one on
// another stream waits for all of it (chip_smoke.py phase 11b).  Expert
// paging prefetches a layer's shard (761 MB a rank at DiT-MoE-G) while the
// step runs, and the step itself waits for small host-to-device copies (a
// gloo exchange's received payloads), so a prefetch queued whole would hold
// every exchange of the layer behind it.  dice_paced_copy queues `chunk`
// bytes, waits until the card has copied them, then queues the next: the
// stream runs dry between pieces and another stream's copy waits for one
// piece at most.  It blocks the calling host thread for the whole copy; the
// pool calls it from its copy thread (ctypes releases the interpreter lock).

#include <cuda_runtime.h>

// Copies nbytes from pinned host memory `src` to device memory `dst` on
// `stream`, `chunk` bytes at a time.  Returns cudaGetLastError() or the
// first failing call's error.
extern "C" int dice_paced_copy(void* dst, const void* src, long long nbytes,
                               long long chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk <= 0) chunk = nbytes;
  cudaEvent_t done;
  err = cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long off = 0; off < nbytes && err == cudaSuccess; off += chunk) {
    const long long n = nbytes - off < chunk ? nbytes - off : chunk;
    err = cudaMemcpyAsync(static_cast<char*>(dst) + off,
                          static_cast<const char*>(src) + off, (size_t)n,
                          cudaMemcpyHostToDevice, s);
    if (err == cudaSuccess) err = cudaEventRecord(done, s);
    if (err == cudaSuccess) err = cudaEventSynchronize(done);
  }
  cudaError_t destroyed = cudaEventDestroy(done);
  if (err == cudaSuccess) err = destroyed;
  return err == cudaSuccess ? (int)cudaGetLastError() : (int)err;
}
