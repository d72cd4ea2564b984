// Device-clock stamps of the step's parts (engine/spans.py drives them).
// CUDA C++ for sm_90a (H100).
//
// Replaces no TPU kernel: the JAX package's step parts are XLA ops whose
// time a profile attributes by name.  Inside a CUDA graph's replay a
// profiler sees one graph launch, and inside a conditional node's body it
// sees no kernel at all, so the port times its parts from the card:
//
// stamp_kernel, one thread, reads %globaltimer (ns), takes the next slot
// of a ring of records with atomicAdd on the ring's cursor (modulo its
// capacity) and writes {time, word}: the word's low 32 bits are the
// caller's (span id, shard, begin or end, graphed), bit 25 says
// whether the span was taken (read on the card from the optional 0-d
// bool *pred: the eager select runs both branches of a cond), and the
// high 32 bits are the step, read on the card from the 0-d int32 *step
// (-1 without one).  Nothing is read from the host, and
// the kernel may sit anywhere a kernel may: eagerly on a stream, as a
// node of a graph, or inside a conditional node's body, where an event
// record cannot.
//
// ring[0] is the cursor (stamps taken since the last reset); slot s is
// ring[1 + 2 s] (time) and ring[2 + 2 s] (word).
//
// Bound: one thread, a few words; the stamp's cost is a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned int kTaken = 1u << 25;

__global__ void stamp_kernel(unsigned long long* ring, unsigned long long cap,
                             unsigned int word, const int* step,
                             const unsigned char* pred) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long s = atomicAdd(ring, 1ull) % cap;
  const unsigned int taken = (pred == nullptr || *pred != 0) ? kTaken : 0u;
  const unsigned int st = step == nullptr ? 0xffffffffu : (unsigned int)*step;
  ring[1 + 2 * s] = t;
  ring[2 + 2 * s] = ((unsigned long long)st << 32) | word | taken;
}

}  // namespace

extern "C" {

// One stamp on `stream` (captured into its graph where it captures).
// `step` and `pred` may be null.  Returns the launch's CUDA error, 0 where
// none.
int vpic_span_stamp(void* stream, void* ring, unsigned long long cap,
                    unsigned int word, const void* step, const void* pred) {
  // the launch check below must see this launch's error only
  (void)cudaGetLastError();
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, cap, word, (const int*)step,
      (const unsigned char*)pred);
  return (int)cudaGetLastError();
}

}  // extern "C"
