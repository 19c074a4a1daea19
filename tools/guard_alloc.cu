// A CUDA allocator for PyTorch (torch.cuda.memory.CUDAPluggableAllocator)
// that checks what the port's kernels do with memory, where the CUDA
// toolkit's compute-sanitizer cannot run. Built and used by
// tools/torch_sanitize.py; host code only.
//
// Every allocation is its own cudaMalloc with GUARD bytes before and
// after it, filled with GUARD_BYTE; its own bytes are filled with a
// poison byte (NESR_GUARD_POISON, 0..255, default 0xFF: NaN as float32 and
// bf16). NESR_GUARD_SHIFT (bytes, default 0) moves every pointer off the
// 256-byte alignment cudaMalloc gives, so a kernel's 16-byte paths turn
// their scalar forms on. A write past either end of an allocation lands
// in a guard, which guard_check_all (every live allocation) and the free
// (that allocation) compare against GUARD_BYTE; a read of bytes that
// nothing wrote reads the poison, which the caller sees by running twice
// with two poisons and comparing the results.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <sys/types.h>

#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t GUARD = 64 * 1024;
constexpr unsigned char GUARD_BYTE = 0xA5;

struct Block {
  char* base;
  size_t size;
  bool reported;   // found overwritten once already
};

std::mutex mu;
std::unordered_map<void*, Block> live;
long long violations = 0;
std::string first;
int poison = -1;
size_t shift = 0;

void settings() {
  if (poison >= 0) return;
  const char* p = getenv("NESR_GUARD_POISON");
  poison = p ? (int)strtol(p, nullptr, 0) & 0xFF : 0xFF;
  const char* s = getenv("NESR_GUARD_SHIFT");
  shift = s ? (size_t)strtoul(s, nullptr, 0) % 256 : 0;
}

// Whether the guard bytes around `ptr` still hold GUARD_BYTE; counts an
// allocation once and notes the first bad byte of the first one. Needs
// the device idle.
bool guards_intact(void* ptr, Block& b) {
  if (b.reported) return false;
  std::vector<unsigned char> head(GUARD + shift), tail(GUARD);
  char* end = (char*)ptr + b.size;
  if (cudaMemcpy(head.data(), b.base, head.size(), cudaMemcpyDeviceToHost)
          != cudaSuccess
      || cudaMemcpy(tail.data(), end, tail.size(), cudaMemcpyDeviceToHost)
          != cudaSuccess)
    return true;   // a device fault: the caller's sync reports it
  long bad = -1;
  for (size_t i = 0; i < head.size() && bad < 0; ++i)
    if (head[i] != GUARD_BYTE) bad = (long)i - (long)head.size();
  for (size_t i = 0; i < tail.size() && bad < 0; ++i)
    if (tail[i] != GUARD_BYTE) bad = (long)i;
  if (bad < 0) return true;
  b.reported = true;
  ++violations;
  if (first.empty()) {
    char msg[256];
    snprintf(msg, sizeof msg,
             "allocation of %zu bytes at %p: its guard byte %ld bytes %s "
             "was overwritten", b.size, ptr, bad < 0 ? -bad : bad,
             bad < 0 ? "before its start" : "after its end");
    first = msg;
  }
  return false;
}

}  // namespace

extern "C" void* guard_malloc(ssize_t size, int device, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(mu);
  settings();
  cudaSetDevice(device);
  const size_t n = (size_t)(size > 0 ? size : 0);
  const size_t total = GUARD + shift + n + GUARD;
  char* base = nullptr;
  if (cudaMalloc(&base, total) != cudaSuccess) return nullptr;
  char* ptr = base + GUARD + shift;
  cudaMemsetAsync(base, GUARD_BYTE, GUARD + shift, stream);
  if (n) cudaMemsetAsync(ptr, poison, n, stream);
  cudaMemsetAsync(ptr + n, GUARD_BYTE, GUARD, stream);
  live[ptr] = Block{base, n, false};
  return ptr;
}

extern "C" void guard_free(void* ptr, ssize_t size, int device,
                           cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(mu);
  auto it = live.find(ptr);
  if (it == live.end()) return;
  cudaSetDevice(device);
  cudaDeviceSynchronize();
  guards_intact(ptr, it->second);
  cudaFree(it->second.base);
  live.erase(it);
}

// Synchronises the device, checks every live allocation's guards, and
// returns the number of allocations found overwritten so far (frees
// included); `msg` (256 bytes) gets the first.
extern "C" long long guard_check_all(char* msg) {
  std::lock_guard<std::mutex> lock(mu);
  cudaDeviceSynchronize();
  for (auto& kv : live) guards_intact(kv.first, kv.second);
  snprintf(msg, 256, "%s", first.c_str());
  return violations;
}
