// Host-side helpers shared by the launchers: TMA tensor maps, and CUDA
// events a caller may have recorded between a launcher's device kernels.
//
// tensor_map_4d(map, base, dims, strides, box): the TMA tensor map of a
// 4-d bf16 tensor, 128-byte swizzled in boxes of 64 columns, zeros outside
// (TMA: strides of a multiple of 16 bytes, so D % 8 == 0, and a 16-byte
// aligned base); tensor_map and tensor_map_heads shape it for K6's and
// K7's (B, S, H, D) operands.  cuTensorMapEncodeTiled is found through the
// CUDA runtime's entry-point query: the library links no -lcuda.  Maps are kept per (pointer, shape, box) in a small cache, the
// maps of a run's shapes and buffers repeating call to call.
//
// Launch timing: vpaas_time_next_launch(events, n) hands the next launch of
// K6's, K7's or K8's launcher n CUDA events (cudaEvent_t handles, at most
// kMaxLaunchEvents).  That launcher records event i on its stream before
// its i-th device kernel and the next one after its last, so the gaps
// between consecutive events are its kernels' device times, then forgets
// them; vpaas_launch_events_recorded() says how many the last such launch
// recorded.  Nothing is recorded unless a caller asked: the launch path is
// unchanged, and a CUDA graph captures no event.
#pragma once
#include <cuda.h>   // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const int err = (int)cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const int err = (int)cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == 0 && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* base;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  bool operator==(const MapKey& o) const {
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return base == o.base;
  }
};

// the map of a 4-d bf16 tensor at base: dims innermost first (dims[0] the
// contiguous one), the byte strides of dims 1-3, boxes of `box` elements,
// 128-byte swizzled (box[0] = 64), zeros outside
inline int tensor_map_4d(CUtensorMap* map, const void* base,
                         const cuuint64_t dims[4],
                         const cuuint64_t strides[3],
                         const cuuint32_t box[4]) {
  constexpr int kCache = 64;
  static std::mutex mu;
  static MapKey keys[kCache];
  static CUtensorMap maps[kCache];
  static int used = 0, next = 0;
  MapKey key{base, {}, {}, {}};
  for (int i = 0; i < 4; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  for (int i = 0; i < 3; ++i) key.strides[i] = strides[i];
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kCache;
  used = used < kCache ? used + 1 : kCache;
  return 0;
}

// a (B, S, H, D) tensor's rows of one head: boxes of 64 columns x `rows`
// rows (K6's Q, K and V)
inline int tensor_map(CUtensorMap* map, const void* base, int D, int H,
                      int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return tensor_map_4d(map, base, dims, strides, box);
}

// a (B, S, H, D) tensor as (B, H, S, D) boxes of 64 columns x `slots`
// rows x `heads` heads: one box holds `heads` consecutive heads' rows of
// the same slots, head by head (K7's caches)
inline int tensor_map_heads(CUtensorMap* map, const void* base, int D,
                            int H, int S, int B, int slots, int heads) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D * H, 2ull * D, 2ull * D * H * S};
  const cuuint32_t box[4] = {64, (cuuint32_t)slots, (cuuint32_t)heads, 1};
  return tensor_map_4d(map, base, dims, strides, box);
}

constexpr int kMaxLaunchEvents = 8;

struct LaunchEvents {
  cudaEvent_t ev[kMaxLaunchEvents];
  int n = 0;          // handed for the next launch
  int recorded = 0;   // recorded by the last launch that had some
};

inline LaunchEvents& launch_events() {
  static LaunchEvents e;
  return e;
}

// record the i-th handed event, if there is one, on `stream`
inline int record_launch_event(int i, cudaStream_t stream) {
  LaunchEvents& e = launch_events();
  if (i >= e.n) return 0;
  e.recorded = i + 1;
  return (int)cudaEventRecord(e.ev[i], stream);
}

// the launcher is done with the handed events
inline void end_launch_events() { launch_events().n = 0; }
