// The verify attention of speculative decoding: the C entry for a bf16 cache with GPT-OSS's sinks.
// The kernel, its design, the arguments and the plan are in
// spec_verify_attention.cuh.

#include "spec_verify_attention.cuh"

extern "C" int lapha_spec_verify_sink(const void* q, const void* k_cache, const void* v_cache,
                                      const void* valid_map, const int* positions,
                                      const int* pos_map, const float* sinks, int layer,
                                      int slot, int T, int window, void* out, int B, int nh,
                                      int nkv, int S, int dh, float scale, float softcap,
                                      int qtiles, int splits, int stages, void* stream) {
  return launch<false, true>(q, k_cache, v_cache, nullptr, nullptr, valid_map, positions,
                             pos_map, sinks, layer, slot, T, window, out, B, nh, nkv, S, dh,
                             scale, softcap, qtiles, splits, stages, stream);
}
