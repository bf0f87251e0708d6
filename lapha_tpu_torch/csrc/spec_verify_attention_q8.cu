// The verify attention of speculative decoding: the C entry for an int8 cache.
// The kernel, its design, the arguments and the plan are in
// spec_verify_attention.cuh.

#include "spec_verify_attention.cuh"

extern "C" int lapha_spec_verify_q8(const void* q, const void* k_cache, const void* v_cache,
                                    const float* k_scale, const float* v_scale,
                                    const void* valid_map, const int* positions,
                                    const int* pos_map, int layer, int slot, int T, int window,
                                    void* out, int B, int nh, int nkv, int S, int dh, float scale,
                                    float softcap, int qtiles, int splits, int stages,
                                    void* stream) {
  return launch<true, false>(q, k_cache, v_cache, k_scale, v_scale, valid_map, positions,
                             pos_map, nullptr, layer, slot, T, window, out, B, nh, nkv, S, dh,
                             scale, softcap, qtiles, splits, stages, stream);
}
