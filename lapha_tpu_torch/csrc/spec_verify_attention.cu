// The verify attention of speculative decoding: the C entry for a bf16 cache.
// The kernel, its design, the arguments and the plan are in
// spec_verify_attention.cuh.

#include "spec_verify_attention.cuh"

extern "C" int lapha_spec_verify(const void* q, const void* k_cache, const void* v_cache,
                                 const void* valid_map, const int* positions, const int* pos_map,
                                 int layer, int slot, int T, int window, void* out, int B, int nh,
                                 int nkv, int S, int dh, float scale, float softcap, int qtiles,
                                 int splits, int stages, void* stream) {
  return launch<false, false>(q, k_cache, v_cache, nullptr, nullptr, valid_map, positions,
                              pos_map, nullptr, layer, slot, T, window, out, B, nh, nkv, S, dh,
                              scale, softcap, qtiles, splits, stages, stream);
}

// A CTA's dynamic shared memory in bytes for head dim dh, a bf16 (int8 = 0)
// or int8 cache, `rows` query rows a CTA, S columns, `stages` ring stages
// and `splits` CTAs a row (-1: no such instance): the kernel's own count,
// by which ops/spec_verify_attention.verify_plan sizes its plan.
extern "C" int lapha_spec_verify_smem(int dh, int int8, int rows, int S, int stages, int splits) {
  return int8 ? plan_smem<true>(dh, rows, S, stages, splits)
              : plan_smem<false>(dh, rows, S, stages, splits);
}
