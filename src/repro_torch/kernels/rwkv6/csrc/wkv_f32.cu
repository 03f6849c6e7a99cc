// The WKV6 kernel (wkv.cuh) for f32 r, k and v (the model's f32 twin, the
// plain route's inputs): the C entry point wkv_f32_launch.
#include "wkv.cuh"

WKV_ENTRY(wkv_f32_launch, float)
