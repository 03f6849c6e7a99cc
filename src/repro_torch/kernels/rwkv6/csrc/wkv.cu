// The WKV6 kernel (wkv.cuh) for bf16 r, k and v, as the served model makes
// them: the C entry point wkv_launch.
#include "wkv.cuh"

WKV_ENTRY(wkv_launch, __nv_bfloat16)
