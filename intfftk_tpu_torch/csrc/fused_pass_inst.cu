// fused_pass_inst.cu -- the instantiations of fused_pass_kernel
// (fused_pass.cuh) for one pair of block types and one direction, with the
// 1-D and, on the int32 tile, the 2-D stage tables.  The build compiles this
// source eight times, side by side:
//   -DINTFFT_BLOCKS=i16 | i32 | i32_i64 | i64   -DINTFFT_DIR=fwd | inv
// and each compilation defines the one function launch_pass_<blocks>_<dir>
// that fused_pass.cu, which holds the C interface and says what the kernel
// replaces and what bounds it, calls.

#include "fused_pass.cuh"

#if !defined(INTFFT_BLOCKS) || !defined(INTFFT_DIR)
#error "compile with -DINTFFT_BLOCKS=i16|i32|i32_i64|i64 -DINTFFT_DIR=fwd|inv"
#endif

// the element types of x and y and the tile's, by block name
#define INTFFT_TYPES_i16 int16_t, int16_t, int32_t
#define INTFFT_TYPES_i32 int32_t, int32_t, int32_t
#define INTFFT_TYPES_i32_i64 int32_t, int64_t, int64_t
#define INTFFT_TYPES_i64 int64_t, int64_t, int64_t
#define INTFFT_INVERSE_fwd false
#define INTFFT_INVERSE_inv true
#define INTFFT_CAT_(a, b) a##b
#define INTFFT_CAT(a, b) INTFFT_CAT_(a, b)
#define INTFFT_NAME_(blocks, dir) launch_pass_##blocks##_##dir
#define INTFFT_NAME(blocks, dir) INTFFT_NAME_(blocks, dir)

namespace intfft {

INTFFT_LAUNCH_PASS(INTFFT_NAME(INTFFT_BLOCKS, INTFFT_DIR)) {
  return launch_tables<INTFFT_CAT(INTFFT_TYPES_, INTFFT_BLOCKS),
                       INTFFT_CAT(INTFFT_INVERSE_, INTFFT_DIR)>(
      a, p, syn, device, stream, launches);
}

}  // namespace intfft
