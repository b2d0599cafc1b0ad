// fused_pass_inst.cu -- the instantiations of fused_pass_kernel
// (fused_pass.cuh) for one pair of block types, one direction and one thread
// count per CTA, with the 1-D and, on the int32 tile, the 2-D stage tables.
// The build compiles this source eight times for each thread count the
// library holds, side by side:
//   -DINTFFT_BLOCKS=i16 | i32 | i32_i64 | i64   -DINTFFT_DIR=fwd | inv
//   -DINTFFT_THREADS=128 | 256 | 512 | 1024
// and each compilation instantiates the three function templates
// launch_pass_<blocks>_<dir><threads, kMod>, grant_pass_... and
// query_pass_... that fused_pass.cu, which holds the C interface and says
// what the kernel replaces and what bounds it, calls: with the exact
// complex product (kMod false) and with the product modulo the tile's word
// (kMod true: 2^32 on the int32 tile, 2^64 on the int64 tile), for every
// pair of block types; a forward unit holds each 1-D form twice more, on
// the skewed tile (fused_pass.cuh, pass_skew); the i32 forward unit holds
// its exact 1-D form once more with the convolution's window, and the i64
// inverse unit its modular one with the cut (edge_form).

#include "fused_pass.cuh"

#if !defined(INTFFT_BLOCKS) || !defined(INTFFT_DIR) || \
    !defined(INTFFT_THREADS)
#error "compile with -DINTFFT_BLOCKS=... -DINTFFT_DIR=... -DINTFFT_THREADS=..."
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
#define INTFFT_NAME__(what, blocks, dir) what##_pass_##blocks##_##dir
#define INTFFT_NAME_(what, blocks, dir) INTFFT_NAME__(what, blocks, dir)
#define INTFFT_NAME(what) INTFFT_NAME_(what, INTFFT_BLOCKS, INTFFT_DIR)
#define INTFFT_FORM                                                          \
  INTFFT_CAT(INTFFT_TYPES_, INTFFT_BLOCKS),                                  \
      INTFFT_CAT(INTFFT_INVERSE_, INTFFT_DIR), kT, kMod

namespace intfft {

template <int kT, bool kMod>
INTFFT_LAUNCH_PASS(INTFFT_NAME(launch)) {
  return launch_tables<INTFFT_FORM>(a, p, syn, edge, smem, stream, launches);
}

template <int kT, bool kMod>
INTFFT_GRANT_PASS(INTFFT_NAME(grant)) {
  return grant_tables<INTFFT_FORM>(two_d, skew, edge, smem, device);
}

template <int kT, bool kMod>
INTFFT_QUERY_PASS(INTFFT_NAME(query)) {
  return query_tables<INTFFT_FORM>(two_d, skew, edge, smem, device, out);
}

// the template arguments of one form (a macro, so that its comma does not
// split the arguments of the macros below)
#define INTFFT_EXACT_FORM INTFFT_THREADS, false
#define INTFFT_MOD_FORM INTFFT_THREADS, true
template INTFFT_LAUNCH_PASS(INTFFT_NAME(launch)<INTFFT_EXACT_FORM>);
template INTFFT_GRANT_PASS(INTFFT_NAME(grant)<INTFFT_EXACT_FORM>);
template INTFFT_QUERY_PASS(INTFFT_NAME(query)<INTFFT_EXACT_FORM>);
template INTFFT_LAUNCH_PASS(INTFFT_NAME(launch)<INTFFT_MOD_FORM>);
template INTFFT_GRANT_PASS(INTFFT_NAME(grant)<INTFFT_MOD_FORM>);
template INTFFT_QUERY_PASS(INTFFT_NAME(query)<INTFFT_MOD_FORM>);

}  // namespace intfft
