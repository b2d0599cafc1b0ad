// prepared.cuh -- the descriptor of a prepared launch (PreparedPass) and
// what the C interfaces that fill it share: the factor pass's
// (fused_pass.cu: intfft_prepare_pass, and intfft_fused_chain, which
// launches every kind of descriptor) and the whole four-step's
// (fused_whole.cu: intfft_prepare_whole).  A descriptor holds the launch
// function of its kind, so the pass's interface links without the whole
// kernel (a sweep's variant library, ops/_build.py).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_pass.cuh"

namespace intfft {

// What one whole launch takes besides the two factors' PassParams: the
// cluster size (CTAs per item), the items one cluster runs in turn as a
// block, the blocks of the batch, the clusters of the launch (a persistent
// grid: cluster g runs the blocks g, g + clusters, ...) and the row pitch
// of the receive buffer in elements.  Factor 1 runs on [rows1, cols1]
// blocks: CTA c of a cluster holds the columns [c * tc1, (c + 1) * tc1),
// tc1 = cols1 / cluster; factor 2 on the turned [cols1, rows1] blocks, CTA
// c the columns [c * tc2, (c + 1) * tc2), tc2 = rows1 / cluster.  The
// block types are the kernel's (the descriptor's launch is one chain's
// instantiation).
struct WholeParams {
  int cluster, log_cluster;   // CTAs per cluster, a power of two <= 16
  int batch_block;            // consecutive items of one block
  int blocks;                 // blocks of the batch: batch / batch_block
  int clusters;               // clusters of the launch, <= blocks
  int recv_pitch;             // elements per row of the receive buffer
};

}  // namespace intfft

namespace {

using intfft::WholeParams;

// Which table pointers a launch takes (PreparedPass::tables): the stage
// tables w, the 2-D tables t2, the epilogue table e, the coarse table c.  A
// whole call (intfft_prepare_whole) takes factor 1's stage tables in the w
// slot and factor 2's in the c slot.
constexpr int kTableW = 1, kTableT2 = 2, kTableE = 4, kTableC = 8;
constexpr unsigned long long kPrepared = 0x696e74666674ULL;  // "intfft"

// A pass's launch (fused_pass_inst.cu) and a whole call's
// (fused_whole_inst.cu).
using Launch = cudaError_t (*)(const PassPtrs&, const PassParams&,
                               const SynthParams&, const EdgeParams&, size_t,
                               cudaStream_t, int*);
using WholeLaunch = cudaError_t (*)(const PassPtrs&, const PassParams&,
                                    const PassParams&, const WholeParams&,
                                    size_t, cudaStream_t, int*);

// One pass as intfft_prepare_pass resolved it, or one whole call as
// intfft_prepare_whole did: checked, its kernel chosen and granted its
// shared memory on `device`.  The host holds it as an opaque block of
// intfft_prepared_size() bytes and hands it back to intfft_fused_chain on
// every call.
struct PreparedPass {
  unsigned long long magic;  // kPrepared once filled
  int device;                // the device it was prepared and granted on
  int tables;                // the table pointers it takes (kTable*)
  size_t smem;               // dynamic shared memory per CTA
  Launch launch;             // a pass: its launch; null for a whole call
  PassParams p;              // a pass, or a whole call's factor 1
  SynthParams syn;
  EdgeParams edge;           // a pass: the convolution's edge it takes
  WholeLaunch whole;         // a whole call: its launch; null for a pass
  PassParams p2;             // a whole call's factor 2
  WholeParams w;
};

// Makes `device` the calling thread's current device unless it is already.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// The most dynamic shared memory one CTA may take on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232 448 bytes on an H100),
// read once per device; 0 where it cannot be read.
inline int smem_optin(int device) {
  static int optin[kMaxDevices] = {};
  if (optin[device] == 0 &&
      cudaDeviceGetAttribute(&optin[device],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    optin[device] = 0;
  }
  return optin[device];
}

}  // namespace
