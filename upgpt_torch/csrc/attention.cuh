// Shared attention routine of the port's two kernels.
//
// softmax(Q K^T * scale) V for one (batch, head) per grid column, with Q, K,
// V and O addressed through element strides, so the same routine serves
// contiguous (B, H, T, D) flash inputs and packed (B, T, C) transformer
// activations whose head h sits at column offset h * D.
// Defined in flash_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Tq, Tk, D;
  long long sqb, sqh, sqt;  // element strides of q over batch, head, token
  long long skb, skh, skt;
  long long svb, svh, svt;
  long long sob, soh, sot;
  float scale;  // applied to the float32 scores
};

// is_bf16: 1 for bfloat16 tensors, 0 for float32. Returns the launch status.
cudaError_t upgpt_attention_launch(const AttnArgs& a, int is_bf16,
                                   cudaStream_t stream);

// Dynamic shared memory one block needs for `bq` query rows.
size_t upgpt_attention_smem_bytes(int bq, int tk, int d);
