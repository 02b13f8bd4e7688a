// The head widths the flash kernels take, and the tile width each runs at.
//
// The C entry points take d a multiple of 8 from 8 to 256 (the wrappers pad
// any other d from 1 to 256 with zero columns to the next multiple of 8).
// Each kernel is compiled for a few tile widths W; a call runs at the least
// W that holds its d.  The columns d..W of every shared tile are zero-filled
// as they land (zero columns add exact zeros to every score and product) and
// are never stored, and the tensors are read and written at their own row
// stride d.  The bf16 kernels are compiled twice for each W: with d = W as
// a compile-time constant (so a head_dim equal to a tile width runs the
// same code as when the kernels took 64 and 128 alone), and with d < W
// read at run time.

#pragma once

namespace head_dims {

constexpr int kMaxHeadDim = 256;

inline bool takes(int d) { return d >= 8 && d <= kMaxHeadDim && d % 8 == 0; }

// The tile widths: 32, 64, 96, 128, 256.
inline int tile_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

}  // namespace head_dims
