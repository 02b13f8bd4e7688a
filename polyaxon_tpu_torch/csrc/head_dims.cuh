// The head widths the flash kernels take, and the tile width each runs at.
//
// The C entry points take every d that is a multiple of 8 (the wrappers pad
// any other d with zero columns to the next multiple of 8).  Up to
// kMaxTileWidth, each kernel is compiled for a few tile widths W; a call
// runs at the least W that holds its d.  The columns d..W of every shared
// tile are zero-filled as they land (zero columns add exact zeros to every
// score and product) and are never stored, and the tensors are read and
// written at their own row stride d.  The bf16 kernels are compiled twice for
// each W: with d = W as a compile-time constant (so a head_dim equal to a
// tile width runs the same code as when the kernels took 64 and 128 alone),
// and with d < W read at run time.
//
// Past kMaxTileWidth (`wide`) the wide kernels split the output columns over
// a grid axis.  The bf16 forward and dk/dv kernels do so in blocks of
// kWideTileCols: up to that d a block owns every output column, holds its
// score operands whole in shared memory and sums each score once; past it
// the column blocks come back, and each streams the score operands in
// chunks of kWideChunk columns.  The float32 kernels and the bf16 dq pass
// split in blocks of kWideCols and always stream in chunks.

#pragma once

namespace head_dims {

constexpr int kMaxTileWidth = 256;
constexpr int kWideChunk = 64;      // columns of a score operand a stage carries
constexpr int kWideCols = 128;      // output columns a block owns: float32, and the bf16 dq pass
constexpr int kWideTileCols = 512;  // and a block of the bf16 forward and dk/dv kernels

// Score operand columns a stage of the bf16 forward and dk/dv kernels holds:
// the whole row up to d = kWideTileCols (kWhole), else a chunk.
template <bool kWhole>
constexpr int kWideScoreCols = kWhole ? kWideTileCols : kWideChunk;

inline bool takes(int d) { return d >= 8 && d % 8 == 0; }

inline bool wide(int d) { return d > kMaxTileWidth; }

// The output-column blocks of a wide kernel's grid, of `cols` columns each.
inline int wide_blocks(int d, int cols) { return (d + cols - 1) / cols; }

// The tile widths: 32, 64, 96, 128, 256 (d <= kMaxTileWidth).
inline int tile_width(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

}  // namespace head_dims
