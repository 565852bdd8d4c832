// The state of the graded step kernels in blocks of rows: the layout the
// mesh's all_gather makes (parallel/solver_sharded.py).
//
// A state of B scenario rows of n bodies is kept in k blocks of ni =
// ceil(n / k) rows; block r holds rows [r * ni, (r + 1) * ni) of every
// scenario row (the last block's rows past n are padding, never read).
// Body j of scenario row b is the three values from
//
//   (j / ni) * stride + (b * ni + j % ni) * 3
//
// where stride is the distance from one block to the next: B * ni * 3 for
// q alone, 2 * B * ni * 3 where each block holds its q rows and then its v
// rows, as the mesh keeps them so that one collective carries both. At
// k = 1 (ni = n) this is the one-device layout (B, n, 3).

#pragma once

namespace nbody {

struct Blocks {
    int ni;             // rows a block
    long long stride;   // elements from one block to the next

    // where body j of scenario row b starts (no division in block 0)
    __device__ __forceinline__ long long at(int b, int j) const {
        const int r = j < ni ? 0 : j / ni;
        return r * stride
               + (static_cast<long long>(b) * ni + (j - r * ni)) * 3;
    }
};

// The offsets of a rising sequence of bodies from their scenario row's
// base (b * ni * 3), without a division a body: the source loops of the
// step kernels in their blocked instantiation (source_at). Body j of
// block r lies at 3 * j + r * (stride - 3 * ni); the cursor keeps that
// shift for the block of the last body asked for and the block's end: one
// compare a body where the block does not change.
struct BlockCursor {
    long long shift;
    int end;

    __device__ __forceinline__ BlockCursor(const Blocks& L, int j) {
        const int r = j / L.ni;
        shift = r * (L.stride - 3LL * L.ni);
        end = (r + 1) * L.ni;
    }

    // the offset of body j, no lower than the last one asked for
    __device__ __forceinline__ long long at(const Blocks& L, int j) {
        while (j >= end) {
            end += L.ni;
            shift += L.stride - 3LL * L.ni;
        }
        return shift + 3LL * j;
    }
};

// The offset of source j from its scenario row's base: through the cursor
// where the state may lie in several blocks (Blocked), 3 * j where it is
// one block (one device), which the compiler then knows
template <bool Blocked>
__device__ __forceinline__ long long source_at(BlockCursor& cur,
                                               const Blocks& L, int j) {
    return Blocked ? cur.at(L, j) : 3LL * j;
}

}  // namespace nbody
