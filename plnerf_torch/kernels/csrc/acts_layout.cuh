// The fp32 activations a training forward keeps for its backward: one
// fp32 buffer [N, Ca], row-major, that fused_mlp_fwd.cu writes and
// fused_mlp_bwd.cu reads.  It holds the relu outputs of every product the
// forward keeps, in the forward's order: relu_0 .. relu_{L-1}, then the
// split head's feature and z_hv or the folded head's z_hv.  Each is w_p
// columns wide but the last, z_hv, which is h_p wide.
#pragma once

// Products kept: the L layers, then split: feature, z_hv; folded: z_hv.
inline int acts_kept(int L, bool split) { return L + (split ? 2 : 1); }

// First column of the k-th kept product.
inline long long acts_col(int k, int w_p) { return (long long)k * w_p; }

// Ca: the columns of the buffer.
inline long long acts_width(int L, bool split, int w_p, int h_p) {
  return acts_col(acts_kept(L, split) - 1, w_p) + h_p;
}
