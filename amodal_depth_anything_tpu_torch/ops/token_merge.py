"""Token merging (ToMe) for the ViT trunks and the UNet's transformers.

Port of the JAX package's `ops/token_merge.py` (Bolya et al., "Token
Merging: Your ViT But Faster"): split the tokens alternately into sets A
(even positions, cls at 0) and B (odd), match each A token to its most
cosine-similar B token, merge the r best-matched A tokens into their B
targets (size-weighted mean), and keep the assignment so that later
features can be un-merged back to the full grid. Opt-in serving only; it
changes the result.

Parity points with the JAX functions:
  * the sort of the match scores is stable (`argsort(stable=True)`, as
    `jnp.argsort`) and `argmax` takes the first maximum, so duplicate
    tokens tie the same way; the cls row is -inf before the argmax.
  * on CUDA the group sums are `index_put_(accumulate=True)`, not
    `index_add_`: `index_add_` there sums with float atomics in an order
    that changes from run to run, so a CUDA-graph replay would not equal
    its eager call bit for bit, while the accumulating `index_put_` sorts
    the indices (a stable sort) and adds each group's members in position
    order, as the JAX scatter does. On the CPU `index_add_` adds in that
    order serially (there the accumulating `index_put_` may use atomics).
    O(N * D) work per call.

Shapes are static for a given r: the merged stream is [B, N - r, D] and the
unmerge map a [B, N] gather index, so the path captures in a CUDA graph
(no host sync, no data-dependent shape).
"""

from __future__ import annotations

import torch

__all__ = ["tome_merge", "tome_unmerge", "tome_apply"]


def _match(tokens: torch.Tensor, r: int):
    """(merged A indices [B, r], their B targets [B, Na], kept A indices
    [B, Na - r] ascending) of the bipartite soft matching."""
    metric = tokens / (torch.linalg.vector_norm(tokens, dim=-1, keepdim=True)
                       + 1e-6)
    a_m, b_m = metric[:, ::2].float(), metric[:, 1::2].float()
    scores = torch.einsum("bnd,bmd->bnm", a_m, b_m)       # [B, Na, Nb]
    scores[:, 0, :] = float("-inf")                       # protect cls
    best_val, best_idx = scores.max(dim=-1)               # first maximum
    order = torch.argsort(-best_val, dim=-1, stable=True)
    kept_a = torch.sort(order[:, r:], dim=-1).values
    return order[:, :r], best_idx, kept_a


def _unmerge_map(n: int, merged_a, best_idx, kept_a) -> torch.Tensor:
    """[B, N] int64: the merged slot each original position reads.
    Kept A token (position 2*kept_a[j]) -> slot j; merged A token ->
    slot (Na - r) + its B target; B token j (position 2j + 1) ->
    slot (Na - r) + j."""
    b, na = best_idx.shape
    n_kept = kept_a.shape[1]
    dev = best_idx.device
    amap = torch.empty((b, na), dtype=torch.int64, device=dev)
    amap.scatter_(1, kept_a, torch.arange(n_kept, device=dev).expand(b, -1))
    amap.scatter_(1, merged_a, n_kept + best_idx.gather(1, merged_a))
    bmap = n_kept + torch.arange(n // 2, device=dev).expand(b, -1)
    full = torch.empty((b, n), dtype=torch.int64, device=dev)
    full[:, 0::2] = amap
    full[:, 1::2] = bmap
    return full


def tome_merge(tokens: torch.Tensor, r: int):
    """tokens: [B, N, D] (true tokens only, cls at index 0; no padding).

    Returns (merged [B, N - r, D], unmerge_idx [B, N] int64) where
    `merged[b, unmerge_idx[b, i]]` is token i's representative: the kept A
    tokens in ascending order, then the B tokens each averaged with the A
    tokens merged into it. The cls token is never merged. Requires
    0 < r < N // 2."""
    n = tokens.shape[1]
    if not 0 < r < n // 2:
        raise ValueError(f"r={r} out of range for {n} tokens")
    merged_a, best_idx, kept_a = _match(tokens, r)
    idx = _unmerge_map(n, merged_a, best_idx, kept_a)
    return tome_apply(tokens, idx, n - r), idx


def tome_unmerge(merged: torch.Tensor, unmerge_idx: torch.Tensor
                 ) -> torch.Tensor:
    """merged: [B, M, D]; unmerge_idx: [B, N] -> [B, N, D] (each original
    position takes its representative's features)."""
    idx = unmerge_idx[..., None].expand(-1, -1, merged.shape[-1])
    return merged.gather(1, idx)


def tome_apply(tokens: torch.Tensor, unmerge_idx: torch.Tensor,
               num_merged: int) -> torch.Tensor:
    """Re-merge tokens [B, N, D] into [B, num_merged, D] group means under
    an existing assignment (ToMe-SD: one bipartite match per block, reused
    by every module in it). With the map `tome_merge(tokens, r)` returned,
    this gives that call's `merged`: kept tokens are groups of one, a B
    target averages its group."""
    b, n, d = tokens.shape
    rows = torch.arange(b, device=tokens.device)[:, None] * num_merged
    flat = (unmerge_idx + rows).reshape(-1)
    src = tokens.reshape(-1, d)
    sums = tokens.new_zeros((b * num_merged, d))
    if tokens.is_cuda:
        sums.index_put_((flat,), src, accumulate=True)
    else:
        sums.index_add_(0, flat, src)
    counts = torch.zeros(b * num_merged, dtype=torch.int32,
                         device=tokens.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))  # integer: exact
    return (sums / counts.to(tokens.dtype)[:, None]).view(b, num_merged, d)
