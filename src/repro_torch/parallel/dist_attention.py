"""Distributed flash-decode: KV cache sharded along sequence, partial
softmax per shard, exact logsumexp combine (the long_500k serving pattern)
— the counterpart of ``repro.parallel.dist_attention``.

Each rank holds a contiguous KV slice and computes its partial with the
flash-decode kernel (K3, ``decode_attention_lse``): the normalised output
o_i and the row's logsumexp lse_i over its valid keys (-inf with none).
The exact global softmax is reconstructed with

    m  = max_i lse_i
    w_i = exp(lse_i - m)          (0 where lse_i = -inf)
    o  = sum_i o_i * w_i / sum_i w_i

— one all-reduce MAX of [B, H] scalars and one SUM of [B, H, D + 1]
(weighted outputs and weights) per step, instead of gathering a
500k-token cache.  A shard that lies wholly past ``valid_len`` has
weight 0, never NaN.  A row whose ``valid_len`` is 0 gets the JAX
function's answer, the mean of v over the whole cache (there every
shard's scores are the -1e30 fill, so the softmax is uniform): one more
SUM, of those rows' v, made only when such a row exists.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.parallel.collectives import pmax, psum


def local_valid_len(valid_len: torch.Tensor, offset: int,
                    s_local: int) -> torch.Tensor:
    """The keys of a shard starting at ``offset`` that a row may read:
    ``clamp(valid_len - offset, 0, s_local)``, int32."""
    return (valid_len.to(torch.int32) - offset).clamp(0, s_local) \
        .to(torch.int32)


def combine_partials(o, lse, valid_len, v, mesh, seq_axis: str = "data"):
    """The exact attention output ``[B, 1, H, D]`` (q's dtype) from every
    rank's partial along ``seq_axis``: ``o [B, 1, H, D]`` normalised over
    its shard, ``lse [B, H]`` float32; ``v`` this rank's shard (read only
    for rows whose ``valid_len`` is 0)."""
    b, _, h, d = o.shape
    m = pmax(lse, mesh, seq_axis)
    w = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - m))
    pack = torch.cat([(o[:, 0].float() * w[..., None]).reshape(b, h * d),
                      w], 1)
    pack = psum(pack, mesh, seq_axis)
    out = pack[:, :h * d].reshape(b, h, d) \
        / pack[:, h * d:].clamp_min(1e-30)[..., None]
    zero = valid_len.to(o.device) <= 0
    if bool(zero.any()):      # the same on every rank: valid_len is
        hkv = v.shape[2]      # replicated
        vsum = psum(v[zero].float().sum(1), mesh, seq_axis)
        s_total = v.shape[1] * mesh.shape[seq_axis]
        out[zero] = (vsum / s_total).repeat_interleave(h // hkv, 1)
    return out[:, None].to(o.dtype)


def dist_decode_attention(q, k, v, valid_len, mesh, *,
                          seq_axis: str = "data", impl=None):
    """q ``[B, 1, H, D]`` (the same on every rank of ``seq_axis``); k, v
    this rank's ``[B, Sl, Hkv, D]`` slice of a cache sharded on dim 1
    over ``seq_axis`` (the rank at index i holds keys ``[i * Sl, (i + 1)
    * Sl)``); ``valid_len [B]`` of the whole cache.  Returns ``[B, 1, H,
    D]`` exact, on every rank.  The partial runs K3 on CUDA tensors (a
    failed build or launch raises) and its plain version on CPU ones."""
    s_local = k.shape[1]
    lvl = local_valid_len(valid_len.to(q.device), mesh.coords[seq_axis]
                          * s_local, s_local)
    o, lse = DA.decode_attention_lse(q, k, v, lvl, impl=impl)
    return combine_partials(o, lse, valid_len, v, mesh, seq_axis)
