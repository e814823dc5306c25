"""UCT / PUCT child scoring — plain PyTorch path + CUDA kernel dispatch.

The PyTorch counterpart of ``repro.core.uct``, formula for formula:

    loss:  n_eff = n + vl,  Q = (w - vl_weight * vl) / max(n_eff, 1)
    wu:    n_eff = n + O,   Q = w / max(n, 1)
    UCT = Q + cp * sqrt(ln(max(n_p, 1)) / max(n_eff, 1))

An idle unvisited child (``n_eff < 0.5``) scores the ``1e30`` sentinel;
invalid slots score ``-1e30``; ties resolve to the lowest index (first-max
argmax).  PUCT rows always take the plain path, as in the JAX package.

Every tensor may carry leading batch axes; scores are float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
VL_MODES = ("loss", "wu")


def uct_scores(child_n, child_w, child_vl, parent_n, cp, *, vl_weight=1.0,
               prior=None, puct=False, child_o=None, vl_mode="loss"):
    """Per-child scores ``[..., A]``; ``parent_n`` is ``[...]`` or a scalar
    and already includes the mode's in-flight count."""
    if vl_mode not in VL_MODES:
        raise ValueError(f"vl_mode must be one of {VL_MODES}, got {vl_mode!r}")
    n = child_n.float()
    pn = torch.as_tensor(parent_n, device=n.device).float().clamp_min(1.0)
    if vl_mode == "wu":
        o = torch.zeros_like(n) if child_o is None else child_o.float()
        n_eff = n + o
        q = child_w / n.clamp_min(1.0)
    else:
        vl = child_vl.float()
        n_eff = n + vl
        q = (child_w - vl_weight * vl) / n_eff.clamp_min(1.0)
    if puct:
        if prior is None:
            raise ValueError("puct scoring needs prior")
        explore = prior * torch.sqrt(pn)[..., None] / (1.0 + n_eff)
    else:
        explore = torch.sqrt(torch.log(pn)[..., None] / n_eff.clamp_min(1.0))
    scores = q + cp * explore
    return torch.where(n_eff < 0.5, 1e30, scores)


def uct_argmax(child_n, child_w, child_vl, parent_n, cp, *, vl_weight=1.0,
               prior=None, puct=False, valid=None, kernels="ref",
               child_o=None, vl_mode="loss"):
    """Best child index ``[...]`` i32 along the last axis; ``valid`` masks
    illegal slots.  ``kernels="cuda"`` routes non-PUCT rows to the
    ``uct_select`` kernel."""
    if kernels == "cuda" and not puct:
        from repro_torch.kernels.uct_select import ops as uops
        return uops.uct_argmax(child_n, child_w, child_vl, parent_n, cp=cp,
                               vl_weight=vl_weight, valid=valid,
                               child_o=child_o, vl_mode=vl_mode, impl="cuda")
    s = uct_scores(child_n, child_w, child_vl, parent_n, cp,
                   vl_weight=vl_weight, prior=prior, puct=puct,
                   child_o=child_o, vl_mode=vl_mode)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    return torch.argmax(s, dim=-1).int()


def uct_argmax_running(child_n, child_w, child_vl, parent_n, parent_id, cp,
                       *, vl_weight=1.0, prior=None, puct=False, valid=None,
                       kernels="ref", child_o=None, vl_mode="loss"):
    """Running-assignment argmax over a wave's ``[..., lanes, A]`` board:
    lanes are assigned in order, and lane k scores with the mode's
    in-flight plane already incremented by the picks of the lanes before it
    that share its ``parent_id`` ``[..., lanes]``.  The delta rides
    ``child_vl`` in "loss" mode and ``child_o`` in "wu" mode; ``parent_n``
    is not adjusted.  An all-invalid lane contributes nothing and returns 0.
    """
    lanes, a = child_n.shape[-2:]
    if valid is None:
        valid = torch.ones(child_n.shape, dtype=torch.bool,
                           device=child_n.device)
    if kernels == "cuda" and not puct:
        from repro_torch.kernels.uct_select import ops as uops
        return uops.uct_argmax_running(
            child_n, child_w, child_vl, parent_n, parent_id, cp=cp,
            vl_weight=vl_weight, valid=valid, child_o=child_o,
            vl_mode=vl_mode, impl="cuda")
    if child_o is None:
        child_o = torch.zeros_like(child_n, dtype=torch.int32)
    parent_n = torch.as_tensor(parent_n, device=child_n.device)
    parent_n = parent_n.expand(child_n.shape[:-1])
    active = valid.any(-1)                                   # [..., L]
    same = parent_id[..., :, None] == parent_id[..., None, :]
    iota_a = torch.arange(a, device=child_n.device)
    contrib = torch.zeros(child_n.shape, dtype=torch.float32,
                          device=child_n.device)
    picks = []
    for k in range(lanes):
        d = contrib[..., k, :]
        if vl_mode == "wu":
            vl_k, o_k = child_vl[..., k, :], child_o[..., k, :] + d
        else:
            vl_k, o_k = child_vl[..., k, :] + d, child_o[..., k, :]
        s = uct_scores(child_n[..., k, :], child_w[..., k, :], vl_k,
                       parent_n[..., k], cp, vl_weight=vl_weight,
                       prior=None if prior is None else prior[..., k, :],
                       puct=puct, child_o=o_k, vl_mode=vl_mode)
        s = torch.where(valid[..., k, :], s, NEG_INF)
        pick = torch.argmax(s, dim=-1)
        add = ((iota_a == pick[..., None]) & active[..., k, None]).float()
        share = same[..., :, k] & active[..., k, None]        # [..., L]
        contrib = contrib + share[..., None].float() * add[..., None, :]
        picks.append(pick)
    return torch.stack(picks, dim=-1).int()
