"""Flash-attention forward: the CUDA kernels' wrapper with its plain version.

``flash_attention`` runs the blocked online-softmax forward of
``csrc/flash_attention.cu`` (replacing the Pallas ``flash_attention_bhsd``
/ ``_fa_kernel`` of ``repro/kernels/flash_attention/kernel.py``) on CUDA
tensors, and the plain version (``ref.py``) on CPU tensors.  It takes the
JAX wrapper's public layout, ``[B, S, H, D]``, and honours ``q_offset``
and ``logits_soft_cap``, which the Pallas path drops.

Two kernels, by dtype: bfloat16 goes to ``fa_wgmma_kernel`` (both
products on the tensor cores, P rounded to bf16 before PV as the Pallas
kernel rounds it; (q/k head dim, v head dim) in ``BF16_HEAD_DIMS``, the
last MLA's; bound on an H100: bytes), float32 to ``fa_kernel``
(register-blocked IEEE float32 FFMA fed by cp.async, v head dim <= q/k
head dim <= 128; bound: operations).  See the source note.

Training (``flash_attention_lse`` / ``flash_attention_bwd``, behind
``models.layers.blocked_attention``): the same kernels also write each
row's logsumexp (``[B, H, Sq]`` float32, natural log), and the backward
kernels of ``csrc/flash_attention_bwd.cu`` (the counterpart of the JAX
package's custom VJP ``_core_bwd``, no atomics) give dq, dk, dv from it:
in bfloat16 on the tensor cores (wgmma fed by TMA, P and dS rounded to
bf16 before the products; (q/k, v) head dims in ``BWD_BF16_HEAD_DIMS``),
in float32 as IEEE float32 FFMA (v head dim <= q/k head dim <= 128).
Their plain versions are ``ref.py``'s copies of ``_blocked_fwd`` /
``_core_bwd``.  ``flash_attention`` has no
backward: under grad mode with an input that requires grad, its CUDA path
raises rather than return a result cut from the graph.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel of its dtype, and a shape it does not take, a failed build or a
failed launch raises.  ``launches`` counts each kernel's launches; the
bf16 launches whose v head dim differs from q's (MLA) count under
``flash_attention_bf16_mla``; the forward launches that write the
logsumexp count under ``flash_attention_lse`` only, and each backward call
(three kernels) once under ``flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as R

launches = {"flash_attention": 0, "flash_attention_bf16": 0,
            "flash_attention_bf16_mla": 0, "flash_attention_lse": 0,
            "flash_attention_bwd": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_D = 128
# (q / k head dim, v head dim): the dense, zamba2, whisper and internvl2
# heads, and deepseek-v2's MLA (qk_nope 128 + qk_rope 64, v 128)
BF16_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
# the bf16 backward's: the forward's less MLA's (192, 128), whose D is past
# the backward's 128
BWD_BF16_HEAD_DIMS = ((64, 64), (80, 80), (128, 128))
# dtype -> C entry point
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
# the plain versions' blocks (the JAX configs' ``attn_blk_q`` / ``_k``)
BLK_Q, BLK_K = 256, 1024


def counter(dtype, d: int, dv: int) -> str:
    """The ``launches`` key a launch of this dtype and head dims adds to."""
    if dtype == torch.float32:
        return "flash_attention"
    return "flash_attention_bf16" if d == dv else "flash_attention_bf16_mla"


def launch(q, k, v, out, *, causal, q_offset, logits_soft_cap, seq_k_valid,
           lse=None):
    """Launch the kernel of q's dtype on checked contiguous operands;
    ``lse`` (``[B, H, Sq]`` float32, or None) receives the rows'
    logsumexp."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if h % hkv:
        raise ValueError(f"flash_attention takes H a multiple of Hkv, got "
                         f"H={h}, Hkv={hkv}")
    if q.dtype == torch.bfloat16 and (d, dv) not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 flash_attention kernel takes (q/k, v) "
                         f"head dims {BF16_HEAD_DIMS}, got ({d}, {dv})")
    if q.dtype == torch.float32 and not 1 <= dv <= d <= MAX_D:
        raise ValueError(f"the float32 flash_attention kernel takes v head "
                         f"dim <= q/k head dim <= {MAX_D}, got ({d}, {dv})")
    _build.check_operand(q, "q", q.dtype, (b, sq, h, d), dev)
    _build.check_operand(k, "k", q.dtype, (b, sk, hkv, d), dev)
    _build.check_operand(v, "v", q.dtype, (b, sk, hkv, dv), dev)
    _build.check_operand(out, "out", q.dtype, (b, sq, h, dv), dev)
    if lse is not None:
        _build.check_operand(lse, "lse", torch.float32, (b, h, sq), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention needs 16-byte aligned operands")
    entry = _ENTRY[q.dtype]
    fn = _build.bind("flash_attention", entry,
                     [_P] * 5 + [_I] * 10 + [_F, _F, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    b, sq, sk, int(seq_k_valid), h, hkv, d, dv, int(causal),
                    int(q_offset), 1.0 / math.sqrt(d),
                    float(logits_soft_cap),
                    torch.cuda.current_stream(dev).cuda_stream), entry)
    launches["flash_attention_lse" if lse is not None
             else counter(q.dtype, d, dv)] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    logits_soft_cap: float = 0.0, seq_k_valid=None,
                    impl=None):
    """q ``[B, Sq, H, D]``; k ``[B, Sk, Hkv, D]``; v ``[B, Sk, Hkv, Dv]``
    -> ``[B, Sq, H, Dv]`` in q's dtype.  ``seq_k_valid`` (default Sk)
    masks kv padding."""
    seq_k = k.shape[1] if seq_k_valid is None else int(seq_k_valid)
    if _build.resolve_impl(impl, q) == "ref":
        return R.flash_attention_ref(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     logits_soft_cap=logits_soft_cap,
                                     seq_k_valid=seq_k)
    _build.refuse_grad("flash_attention (use models.layers.attention or "
                       "flash_attention_lse / flash_attention_bwd to train)",
                       q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    return launch(q, k, v, out, causal=causal, q_offset=q_offset,
                  logits_soft_cap=logits_soft_cap, seq_k_valid=seq_k)


def flash_attention_lse(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        logits_soft_cap: float = 0.0, seq_k_valid=None,
                        blk_q: int = BLK_Q, blk_k: int = BLK_K, impl=None):
    """The training forward: ``(out [B, Sq, H, Dv], lse [B, H, Sq]
    float32)``, lse the natural-log logsumexp of each row's scaled, capped,
    masked scores.  CUDA tensors: the kernel of q's dtype, writing lse
    (+inf for a row with no key); CPU tensors: the copy of
    ``_blocked_fwd`` with blocks of ``min(blk_q, Sq)`` x ``min(blk_k,
    Sk)``.  Not differentiable itself: ``models.layers.blocked_attention``
    pairs it with ``flash_attention_bwd``."""
    b, sq, h = q.shape[:3]
    sk = k.shape[1]
    seq_k = sk if seq_k_valid is None else int(seq_k_valid)
    if _build.resolve_impl(impl, q) == "ref":
        return R.blocked_fwd_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 blk_q=min(blk_q, sq), blk_k=min(blk_k, sk),
                                 logits_soft_cap=logits_soft_cap,
                                 seq_k_valid=seq_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch(q, k, v, out, causal=causal, q_offset=q_offset,
           logits_soft_cap=logits_soft_cap, seq_k_valid=seq_k, lse=lse)
    return out, lse


def launch_bwd(q, k, v, out, lse, dout, dq, dk, dv, *, causal, q_offset,
               logits_soft_cap, seq_k_valid):
    """Launch the backward kernels of q's dtype on checked contiguous
    operands (three launches: delta, dk / dv, dq)."""
    b, sq, h, d = q.shape
    sk, hkv, dvd = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    if q.dtype not in _BWD_ENTRY:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if h % hkv:
        raise ValueError(f"flash_attention_bwd takes H a multiple of Hkv, "
                         f"got H={h}, Hkv={hkv}")
    if q.dtype == torch.bfloat16 and (d, dvd) not in BWD_BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 flash_attention_bwd kernels take (q/k, "
                         f"v) head dims {BWD_BF16_HEAD_DIMS}, got ({d}, "
                         f"{dvd})")
    if q.dtype == torch.float32 and not 1 <= dvd <= d <= MAX_D:
        raise ValueError(f"the float32 flash_attention_bwd kernels take v "
                         f"head dim <= q/k head dim <= {MAX_D}, got ({d}, "
                         f"{dvd})")
    for t, name, shape in ((q, "q", (b, sq, h, d)), (k, "k", (b, sk, hkv, d)),
                           (v, "v", (b, sk, hkv, dvd)),
                           (out, "out", (b, sq, h, dvd)),
                           (dout, "dout", (b, sq, h, dvd)),
                           (dq, "dq", (b, sq, h, d)),
                           (dk, "dk", (b, sk, hkv, d)),
                           (dv, "dv", (b, sk, hkv, dvd))):
        _build.check_operand(t, name, q.dtype, shape, dev)
    _build.check_operand(lse, "lse", torch.float32, (b, h, sq), dev)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v, dout)):
        raise ValueError("the bf16 flash_attention_bwd kernels read q, k, "
                         "v and dout by TMA: 16-byte aligned operands")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    entry = _BWD_ENTRY[q.dtype]
    fn = _build.bind("flash_attention_bwd", entry,
                     [_P] * 10 + [_I] * 10 + [_F, _F, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk,
                    int(seq_k_valid), h, hkv, d, dvd, int(causal),
                    int(q_offset), 1.0 / math.sqrt(d),
                    float(logits_soft_cap),
                    torch.cuda.current_stream(dev).cuda_stream), entry)
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        q_offset: int = 0, logits_soft_cap: float = 0.0,
                        seq_k_valid=None, blk_q: int = BLK_Q,
                        blk_k: int = BLK_K, impl=None):
    """``(dq, dk, dv)`` in the dtypes of q, k, v from the forward's saved
    ``out`` and ``lse [B, H, Sq]`` and the output gradient ``dout``.  CUDA
    tensors: the kernels of ``csrc/flash_attention_bwd.cu``; CPU tensors:
    the copy of ``_core_bwd`` with the forward's blocks."""
    sq, sk = q.shape[1], k.shape[1]
    seq_k = sk if seq_k_valid is None else int(seq_k_valid)
    kw = dict(causal=causal, q_offset=q_offset,
              logits_soft_cap=logits_soft_cap, seq_k_valid=seq_k)
    if _build.resolve_impl(impl, q) == "ref":
        return R.blocked_bwd_ref(q, k, v, out, lse, dout,
                                 blk_q=min(blk_q, sq), blk_k=min(blk_k, sk),
                                 **kw)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    if q.shape[0] * sq * sk == 0:       # nothing to launch
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    return launch_bwd(q, k, v, out, lse.contiguous(), dout, dq, dk, dv, **kw)
