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

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel of its dtype, and a shape it does not take, a failed build or a
failed launch raises.  ``launches`` counts each kernel's launches; the
bf16 launches whose v head dim differs from q's (MLA) count under
``flash_attention_bf16_mla``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as R

launches = {"flash_attention": 0, "flash_attention_bf16": 0,
            "flash_attention_bf16_mla": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_D = 128
# (q / k head dim, v head dim): the dense, zamba2, whisper and internvl2
# heads, and deepseek-v2's MLA (qk_nope 128 + qk_rope 64, v 128)
BF16_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))
# dtype -> C entry point
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def counter(dtype, d: int, dv: int) -> str:
    """The ``launches`` key a launch of this dtype and head dims adds to."""
    if dtype == torch.float32:
        return "flash_attention"
    return "flash_attention_bf16" if d == dv else "flash_attention_bf16_mla"


def launch(q, k, v, out, *, causal, q_offset, logits_soft_cap, seq_k_valid):
    """Launch the kernel of q's dtype on checked contiguous operands."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention needs 16-byte aligned operands")
    entry = _ENTRY[q.dtype]
    fn = _build.bind("flash_attention", entry,
                     [_P] * 4 + [_I] * 10 + [_F, _F, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, sq, sk, int(seq_k_valid), h, hkv, d, dv, int(causal),
                    int(q_offset), 1.0 / math.sqrt(d),
                    float(logits_soft_cap),
                    torch.cuda.current_stream(dev).cuda_stream), entry)
    launches[counter(q.dtype, d, dv)] += 1
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = q.new_empty(q.shape[:-1] + v.shape[-1:])
    return launch(q, k, v, out, causal=causal, q_offset=q_offset,
                  logits_soft_cap=logits_soft_cap, seq_k_valid=seq_k)
