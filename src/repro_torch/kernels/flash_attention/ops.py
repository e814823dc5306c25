"""Flash-attention forward: the CUDA kernels' wrapper with its plain version.

``flash_attention`` runs the blocked online-softmax forward of
``csrc/flash_attention.cu`` (replacing the Pallas ``flash_attention_bhsd``
/ ``_fa_kernel`` of ``repro/kernels/flash_attention/kernel.py``) on CUDA
tensors, and the plain version (``ref.py``) on CPU tensors.  It takes the
JAX wrapper's public layout, ``[B, S, H, D]``, and honours ``q_offset``
and ``logits_soft_cap``, which the Pallas path drops.

Two kernels, by dtype: bfloat16 goes to ``fa_wgmma_kernel`` (both
products on the tensor cores, P rounded to bf16 before PV as the Pallas
kernel rounds it; head dim 64, 80 or 128; bound on an H100: bytes),
float32 to ``fa_kernel`` (register-blocked IEEE float32 FFMA fed by
cp.async, head dim <= 128; bound: operations).  See the source note.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel of its dtype, and a shape it does not take, a failed build or a
failed launch raises.  ``launches`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as R

launches = {"flash_attention": 0, "flash_attention_bf16": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_D = 128
BF16_HEAD_DIMS = (64, 80, 128)
# dtype -> (C entry point, launch counter)
_ENTRY = {torch.float32: ("flash_attention_f32", "flash_attention"),
          torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16")}


def launch(q, k, v, out, *, causal, q_offset, logits_soft_cap, seq_k_valid):
    """Launch the kernel of q's dtype on checked contiguous operands."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_D or h % hkv:
        raise ValueError(f"flash_attention takes head dim <= {MAX_D} and H "
                         f"a multiple of Hkv, got D={d}, H={h}, Hkv={hkv}")
    if q.dtype == torch.bfloat16 and d not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 flash_attention kernel takes head dim "
                         f"{BF16_HEAD_DIMS}, got D={d}")
    _build.check_operand(q, "q", q.dtype, (b, sq, h, d), dev)
    for t, nm in ((k, "k"), (v, "v")):
        _build.check_operand(t, nm, q.dtype, (b, sk, hkv, d), dev)
    _build.check_operand(out, "out", q.dtype, (b, sq, h, d), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention needs 16-byte aligned operands")
    entry, counter = _ENTRY[q.dtype]
    fn = _build.bind("flash_attention", entry,
                     [_P] * 4 + [_I] * 9 + [_F, _F, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, sq, sk, int(seq_k_valid), h, hkv, d, int(causal),
                    int(q_offset), 1.0 / math.sqrt(d),
                    float(logits_soft_cap),
                    torch.cuda.current_stream(dev).cuda_stream), entry)
    launches[counter] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    logits_soft_cap: float = 0.0, seq_k_valid=None,
                    impl=None):
    """q ``[B, Sq, H, D]``; k, v ``[B, Sk, Hkv, D]`` -> ``[B, Sq, H, D]``
    in q's dtype.  ``seq_k_valid`` (default Sk) masks kv padding."""
    seq_k = k.shape[1] if seq_k_valid is None else int(seq_k_valid)
    if _build.resolve_impl(impl, q) == "ref":
        return R.flash_attention_ref(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     logits_soft_cap=logits_soft_cap,
                                     seq_k_valid=seq_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    return launch(q, k, v, out, causal=causal, q_offset=q_offset,
                  logits_soft_cap=logits_soft_cap, seq_k_valid=seq_k)
