"""Flash-decode: the CUDA kernel wrapper with its plain version.

``decode_attention`` runs one query row per sequence against its KV cache
in ``csrc/decode_attention.cu`` (kernel ``da_kernel``, replacing the
Pallas ``decode_attention_bhd`` / ``_dec_kernel`` of
``repro/kernels/decode_attention/kernel.py``) on CUDA tensors, and the
plain version (``ref.py``) on CPU tensors.  Public layout as the JAX
wrapper's: q ``[B, 1, H, D]``, k / v ``[B, Sk, Hkv, D]``.

k and v may be strided views (their head and feature dims packed): the
kernel takes their batch and sequence strides, so ``step_fn`` hands it one
layer's slice of the batched cache without a copy.

Bound on an H100: bytes — every valid key and value is read once; see the
source note.  Dispatch: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel (float32 or bfloat16, D <= 128, H / Hkv <= 8) and a
failed build or launch raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref as R

launches = {"decode_attention": 0}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D, MAX_GROUP = 128, 8


def _check_cache(t, name, dtype, shape, device):
    """A cache operand: right device, dtype and shape; head and feature
    dims packed (any batch and sequence strides)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(3) != 1 or t.stride(2) != shape[3]:
        raise ValueError(f"{name} needs packed head and feature dims, got "
                         f"strides {t.stride()}")


def launch(q, k, v, valid_len, out):
    """Launch ``da_kernel`` on checked operands."""
    b, _, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_D or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention takes D <= {MAX_D} and H / Hkv "
                         f"<= {MAX_GROUP}, got D={d}, H={h}, Hkv={hkv}")
    _build.check_operand(q, "q", q.dtype, (b, 1, h, d), dev)
    _check_cache(k, "k", q.dtype, (b, sk, hkv, d), dev)
    _check_cache(v, "v", q.dtype, (b, sk, hkv, d), dev)
    _build.check_operand(valid_len, "valid_len", torch.int32, (b,), dev)
    _build.check_operand(out, "out", q.dtype, (b, 1, h, d), dev)
    fn = _build.bind(_build.load("decode_attention"), "decode_attention_fwd",
                     [_P] * 5 + [_I] * 5 + [_L] * 4 + [_F, _I, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid_len.data_ptr(), out.data_ptr(), b, sk, h, hkv, d,
                    k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                    1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "decode_attention")
    launches["decode_attention"] += 1
    return out


def decode_attention(q, k, v, valid_len, *, impl=None):
    """q ``[B, 1, H, D]``; k, v ``[B, Sk, Hkv, D]``; ``valid_len [B]`` ->
    ``[B, 1, H, D]`` in q's dtype (zeros where ``valid_len`` is 0)."""
    if _build.resolve_impl(impl, q) == "ref":
        return R.decode_attention_ref(q, k, v, valid_len)
    q = q.contiguous()
    valid_len = valid_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    return launch(q, k, v, valid_len, out)
