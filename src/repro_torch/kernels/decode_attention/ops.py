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
source note.  When B * Hkv is below two blocks per SM the key axis is split
over blocks (flash-decoding, ``split_count``) and a second small kernel
merges the splits; the wrapper allocates their float32 scratch.

``decode_attention_lse`` also returns each ``(b, h)`` row's float32
logsumexp ``[B, H]`` (natural log, -inf for a row with no key), which
the kernel stores behind an optional pointer in both its one-split path
(``da_kernel``) and its combine (``da_combine``): the partial of the
sequence-sharded decode (``parallel/dist_attention.py``).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (float32 or bfloat16, D <= 128, H / Hkv <= 8, 16-byte aligned
operands and strides) and a shape it does not take, a failed build or a
failed launch raises.  The kernel reads rows of a multiple of 16 bytes:
``decode_attention`` pads other head dims with zero columns (a copy of
the cache slice; no configuration has such a head dim).  ``launches`` counts
calls that launch the kernel: ``["decode_attention"]`` without the lse,
``["decode_attention_lse"]`` with it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref as R

launches = {"decode_attention": 0, "decode_attention_lse": 0}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D, MAX_GROUP = 128, 8
SMS = 132                     # H100 SXM streaming multiprocessors
MIN_SPLIT_KEYS = 128          # keys a split gets at least


def split_count(ctas: int, sk: int) -> int:
    """Key-axis splits per (sequence, kv head): enough blocks for two per
    SM when ``ctas`` = B * Hkv falls short, each split >= MIN_SPLIT_KEYS
    keys of the cache."""
    if ctas >= 2 * SMS:
        return 1
    return max(1, min(-(-2 * SMS // ctas), sk // MIN_SPLIT_KEYS))


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
    es = t.element_size()
    if t.data_ptr() % 16 or (t.stride(0) * es) % 16 \
            or (t.stride(1) * es) % 16:
        raise ValueError(f"{name} needs a 16-byte aligned base and batch / "
                         f"sequence strides, got strides {t.stride()}")


def launch(q, k, v, valid_len, out, scale=None, lse=None):
    """Launch ``da_kernel`` (and ``da_combine`` when the keys are split)
    on checked operands; ``scale`` defaults to 1 / sqrt(D); ``lse``, a
    float32 ``[B, H]`` tensor or None, receives each row's logsumexp."""
    b, _, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= d <= MAX_D or (d * q.element_size()) % 16 or h % hkv \
            or h // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention takes D <= {MAX_D} with rows of "
                         f"a multiple of 16 bytes and H / Hkv <= {MAX_GROUP},"
                         f" got D={d} ({q.dtype}), H={h}, Hkv={hkv}")
    _build.check_operand(q, "q", q.dtype, (b, 1, h, d), dev)
    _check_cache(k, "k", q.dtype, (b, sk, hkv, d), dev)
    _check_cache(v, "v", q.dtype, (b, sk, hkv, d), dev)
    _build.check_operand(valid_len, "valid_len", torch.int32, (b,), dev)
    _build.check_operand(out, "out", q.dtype, (b, 1, h, d), dev)
    if lse is not None:
        _build.check_operand(lse, "lse", torch.float32, (b, h), dev)
    if q.data_ptr() % 16:
        raise ValueError("decode_attention needs a 16-byte aligned q")
    splits = split_count(b * hkv, sk)
    part_ml = part_acc = None
    if splits > 1:
        part_ml = torch.empty(b * h * splits * 2, dtype=torch.float32,
                              device=dev)
        part_acc = torch.empty(b * h * splits * d, dtype=torch.float32,
                               device=dev)
    fn = _build.bind("decode_attention", "decode_attention_fwd",
                     [_P] * 8 + [_I] * 5 + [_L] * 4 + [_F, _I, _I, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid_len.data_ptr(), out.data_ptr(),
                    part_ml.data_ptr() if splits > 1 else None,
                    part_acc.data_ptr() if splits > 1 else None,
                    None if lse is None else lse.data_ptr(), b, sk, h,
                    hkv, d, k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), scale or 1.0 / math.sqrt(d), splits,
                    _DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream(dev).cuda_stream),
                 "decode_attention")
    launches["decode_attention" if lse is None
             else "decode_attention_lse"] += 1
    return out


def decode_attention(q, k, v, valid_len, *, impl=None):
    """q ``[B, 1, H, D]``; k, v ``[B, Sk, Hkv, D]``; ``valid_len [B]`` ->
    ``[B, 1, H, D]`` in q's dtype (zeros where ``valid_len`` is 0)."""
    if _build.resolve_impl(impl, q) == "ref":
        return R.decode_attention_ref(q, k, v, valid_len)
    return _run(q, k, v, valid_len, None)


def decode_attention_lse(q, k, v, valid_len, *, impl=None):
    """``decode_attention`` and each row's float32 logsumexp of its scaled
    scores, ``[B, H]`` (-inf where ``valid_len`` is 0)."""
    if _build.resolve_impl(impl, q) == "ref":
        return R.decode_attention_lse_ref(q, k, v, valid_len)
    b, _, h, _ = q.shape
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    return _run(q, k, v, valid_len, lse), lse


def _run(q, k, v, valid_len, lse):
    _build.refuse_grad("decode_attention", q, k, v)
    d = q.shape[-1]
    pad = -d % (16 // q.element_size())
    if pad:      # rows of 16-byte multiples: zero columns add to no score
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    q = q.contiguous()
    if q.data_ptr() % 16:             # the kernel reads q in 16-byte pieces
        q = q.clone()
    valid_len = valid_len.to(torch.int32).contiguous()
    out = launch(q, k, v, valid_len, torch.empty_like(q),
                 scale=1.0 / math.sqrt(d), lse=lse)
    return out[..., :d] if pad else out
