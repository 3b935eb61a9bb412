"""K1 forward: the fused grouped per-level MLP, level-major [G, M, d].

Counterpart of `glom_tpu/kernels/grouped_mlp.py` (forward). The CUDA
kernel `csrc/grouped_mlp.cu` replaces both `_mlp_kernel` (bottom-up) and
`_mlp_kernel_add` (top-down, positional addend folded into the load):

    out[g] = GELU((x[g] + tile(add)) @ w1[g] + b1[g]) @ w2[g] + b2[g]

with the [G, M, f] hidden kept on chip. Per-dtype rules of the reference
kernel: bf16 uses the tanh GELU, f32 the exact erf; both products
accumulate in f32, the hidden is rounded to x's dtype before the second.

`fused_grouped_ffw_lm` runs the plain PyTorch version `grouped_mlp_plain`
for tensors on the CPU and launches the kernel for CUDA tensors (raising
on anything it does not take). `LAUNCHES` counts kernel launches,
`LAUNCHES_ADD` those with an addend.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from glom_tpu_torch.kernels import _build
from glom_tpu_torch.ops.ffw import GroupedFFWParams

LAUNCHES = 0
LAUNCHES_ADD = 0

ROW_TILE = 32  # rows of x per block (csrc/grouped_mlp.cu TM)
WIDTH_MULTIPLE = 64  # d and f must be multiples of this

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grouped_mlp_fwd": ([_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "grouped_mlp_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("grouped_mlp", _SIGNATURES)


def grouped_mlp_plain(
    params: GroupedFFWParams, x: torch.Tensor, add: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points."""
    w1, b1, w2, b2 = params
    f32 = torch.float32
    G, M, d = x.shape
    if add is not None:
        x = (x + add.repeat(M // add.shape[0], 1)[None]).to(x.dtype)
    pre = torch.bmm(x.to(f32), w1.to(f32)) + b1.to(f32)[:, None, :]
    h = F.gelu(pre, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    h = h.to(x.dtype)
    out = torch.bmm(h.to(f32), w2.to(f32)) + b2.to(f32)[:, None, :]
    return out.to(x.dtype)


def check_kernel_args(
    params: GroupedFFWParams, x: torch.Tensor, add: Optional[torch.Tensor]
) -> None:
    """Raise ValueError for anything the CUDA kernel does not take."""
    w1, b1, w2, b2 = params
    if x.dim() != 3:
        raise ValueError(f"x must be [G, M, d], got {tuple(x.shape)}")
    G, M, d = x.shape
    f = w1.shape[-1]
    want = {"w1": (G, d, f), "b1": (G, f), "w2": (G, f, d), "b2": (G, d)}
    got = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    tensors = dict(got, x=x)
    if add is not None:
        want["add"] = (add.shape[0], d)
        got["add"] = tensors["add"] = add
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} shape {tuple(got[name].shape)} != {shape}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {x.dtype}: the kernel takes bfloat16 or float32")
    for name, t in tensors.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("w1", "w2"):  # read as WMMA fragments straight from memory
        if got[name].data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    if d % WIDTH_MULTIPLE or f % WIDTH_MULTIPLE:
        raise ValueError(f"d={d} and f={f} must be multiples of {WIDTH_MULTIPLE}")
    if M % ROW_TILE:
        raise ValueError(f"M={M} must be a multiple of {ROW_TILE}")
    if add is not None and M % add.shape[0]:
        raise ValueError(f"addend rows {add.shape[0]} must divide M={M}")


def fused_grouped_ffw_lm(
    params: GroupedFFWParams,
    x: torch.Tensor,
    *,
    add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x [G, M, d] -> [G, M, d]; add: optional [n, d] positional addend with
    M = b * n (n inner), added to row r as add[r mod n] on load."""
    global LAUNCHES, LAUNCHES_ADD
    if x.device.type == "cpu":
        return grouped_mlp_plain(params, x, add)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_args(params, x, add)
    lib = _lib()
    G, M, d = x.shape
    f = params.w1.shape[-1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    w1, b1, w2, b2 = params
    err = lib.grouped_mlp_fwd(
        x.data_ptr(), add.data_ptr() if add is not None else None,
        add.shape[0] if add is not None else 0,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        G, M, d, f, is_bf16, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "grouped_mlp_fwd", lib.grouped_mlp_error_string)
    LAUNCHES += 1
    if add is not None:
        LAUNCHES_ADD += 1
    return out
