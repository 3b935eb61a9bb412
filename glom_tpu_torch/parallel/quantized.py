"""EQuARX-style block-scaled int8 quantized reduce, as a wire emulation.

Counterpart of `glom_tpu/parallel/quantized.py`, with its numbers. Each
rank's local gradient contribution is block-quantized to int8 (one f32
scale per block of `DEFAULT_BLOCK` elements), dequantized, and handed to
the exact f32 reduction: one quantization hop, the dominant error term of
the real scheme at small replica counts. The counters price the reduce at
the int8 + scales payload the real collective would carry
(`quantized_wire_bytes`).

Experimental: gated behind TrainConfig.quantized_reduce (off by default)
and stamped into every record.

Error bound: symmetric per-block max-abs scaling with round-to-nearest
gives |x - dq(q(x))| <= max|block| / (2 * 127) per element; all-zero
blocks are exact.
"""

from __future__ import annotations

import torch

# 128 f32 elements share one f32 scale: 1/128 metadata on the wire.
DEFAULT_BLOCK = 128
INT8_MAX = 127.0


def block_quantize_int8(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """x (any shape) -> (q int8 [nb, block], scales f32 [nb, 1], n_pad).

    Flattens, zero-pads to whole blocks, and quantizes each block
    symmetrically by its max-abs; all-zero blocks get scale 1."""
    flat = x.to(torch.float32).reshape(-1)
    n_pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, n_pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scales = torch.where(absmax > 0, absmax / INT8_MAX, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scales), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scales, n_pad


def block_dequantize_int8(q, scales, n_pad: int, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scales).reshape(-1)
    return flat[: flat.numel() - n_pad].reshape(shape).to(dtype)


def quantize_dequantize(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """One wire-quantization hop: what a tensor looks like after riding
    the quantized collective once."""
    q, scales, n_pad = block_quantize_int8(x, block)
    return block_dequantize_int8(q, scales, n_pad, x.shape, x.dtype)


def quantized_wire_bytes(num_elements: int, block: int = DEFAULT_BLOCK) -> int:
    """Payload bytes of one quantized tensor: int8 values plus one f32
    scale per block (vs num_elements * 4 for f32)."""
    nb = -(-num_elements // block)
    return num_elements + nb * 4
