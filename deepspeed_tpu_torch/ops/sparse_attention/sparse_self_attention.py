"""Block-sparse self-attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``;
reference: deepspeed/ops/sparse_attention/sparse_self_attention.py).

With no relative-position bias and no masks, a layout the block-skipping
kernels take (``kernels.supports_kernel``) runs them: the hand-written
kernels of ``csrc/block_sparse_attention.cu`` on CUDA tensors, their plain
versions on CPU tensors. Anything else takes the dense+mask form, the JAX
package's own jnp path written in plain PyTorch: the layout expanded to an
additive bias over the full [S, S] scores. Dead blocks contribute exactly
zero probability either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .kernels import BlockSparseAttention, supports_kernel
from .sparsity_config import FixedSparsityConfig, SparsityConfig


def layout_to_bias(layout: np.ndarray, block: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """[H, nq, nk] block layout -> [H, S, S] additive bias (0 / -1e30)."""
    dense = np.kron(layout.astype(np.float32),
                    np.ones((block, block), np.float32))
    bias = np.where(dense > 0, 0.0, -1e30).astype(np.float32)
    return torch.from_numpy(bias).to(device=device, dtype=dtype)


class SparseSelfAttention(nn.Module):
    """reference: sparse_self_attention.py:20 — q/k/v in, context out,
    block-sparsity per the config's layout. The layout's bias (dense path)
    and the kernels' block lists are built once per shape and kept on the
    device of the first call there."""

    def __init__(self, sparsity_config: SparsityConfig | None = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._bias_cache: dict[tuple, torch.Tensor] = {}
        self._kernel_cache: dict[tuple, BlockSparseAttention | None] = {}

    def _bias(self, seq_len: int, device) -> torch.Tensor:
        key = (seq_len, torch.device(device))
        if key not in self._bias_cache:
            layout = self.sparsity_config.make_layout(seq_len)
            self._bias_cache[key] = layout_to_bias(
                layout, self.sparsity_config.block, device=device)
        return self._bias_cache[key]

    def _kernel(self, seq_len: int, heads: int, head_dim: int):
        """The block-skipping attention for this shape (cached), or None
        where the kernel path does not apply."""
        key = (seq_len, heads, head_dim)
        if key not in self._kernel_cache:
            layout = self.sparsity_config.make_layout(seq_len)[:heads]
            self._kernel_cache[key] = (
                BlockSparseAttention(layout, head_dim)
                if supports_kernel(layout, seq_len, head_dim) else None)
        return self._kernel_cache[key]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None):
        """q/k/v: [batch, heads, seq, head_dim] (reference layout)."""
        b, h, s, d = query.shape
        if rpe is None and key_padding_mask is None and attn_mask is None:
            fn = self._kernel(s, h, d)
            if fn is not None:
                return fn(query, key, value)
        bias = self._bias(s, query.device)[:h]
        scores = torch.einsum("bhqd,bhkd->bhqk", query, key) / math.sqrt(d)
        scores = scores + bias[None].to(scores.dtype)
        if rpe is not None:
            scores = scores + rpe
        if key_padding_mask is not None:
            kp = key_padding_mask[:, None, None, :]
            if self.key_padding_mask_mode == "add":
                scores = scores + kp
            else:
                scores = torch.where(kp > 0, scores, -1e30)
        if attn_mask is not None:
            if self.attn_mask_mode == "add":
                scores = scores + attn_mask
            else:
                scores = torch.where(attn_mask > 0, scores, -1e30)
        probs = torch.softmax(scores.float(), dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", probs.to(value.dtype), value)


class SparseAttentionUtils:
    """reference: sparse_attention_utils.py — helpers to pad sequences to
    a block multiple and unpad outputs."""

    @staticmethod
    def pad_to_block_size(block: int, tokens: torch.Tensor,
                          pad_id: int = 0) -> tuple[torch.Tensor, int]:
        s = tokens.shape[1]
        pad = (-s) % block
        if pad == 0:
            return tokens, 0
        return torch.nn.functional.pad(tokens, (0, pad), value=pad_id), pad

    @staticmethod
    def unpad_sequence_output(pad_len: int,
                              out: torch.Tensor) -> torch.Tensor:
        return out[:, : out.shape[1] - pad_len] if pad_len else out
