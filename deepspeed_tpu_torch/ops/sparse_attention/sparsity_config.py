"""Block-sparsity layout configs (the port's own copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``; reference:
deepspeed/ops/sparse_attention/sparsity_config.py — SparsityConfig:10 and
the Dense/Fixed/Variable/BigBird/BSLongformer/LocalSlidingWindow
subclasses). Each config builds a boolean block layout
``[num_heads, num_blocks, num_blocks]`` marking which (q-block, k-block)
tiles attention touches; the attention kernel skips the rest.

Layouts are built with numpy at setup time (they depend only on shapes),
with the same code as the JAX package's, so every config gives the same
layout there and here, the seeded random blocks of Variable and BigBird
(``np.random.default_rng(seed)``) included."""

from __future__ import annotations

import numpy as np


class SparsityConfig:
    """reference: sparsity_config.py:10."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be a multiple of block "
                f"{self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def check_and_propagate_first_head_layout(self, layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """reference: :63 — everything attends to everything (debug/baseline)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """reference: :95 — local blocks within a stride + periodic global
    blocks chosen from the tail of each stride (different per head when
    requested)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(attention)
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional")
        if num_different_global_patterns > 1 and \
                not different_layout_per_head:
            raise ValueError(
                "different global patterns need different_layout_per_head")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        stride = self.num_local_blocks
        for h in range(self.num_heads):
            # local windows (reference set_local_layout)
            for start in range(0, n, stride):
                end = min(start + stride, n)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" \
                        else end
                    layout[h, i, start:hi] = True
            # global blocks (reference set_global_layout): last
            # num_global_blocks of each stride, pattern varying per head
            pattern = h % self.num_different_global_patterns
            first = max(stride - (pattern + 1) * self.num_global_blocks, 0)
            for start in range(0, n, stride):
                g0 = start + first
                g1 = min(g0 + self.num_global_blocks, n)
                # vertical: everyone (later, if causal) attends to globals;
                # unidirectional: query i sees global g only where g <= i
                if self.attention == "bidirectional":
                    layout[h, :, g0:g1] = True
                else:
                    layout[h, g0:, g0:g1] |= (np.arange(g0, g1)[None, :]
                                              <= np.arange(g0, n)[:, None])
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """reference: :239 — custom local window sizes + explicit global
    block indices; random blocks per head."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: list[int] | None = None,
                 global_block_indices: list[int] | None = None,
                 global_block_end_indices: list[int] | None = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            # variable local windows (reference set_local_layout)
            start = 0
            wi = 0
            while start < n:
                w = self.local_window_blocks[
                    min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" \
                        else end
                    layout[h, i, start:hi] = True
                start, wi = end, wi + 1
            # global blocks (reference set_global_layout)
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices,
                            self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for g0, g1 in spans:
                g0, g1 = min(g0, n), min(g1, n)
                if self.attention == "bidirectional":
                    layout[h, :, g0:g1] = True
                else:
                    for i in range(n):
                        layout[h, i, g0:min(g1, i + 1)] = True
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
            # random blocks (reference set_random_layout)
            for i in range(n):
                limit = (i + 1) if self.attention == "unidirectional" else n
                if limit > 0 and self.num_random_blocks > 0:
                    cols = rng.choice(limit, size=min(
                        self.num_random_blocks, limit), replace=False)
                    layout[h, i, cols] = True
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """reference: :411 — random + sliding-window + global blocks."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            for i in range(n):
                lo, hi = max(0, i - w), min(n, i + w + 1)
                if self.attention == "unidirectional":
                    hi = i + 1
                layout[h, i, lo:hi] = True
                limit = (i + 1) if self.attention == "unidirectional" else n
                if self.num_random_blocks > 0 and limit > 0:
                    cols = rng.choice(limit, size=min(
                        self.num_random_blocks, limit), replace=False)
                    layout[h, i, cols] = True
            g = min(self.num_global_blocks, n)
            layout[h, :, :g] = True      # everyone sees the globals
            if self.attention == "bidirectional":
                layout[h, :g, :] = True  # globals see everyone
            else:
                for i in range(g):
                    layout[h, i, : i + 1] = True
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """reference: :546 — sliding window + explicit global block indices."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: list[int] | None = None,
                 global_block_end_indices: list[int] | None = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for i in range(n):
                lo = max(0, i - w)
                hi = (i + 1) if self.attention == "unidirectional" \
                    else min(n, i + w + 1)
                layout[h, i, lo:hi] = True
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices,
                            self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for g0, g1 in spans:
                g0, g1 = min(g0, n), min(g1, n)
                layout[h, :, g0:g1] = True
                if self.attention == "bidirectional":
                    layout[h, g0:g1, :] = True
                else:
                    for i in range(g0, g1):
                        layout[h, i, : i + 1] = True
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """reference: :674 — pure sliding window."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            lo = max(0, i - w)
            hi = (i + 1) if self.attention == "unidirectional" \
                else min(n, i + w + 1)
            layout[:, i, lo:hi] = True
        return layout
