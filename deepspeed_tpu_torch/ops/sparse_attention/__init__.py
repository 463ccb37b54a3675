"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/``; reference:
deepspeed/ops/sparse_attention/)."""

from .sparse_self_attention import (SparseAttentionUtils,  # noqa: F401
                                    SparseSelfAttention, layout_to_bias)
from .sparsity_config import (BigBirdSparsityConfig,  # noqa: F401
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)
