"""Automatic tensor parallelism rules (counterpart of
``deepspeed_tpu/inference/auto_tp.py``; reference: module_inject/auto_tp.py
AutoTP.tp_parser:273 classifies each Linear as row- or column-parallel).

Models of the port carry explicit ``partition_rules()``; for a foreign
parameter tree :func:`auto_tp_rules` infers Megatron-style rules from
names and shapes with the reference's policy-table name patterns: q/k/v/
up/gate project out (column-parallel: shard the last dim), o/down/out
project back (row-parallel: shard the first of the matmul dims). A spec is
a tuple of mesh-axis names per dimension (None: not sharded), as JAX's
``PartitionSpec`` holds them. Serving with ``tp_size > 1`` is not ported
yet (ROADMAP Slice D item 12); the rules are the table it will read.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

COLUMN_PAT = re.compile(
    r"(wq|wk|wv|w_up|w_gate|q_proj|k_proj|v_proj|up_proj|gate_proj|"
    r"query|key|value|fc_in|c_fc|w1|w3|in_proj|qkv)", re.I)
ROW_PAT = re.compile(
    r"(wo|w_down|o_proj|down_proj|dense_4h_to_h|out_proj|c_proj|fc_out|"
    r"w2|proj_out)", re.I)


def _leaves(tree: Any, path: tuple = ()):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted at
    each level, sequences by index. A flat mapping with "/"-joined names
    (a model's ``params``) is taken as the tree those names spell."""
    if isinstance(tree, dict):
        if any("/" in str(k) for k in tree):
            nested: dict = {}
            for name, leaf in tree.items():
                node = nested
                *parents, last = str(name).split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[last] = leaf
            tree = nested
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + (str(i),))
    else:
        yield path, tree


def auto_tp_rules(params: Any, tp_axis: str = "tp") -> list:
    """Infer (regex, spec) rules for an arbitrary parameter tree."""
    rules: list[tuple[str, tuple]] = []
    seen: set[str] = set()
    for path, leaf in _leaves(params):
        name = "/".join(path)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else np.shape(leaf)
        if len(shape) < 2:
            continue
        pat = None
        if COLUMN_PAT.search(name):
            spec = [None] * len(shape)
            spec[-1] = tp_axis          # column-parallel: shard out dim
            pat = (re.escape(name) + "$", tuple(spec))
        elif ROW_PAT.search(name):
            spec = [None] * len(shape)
            spec[-2] = tp_axis          # row-parallel: shard in dim
            pat = (re.escape(name) + "$", tuple(spec))
        if pat and pat[0] not in seen:
            seen.add(pat[0])
            rules.append(pat)
    return rules


def get_tp_rules(model, params: Any, tp_axis: str = "tp") -> list:
    """Model-provided rules when available, inferred otherwise
    (reference: policy classes vs the AutoTP fallback)."""
    if hasattr(model, "partition_rules"):
        return model.partition_rules()
    return auto_tp_rules(params, tp_axis)
