"""Carry JAX parameters into the port's modules.

The two frameworks' random generators cannot make the same weights, so a
test that holds the port against the JAX package builds the JAX params
once and moves them across: ``load_jax_params(model, tree)`` takes the
nested dict of numpy arrays that ``jax.tree.map(np.asarray,
DecoderLM.init(key))`` gives and copies every leaf into the module's
parameter of the same path (``"layers/wq"`` for ``tree["layers"]["wq"]``).
It also takes a flat ``{"layers/wq": tensor}`` mapping of torch tensors,
such as another engine's ``params``: a leaf that already is the parameter
is kept as it is, so engines built over one model share its weights.

``load_serving_params`` is the serving engines' one loader: float leaves
cast to the serving dtype, or weight-only int8 (quantized leaf by leaf, or
a pre-quantized tree); a leaf may be :class:`Deferred`, computed only when
the loader reaches it (``checkpoint/huggingface.py`` stacks a checkpoint's
layers that way, one leaf at a time);
``lora_from_jax`` carries a JAX ``LoRAModel``'s frozen base (with its
``QuantizedParameter`` leaves) and adapters, so both sides compute from
the same values.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..moe.sharded_moe import quantize_expert_leaf
from ..ops.quantization import quantize_dense_leaf, quantizes


class Deferred:
    """A leaf computed when a loader reads it: ``leaf()`` gives the tensor
    or array. The loaders here compute one at a time, so a tree of them
    never exists whole in host memory."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self):
        return self.fn()


def _value(leaf):
    """A :class:`Deferred` leaf computed; any other as it is."""
    return leaf() if isinstance(leaf, Deferred) else leaf


def materialize(tree: dict) -> dict:
    """``tree`` with every :class:`Deferred` leaf computed."""
    return {k: materialize(v) if isinstance(v, dict) else _value(v)
            for k, v in tree.items()}


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b": leaf}."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def _shares(leaf, param: torch.Tensor) -> bool:
    """Whether ``leaf`` is ``param`` itself (the same memory and layout)."""
    return (isinstance(leaf, torch.Tensor) and leaf.dtype == param.dtype
            and leaf.device == param.device and leaf.shape == param.shape
            and leaf.data_ptr() == param.data_ptr())


def _to_numpy(leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: torch can't
        arr = arr.astype(np.float32)   # wrap it; the widening is exact
    return arr


@torch.no_grad()
def load_jax_params(model, tree: dict) -> None:
    """Copy a JAX parameter tree into ``model.params`` (cast to each
    parameter's dtype and device). Every name must match both ways and
    every shape exactly."""
    flat = flatten_tree(dict(tree.items()))
    have, want = set(flat), set(model.params.keys())
    if have != want:
        raise ValueError(
            f"parameter names differ: missing {sorted(want - have)}, "
            f"unexpected {sorted(have - want)}")
    for name, leaf in flat.items():
        leaf = _value(leaf)
        param = model.params[name]
        if _shares(leaf, param):
            continue
        if isinstance(leaf, torch.Tensor):
            src = leaf.detach()
        else:
            src = torch.from_numpy(np.array(_to_numpy(leaf)))  # writable
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(param.shape)}")
        param.copy_(src)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _leaf_tensor(leaf, device) -> torch.Tensor:
    """A numpy or torch leaf as a tensor on ``device`` (bf16 numpy widened
    to fp32, exactly)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device)
    return torch.from_numpy(np.array(_to_numpy(leaf))).to(device)


def _check_shape(name: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"{name}: shape {tuple(got)} != {tuple(want)}")


@torch.no_grad()
def load_serving_params(model, tree: dict | None, generator, dtype,
                        quantize: bool, min_size: int = 1 << 16,
                        quantize_experts: bool = False) -> None:
    """The serving engines' weights, leaf by leaf in the model's init order,
    as the JAX engine builds its tree: each float leaf copied from ``tree``
    (a JAX-layout tree or flat mapping) or drawn from ``generator`` (fp32,
    :meth:`DecoderLM.draw`); with ``quantize``, each leaf that
    ``quantize_dense_params`` takes becomes ``name_q`` (int8) + ``name_s``
    (scales in ``dtype``) before the cast, as JAX quantizes before it;
    every other float leaf is cast to ``dtype``. A ``name_q`` / ``name_s``
    pair in ``tree`` (a pre-quantized tree) is taken as it is, its scales
    cast. Names and shapes must match as :func:`load_jax_params` wants
    them (a pair: the codes the leaf's shape, the scales that shape with
    the contraction axis, -2, reduced to 1). With ``quantize_experts``
    (the engines' ``quantize_moe_experts``), each routed-expert leaf
    (``layers/experts/*``) left float is cast to ``dtype`` and then
    quantized by ``moe.quantize_experts`` with scales in ``dtype``, as the
    JAX engine casts its tree before it quantizes the experts. A leaf the
    model names in ``layerwise_draws`` and ``tree`` does not give is drawn
    and converted a layer at a time (Mixtral-8x7B's expert stacks are 60
    GB each in fp32). A leaf that already is the
    model's parameter is kept (engines built over one model share its
    weights); any other given tensor is copied. One leaf's float values
    exist on the device at a time, so the float tree never does (the
    model may hold meta parameters, ``transformer.deferred_weights``)."""
    spec = model._init_spec
    dev = model.device
    flat = flatten_tree(dict(tree.items())) if tree is not None else None
    if flat is not None:
        allowed = set(spec) | {n + sfx for n in spec for sfx in ("_q", "_s")}
        missing = [n for n in spec if n not in flat
                   and not (n + "_q" in flat and n + "_s" in flat)]
        if missing or set(flat) - allowed:
            raise ValueError(
                f"parameter names differ: missing {sorted(missing)}, "
                f"unexpected {sorted(set(flat) - allowed)}")
    params = model.params

    def drop(*names):
        for n in names:
            if n in params:
                del params[n]

    def put(name, tensor, **kw):
        drop(name)
        params[name] = (tensor if isinstance(tensor, nn.Parameter)
                        else nn.Parameter(tensor, **kw))

    for name, (shape, _) in spec.items():
        if flat is not None and name not in flat:      # pre-quantized
            q, s = _value(flat[name + "_q"]), _value(flat[name + "_s"])
            _check_shape(name + "_q", q.shape, shape)
            _check_shape(name + "_s", s.shape,
                         (*shape[:-2], 1, shape[-1]))
            drop(name)
            if not (isinstance(q, nn.Parameter) and q.device == dev):
                q = _leaf_tensor(q, dev).to(torch.int8)
            put(name + "_q", q, requires_grad=False)
            put(name + "_s", _leaf_tensor(s, dev).to(dtype))
            continue
        leaf = _value(flat[name]) if flat is not None else None
        if leaf is not None:
            _check_shape(name, leaf.shape, shape)
        quantized = quantize and quantizes(name, torch.empty(
            shape, device="meta"), min_size)
        expert_q = (quantize_experts and not quantized
                    and name.startswith("layers/experts/"))
        if (leaf is not None and not quantized and not expert_q
                and name in params and _shares(leaf, params[name])):
            continue

        def convert(value):
            if quantized:
                return quantize_dense_leaf(value, dtype)
            if expert_q:
                return quantize_expert_leaf(value.to(dtype), dtype)
            return value.to(dtype)

        if leaf is None and name in model.layerwise_draws:
            value = None
            for i in range(shape[0]):
                got = convert(model.draw(name, generator, layer=i))
                got = got if isinstance(got, tuple) else (got,)
                if value is None:
                    value = tuple(torch.empty((shape[0], *t.shape),
                                              dtype=t.dtype, device=dev)
                                  for t in got)
                for out, t in zip(value, got):
                    out[i] = t
            if len(value) == 1:
                value = value[0]
        else:
            value = convert(_leaf_tensor(leaf, dev) if leaf is not None
                            else model.draw(name, generator))
        if isinstance(value, tuple):
            q, s = value
            del value
            drop(name)
            put(name + "_q", q, requires_grad=False)
            put(name + "_s", s)
            continue
        if isinstance(leaf, torch.Tensor) and \
                value.data_ptr() == leaf.data_ptr():
            value = value.clone()       # never alias the caller's tensor
        drop(name + "_q", name + "_s")
        put(name, value)
    model.refresh_param_names()


def quantized_from_jax(leaf, device="cpu"):
    """A JAX ``linear.QuantizedParameter`` as the port's: its codes and
    scales as they are (float8 codes through their bytes)."""
    from ..linear.quantization import QuantizedParameter
    codes = np.asarray(leaf.codes)
    if codes.dtype.itemsize == 1 and codes.dtype.kind not in "iu":
        fp8 = (torch.float8_e4m3fn if leaf.mantissa_bits == 3
               else torch.float8_e5m2)
        t = torch.from_numpy(codes.view(np.uint8).copy()).view(fp8)
    else:
        t = torch.from_numpy(np.array(codes))
    return QuantizedParameter(
        t.to(device), torch.from_numpy(np.array(leaf.scales)).to(device),
        tuple(leaf.shape), _TORCH_DTYPES[np.dtype(leaf.dtype).name],
        leaf.q_bits, leaf.q_format, leaf.mantissa_bits)


def lora_from_jax(frozen: dict, adapters: dict, device="cpu"):
    """A JAX ``LoRAModel``'s ``frozen`` tree and ``lora_state.adapters``
    as flat mappings of the port's (``linear.LoRAModel(frozen=...,
    adapters=...)``): float leaves as tensors, a QuantizedParameter as
    the port's, adapters ``{name: {"a", "b"}}`` as tensors."""
    base = {}
    for name, leaf in flatten_tree(dict(frozen.items())).items():
        base[name] = (quantized_from_jax(leaf, device)
                      if hasattr(leaf, "codes")
                      else _leaf_tensor(leaf, device))
    ads = {name: {k: _leaf_tensor(v, device) for k, v in ab.items()}
           for name, ab in adapters.items()}
    return base, ads
