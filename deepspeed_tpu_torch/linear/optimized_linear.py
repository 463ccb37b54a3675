"""OptimizedLinear and LoRA over (optionally quantized) frozen base
weights (counterpart of ``deepspeed_tpu/linear/optimized_linear.py``;
reference: deepspeed/linear/optimized_linear.py OptimizedLinear /
LoRAOptimizedLinear).

``OptimizedLinear`` is an ``nn.Module``: a frozen base (a tensor or a
:class:`QuantizedParameter`) and the trainable ``lora_a`` / ``lora_b``, ``y
= x W + (x A) B * alpha / r``. ``lora_transform`` splits a model's flat
parameters (``"layers/wq"``) into the frozen base and fresh adapters by
whole path components, as the JAX ``_target_paths`` does, or by
``target_regex``. :class:`LoRAModel` wraps a ``DecoderLM`` so that its
``params`` are the adapters alone: ``initialize`` then keeps the fp32
master and the optimizer state for them only, and the frozen base stays on
the device outside the master (the reference's ``requires_grad=False``).

The forward never builds the whole effective tree. ``LoRAModel`` runs the
wrapped model on a source of weights (``DecoderLM.using_weights``) whose
layer mapping computes each weight where the model reads it: the frozen
layer slice (a layer's blocks of a quantized stack, dequantized by the
kernel on the card) plus ``(a[l] @ b[l]) * alpha / r``. Under a remat
policy those reads sit inside the recomputed segments, so autograd keeps
no layer's effective weight.

Across ranks the engine calls :meth:`LoRAModel.place_frozen`, which
splits the frozen base over the fsdp axis as JAX's ``place_frozen`` does
(``fsdp_spec_tree``'s rule, ``linear/quantization.py``
``fsdp_split_dim``): a QuantizedParameter's codes and scales each on its
own dim, a float leaf as a :class:`PlacedTensor`. A read of layer l then
gathers that layer's blocks (or slice) from the ranks that hold them,
where the weight is read: in the forward and again in a recomputed
segment. The leaves outside the stacks (the embeddings, the final norm)
are gathered whole once a forward. The adapters are the engine's params
and go through the ZeRO plan as any params do; at stage 3 on the exact
wire the engine gives their layers through ``using_weights``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable

import torch
from torch import nn

from ..utils.device import resolve_device
from .config import LoRAConfig, QuantizationConfig
from .quantization import (FrozenSplit, fsdp_split_dim, is_quantized,
                           quantize_param)


class OptimizedLinear(nn.Module):
    """y = x @ W_base(frozen, maybe quantized) + (x @ A) @ B * alpha/r
    (reference: optimized_linear.py:20). ``base_weight`` ``[in, out]``
    defaults to a normal draw over sqrt(in); ``lora_a`` is a normal draw
    over sqrt(r), ``lora_b`` zeros, so the layer starts as its base."""

    def __init__(self, input_dim: int, output_dim: int,
                 lora_config: LoRAConfig | None = None,
                 quantization_config: QuantizationConfig | None = None,
                 bias: bool = False, dtype=torch.float32, device=None,
                 base_weight: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.lora = lora_config or LoRAConfig()
        self.quant = quantization_config
        r = self.lora.lora_r
        with torch.no_grad():
            if base_weight is None:
                base_weight = torch.randn(
                    (input_dim, output_dim), generator=generator,
                    device=dev, dtype=dtype) / input_dim ** 0.5
            base_weight = base_weight.detach().to(dev, dtype)
            self.base = (quantize_param(base_weight, self.quant)
                         if self.quant is not None else base_weight)
            self.lora_a = nn.Parameter(torch.randn(
                (input_dim, r), generator=generator, device=dev,
                dtype=dtype) / r ** 0.5)
        self.lora_b = nn.Parameter(torch.zeros((r, output_dim), device=dev,
                                               dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(output_dim, device=dev,
                                              dtype=dtype)) if bias else None)

    def base_weight(self) -> torch.Tensor:
        w = self.base
        return w.dequantized() if is_quantized(w) else w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.base_weight().to(x.dtype)
        scale = self.lora.lora_alpha / self.lora.lora_r
        y = y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) \
            * scale
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


@dataclasses.dataclass
class LoRAState:
    """Adapter params + the config of the transform back to effective
    weights."""
    adapters: dict              # {path: {"a": ..., "b": ...}}
    lora_config: LoRAConfig


def _target_paths(params: dict, cfg: LoRAConfig) -> list[str]:
    """The 2-D / 3-D leaves one of whose path components is a target
    (whole components: ``wq`` targets ``layers/wq``, not ``layers/wq_b``)."""
    return [name for name, leaf in params.items()
            if leaf.ndim in (2, 3)
            and any(t in name.split("/") for t in cfg.target_mods)]


def lora_transform(params: dict, lora_config: LoRAConfig | None = None,
                   quantization_config: QuantizationConfig | None = None,
                   generator: torch.Generator | None = None,
                   target_regex: str | None = None
                   ) -> tuple[dict, LoRAState, Callable]:
    """Split flat model parameters into (frozen_base, adapters, merge_fn).

    - frozen base: the targeted 2-D weights and 3-D layer stacks ``[L,
      in, out]``, quantized per ``quantization_config`` where it is given,
      and every other leaf as it is (detached);
    - adapters: fresh ``{a [..., in, r], b [..., r, out]}`` per target
      (``b`` zero, so the merged model starts as the base), drawn from
      ``generator`` in the parameters' order;
    - merge_fn(base, adapters) -> effective parameters.

    Raises ``ValueError`` (the JAX message) when nothing is targeted."""
    cfg = lora_config or LoRAConfig()
    targets = (set(_target_paths(params, cfg)) if target_regex is None
               else None)

    def is_target(name):
        if target_regex is not None:
            return re.search(target_regex, name) is not None
        return name in targets

    frozen, adapters = {}, {}
    with torch.no_grad():
        for name, leaf in params.items():
            if not is_quantized(leaf):
                leaf = leaf.detach()
            if leaf.ndim in (2, 3) and is_target(name):
                *stack, fan_in, fan_out = leaf.shape
                dev = leaf.codes.device if is_quantized(leaf) \
                    else leaf.device
                adapters[name] = {
                    "a": torch.randn((*stack, fan_in, cfg.lora_r),
                                     generator=generator, device=dev,
                                     dtype=leaf.dtype) / cfg.lora_r ** 0.5,
                    "b": torch.zeros((*stack, cfg.lora_r, fan_out),
                                     device=dev, dtype=leaf.dtype),
                }
                if not is_quantized(leaf) and quantization_config is not None:
                    leaf = quantize_param(leaf, quantization_config)
            frozen[name] = leaf
    if not adapters:
        wanted = (target_regex if target_regex is not None
                  else cfg.target_mods)
        raise ValueError(
            f"lora_transform matched no weights: targets {wanted!r} name "
            f"no 2-D/3-D leaf in the parameter tree. Training would "
            f"silently optimize an empty adapter tree. Set "
            f"LoRAConfig.target_mods (or target_regex) to names that "
            f"appear in the model, e.g. wq/wk/wv/wo/w_gate/w_up/w_down "
            f"for this repo's DecoderLM.")
    return frozen, LoRAState(adapters, cfg), make_merge_fn(cfg)


def _merged(leaf: torch.Tensor, a, b, scale: float) -> torch.Tensor:
    """The JAX merge's ``leaf + (a @ b).astype(leaf.dtype) * scale``."""
    return leaf + (a @ b).to(leaf.dtype) * scale


@dataclasses.dataclass
class PlacedTensor:
    """A float frozen leaf split over ranks (:meth:`LoRAModel.
    place_frozen`): this rank's ``shard`` of the whole ``shape``."""

    shard: torch.Tensor
    split: FrozenSplit

    @property
    def shape(self) -> tuple:
        return self.split.full_shape(self.shard.shape)

    @property
    def ndim(self) -> int:
        return self.shard.ndim

    @property
    def dtype(self):
        return self.shard.dtype

    @property
    def nbytes(self) -> int:
        return self.shard.numel() * self.shard.element_size()

    def full(self) -> torch.Tensor:
        """The whole leaf, gathered (a collective)."""
        return self.split.rows(self.shard, 0, self.shape[0])

    def layer(self, layer: int) -> torch.Tensor:
        """Row ``layer`` of dim 0 (a stack's layer), gathered."""
        return self.split.rows(self.shard, layer, layer + 1)[0]


def _place(leaf, world: int, index: int, group):
    """``leaf`` split over ``world`` fsdp ranks as JAX's ``fsdp_spec_tree``
    splits it (a leaf it keeps whole, as it is)."""
    if is_quantized(leaf):
        return leaf.placed(world, index, group)
    if isinstance(leaf, PlacedTensor):
        raise ValueError("the frozen base is placed already")
    dim = fsdp_split_dim(tuple(leaf.shape), world)
    if dim is None:
        return leaf
    split = FrozenSplit(dim, world, index, group)
    return PlacedTensor(split.cut(leaf), split)


def _whole(leaf) -> torch.Tensor:
    """A frozen leaf in full: dequantized, or gathered where placed."""
    if is_quantized(leaf):
        return leaf.dequantized()
    if isinstance(leaf, PlacedTensor):
        return leaf.full()
    return leaf


def make_merge_fn(cfg: LoRAConfig, stop_gradient: bool = True) -> Callable:
    """merge(base, adapters) -> effective flat parameters (each base leaf
    dequantized, plus its adapters' ``a @ b * alpha / r``). With
    ``stop_gradient`` the base is detached, so grads flow only into the
    adapters."""
    scale = cfg.lora_alpha / cfg.lora_r

    def merge(base: dict, adapters: dict) -> dict:
        out = {}
        for name, leaf in base.items():
            leaf = _whole(leaf)
            if stop_gradient:
                leaf = leaf.detach()
            ad = adapters.get(name)
            if ad is not None:
                leaf = _merged(leaf, ad["a"], ad["b"], scale)
            out[name] = leaf
        return out

    return merge


def fuse_lora(base: dict, state: LoRAState) -> dict:
    """Materialize the adapters into the base weights (reference:
    hybrid_engine.py:132 _fuse_lora before generation): flat float
    parameters a serving engine takes as ``params``."""
    with torch.no_grad():
        return make_merge_fn(state.lora_config, stop_gradient=False)(
            base, state.adapters)


def _base_layer(leaf, layer: int) -> torch.Tensor:
    """Layer ``layer`` of a frozen ``[L, ...]`` stack: a view, or for a
    QuantizedParameter the blocks holding it dequantized (the dequantize
    kernel on the card); placed across ranks, gathered from the ranks
    that hold it."""
    if isinstance(leaf, PlacedTensor):
        return leaf.layer(layer)
    if not is_quantized(leaf):
        return leaf[layer]
    per = leaf.numel // leaf.shape[0]
    return leaf.dequantize_range(layer * per, (layer + 1) * per).view(
        leaf.shape[1:])


class _LayerWeights:
    """Layer ``layer``'s parameters keyed as in JAX ``p``, each computed
    where the model reads it (so inside whatever segment recomputes it),
    the adapters from the source the forward ran on."""

    def __init__(self, lora: "LoRAModel", layer: int):
        self._lora, self._layer = lora, layer
        self._source = lora._source

    def __contains__(self, key: str) -> bool:
        return "layers/" + key in self._lora.frozen

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self:
            raise KeyError(key)
        name, lora = "layers/" + key, self._lora
        w = _base_layer(lora.frozen[name], self._layer)
        if name in lora.targets:
            source = self._source
            if source is None:
                a = lora.params[name + "/a"][self._layer]
                b = lora.params[name + "/b"][self._layer]
            else:
                layer = source.layer(self._layer)
                a, b = layer[key + "/a"], layer[key + "/b"]
            w = _merged(w, a, b, lora.scale)
        return w

    def get(self, key: str, default=None):
        return self[key] if key in self else default


class _LoRAWeights:
    """The weights ``DecoderLM.using_weights`` runs the wrapped model on."""

    def __init__(self, lora: "LoRAModel"):
        self._lora = lora

    def __getitem__(self, name: str) -> torch.Tensor:
        lora = self._lora
        whole = lora._whole_cache
        if whole is not None and name in whole:
            leaf = whole[name]
        else:
            leaf = _whole(lora.frozen[name])
            if whole is not None:
                whole[name] = leaf
        if name in lora.targets:
            params = lora.params if lora._source is None else lora._source
            leaf = _merged(leaf, params[name + "/a"], params[name + "/b"],
                           lora.scale)
        return leaf

    def __contains__(self, name: str) -> bool:
        return name in self._lora.frozen

    def layer(self, layer: int) -> _LayerWeights:
        return _LayerWeights(self._lora, layer)


class LoRAModel(nn.Module):
    """Wrap a ``DecoderLM`` so that the adapters are the trainable
    parameters and the base stays frozen, quantized per
    ``quantization_config``: ``initialize(model=LoRAModel(...))`` trains
    the adapters only (reference: LoRAOptimizedLinear's base weights with
    ``requires_grad=False``).

    The base is drawn from ``seed`` (the model's ``init_params``, as JAX
    draws it from ``module.init(PRNGKey(seed))``) and the adapters from
    ``seed + 1``; or both are given as they are, ``frozen`` (flat, float
    tensors and
    ``QuantizedParameter``s) and ``adapters`` (``{name: {"a", "b"}}``),
    e.g. from ``models/convert.py`` ``lora_from_jax``. ``params`` holds
    the adapters as ``"layers/wq/a"``, ``"layers/wq/b"``; the wrapped
    model's own parameter dict is emptied, its weights held by
    ``frozen``."""

    def __init__(self, module, lora_config: LoRAConfig | None = None,
                 quantization_config: QuantizationConfig | None = None,
                 target_regex: str | None = None, seed: int = 0,
                 frozen: dict | None = None, adapters: dict | None = None):
        super().__init__()
        self.module = module
        self.config = module.config
        self.device = module.device
        cfg = lora_config or LoRAConfig()
        if (frozen is None) != (adapters is None):
            raise ValueError("frozen and adapters are given together")
        if frozen is None:
            module.init_params(torch.Generator(
                device=self.device).manual_seed(seed))
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            frozen, state, _ = lora_transform(
                dict(module.params), cfg, quantization_config, gen,
                target_regex)
            adapters = state.adapters
        self.lora_state = LoRAState(adapters, cfg)
        self.merge = make_merge_fn(cfg)
        self.frozen = frozen
        self.targets = frozenset(adapters)
        self.scale = cfg.lora_alpha / cfg.lora_r
        self.params = nn.ParameterDict({
            f"{name}/{k}": nn.Parameter(ab[k].detach().clone())
            for name, ab in adapters.items() for k in ("a", "b")})
        # the model runs on the frozen base and the adapters alone: its own
        # parameters are released (a float base leaf that was not
        # quantized shares their storage)
        for name in list(module.params):
            del module.params[name]
        self._weights = _LoRAWeights(self)
        self._source = None        # the engine's weights of the adapters
        self._whole_cache = None   # a forward's whole frozen leaves
        self._placed = None        # (fsdp size, index) once placed

    def place_frozen(self, topology) -> None:
        """Split the frozen base over the topology's fsdp axis, as JAX's
        ``place_frozen`` shards it with ``fsdp_spec_tree`` (the engine
        calls it once the mesh exists; a collective that makes the fsdp
        groups): each leaf of at least 4096 elements on its largest dim
        that the fsdp size divides, a QuantizedParameter's codes and
        scales each on its own. Nothing moves at fsdp size 1."""
        from ..utils import groups
        world = topology.sizes["fsdp"]
        index = topology.axis_index(("fsdp",))
        if world <= 1 or self._placed == (world, index):
            return
        group = groups.axis_group(("fsdp",), topology)
        self.frozen = {name: _place(leaf, world, index, group)
                       for name, leaf in self.frozen.items()}
        self._placed = (world, index)

    def frozen_bytes(self) -> int:
        """The frozen base's bytes on this rank."""
        return sum(leaf.nbytes for leaf in self.frozen.values())

    @contextlib.contextmanager
    def using_weights(self, source):
        """Read the adapters from ``source`` (the engine's per-layer
        ZeRO-3 schedule: ``source[name]``, ``source.layer(i)[key]``)
        instead of :attr:`params`."""
        prev, self._source = self._source, source
        try:
            yield
        finally:
            self._source = prev

    @contextlib.contextmanager
    def _reading(self):
        """One pass of the wrapped model on the merged weights: each whole
        frozen leaf (the embeddings, the final norm) read once, the layers
        where they are read."""
        with self.module.using_weights(self._weights):
            if self._whole_cache is not None:
                yield
                return
            self._whole_cache = {}
            try:
                yield
            finally:
                self._whole_cache = None

    # --- the engine's protocol (DecoderLM's) ---------------------------
    def init_params(self, generator=None) -> None:
        """The adapters were drawn when the model was built (JAX's
        ``LoRAModel.init`` ignores its key too)."""

    def adapters(self) -> dict:
        """``{name: {"a", "b"}}`` of the current adapter parameters."""
        return {name: {k: self.params[f"{name}/{k}"] for k in ("a", "b")}
                for name in self.targets}

    def effective_params(self, adapters: dict | None = None) -> dict:
        """The whole merged tree (JAX ``effective_params``); the forward
        never builds it."""
        return self.merge(self.frozen, adapters or self.adapters())

    def lora_state_now(self) -> LoRAState:
        """The trained adapters as a :class:`LoRAState`, for
        :func:`fuse_lora`."""
        return LoRAState({n: {k: v.detach() for k, v in ab.items()}
                          for n, ab in self.adapters().items()},
                         self.lora_state.lora_config)

    def loss(self, batch) -> torch.Tensor:
        with self._reading():
            return self.module.loss(batch)

    def loss_terms(self, batch):
        with self._reading():
            return self.module.loss_terms(batch)

    def apply(self, tokens, positions=None) -> torch.Tensor:
        with self._reading():
            return self.module.apply(tokens, positions)

    forward = apply

    def init_cache(self, *a, **kw):
        with self._reading():
            return self.module.init_cache(*a, **kw)

    def decode(self, tokens, cache):
        with self._reading():
            return self.module.decode(tokens, cache)

    def flops_per_token(self, *a, **kw):
        """The wrapped model's, None where it has none (JAX :260-262; the
        engine reads its config's)."""
        return self.module.flops_per_token(*a, **kw) \
            if hasattr(self.module, "flops_per_token") else None
