"""Adapters: bring models that are not the port's own into the engine's
model protocol (counterpart of ``deepspeed_tpu/models/adapters.py``).

The engine trains an object with ``params`` (name -> parameter),
``loss(batch)``, ``loss_terms(batch)`` and ``init_params(generator)``.
The reference accepts any ``torch.nn.Module``; the JAX package accepts
flax modules and (init, apply, loss) function triples. Here:

- :class:`FunctionalModel` wraps ``(init_fn, apply_fn[, loss_fn])``:
  ``init_fn(generator)`` returns a nested or flat dict of tensors, held as
  parameters under "/"-joined names; ``apply_fn(params, *args)`` and
  ``loss_fn(params, batch)`` take them in the same structure;
- :class:`ModuleModel` takes the place of JAX's ``FlaxModel`` (flax is
  JAX's module system, ``nn.Module`` the port's): it wraps an ``nn.Module``
  that maps tokens to logits, moves it to ``device`` (None: the card, as
  the reference engine moves its module), and its trainable
  ``named_parameters`` (dots become "/") are the params the engine trains
  in place.

Without ``loss_fn`` the loss is JAX's next-token cross entropy on
``(tokens, targets)`` or ``{"tokens", "targets"}``, with ``loss_terms``
for the engine's exact reduction across ranks. A caller's ``loss_fn``
cannot be split into a sum and a count (``loss_splits`` is false): across
ranks the engine takes it in JAX's forms instead (``runtime/engine.py``
``_micro_loss``): over the global micro-batch on the exact wire, over
each rank's rows, averaged, on the ZeRO++ wire.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.layers import cross_entropy_terms
from ..utils.device import resolve_device
from .convert import flatten_tree

LOSS_FN_TERMS = ("a model with its own loss_fn has no (summed NLL, count "
                 "of targets) form: call loss(batch)")


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _tokens_and_targets(batch):
    if isinstance(batch, dict):
        return batch["tokens"], batch["targets"]
    tokens, targets = batch
    return tokens, targets


class _Adapter:
    """What both adapters share: the default loss and the refusal of a
    caller's ``loss_fn`` in ``loss_terms``."""

    _loss: Optional[Callable] = None
    config = None

    @property
    def loss_splits(self) -> bool:
        """Whether ``loss_terms`` gives (sum, count): the engine's exact
        reduction across ranks reads it, else takes the loss whole."""
        return self._loss is None

    def loss(self, batch) -> torch.Tensor:
        if self._loss is not None:
            return self._custom_loss(batch)
        nll, count = self.loss_terms(batch)
        return nll / torch.clamp(count, min=1)

    def loss_terms(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        if self._loss is not None:
            raise NotImplementedError(LOSS_FN_TERMS)
        tokens, targets = _tokens_and_targets(batch)
        return cross_entropy_terms(self.apply(tokens), targets)

    def partition_rules(self):
        return self._rules


class FunctionalModel(_Adapter):
    """Wrap ``(init_fn, apply_fn[, loss_fn])`` into the model protocol.
    ``init_fn(generator)`` draws the weights (on ``generator.device``);
    they are moved to ``device`` (None: the card) and held as
    parameters. The first draw, at construction, takes a generator seeded
    0; the engine's ``init_params`` draws again from its seed."""

    def __init__(self, init_fn: Callable, apply_fn: Callable,
                 loss_fn: Optional[Callable] = None, partition_rules=None,
                 config=None, *, device=None):
        self._init = init_fn
        self._apply = apply_fn
        self._loss = loss_fn
        self._rules = partition_rules or []
        self.config = config
        self.device = resolve_device(device)
        tree = init_fn(torch.Generator(device=self.device).manual_seed(0))
        self._nested = any(isinstance(v, dict) for v in tree.values())
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.as_tensor(leaf).detach().to(
                self.device).clone())
            for name, leaf in flatten_tree(dict(tree)).items()})

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None) -> None:
        flat = flatten_tree(dict(self._init(generator)))
        if set(flat) != set(self.params.keys()):
            raise ValueError(f"init_fn gave {sorted(flat)}, the model holds "
                             f"{sorted(self.params.keys())}")
        for name, leaf in flat.items():
            self.params[name].copy_(torch.as_tensor(leaf))

    def tree(self) -> dict:
        """The parameters in ``init_fn``'s structure."""
        flat = dict(self.params.items())
        return _unflatten(flat) if self._nested else flat

    def apply(self, *args, **kw):
        return self._apply(self.tree(), *args, **kw)

    def _custom_loss(self, batch):
        return self._loss(self.tree(), batch)


class ModuleModel(_Adapter):
    """Wrap an ``nn.Module`` whose ``forward(tokens)`` gives logits. Its
    parameters that require grad are the params, under their
    ``named_parameters`` names with "/" for "." (the engine trains them in
    place); ``init_params`` keeps the module's own initial weights, as the
    reference trains a module as it is given. ``loss_fn(module, batch)``
    replaces the default loss. The module is moved to ``device`` (None:
    the card); its parameters stay the same objects."""

    def __init__(self, module: nn.Module, loss_fn: Optional[Callable] = None,
                 partition_rules=None, config=None, *, device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self._loss = loss_fn
        self._rules = partition_rules or []
        self.config = config
        self.params = {name.replace(".", "/"): p
                       for name, p in module.named_parameters()
                       if p.requires_grad}
        if not self.params:
            raise ValueError(f"{type(module).__name__} has no trainable "
                             f"parameters")

    def init_params(self, generator: torch.Generator | None = None) -> None:
        del generator       # the module's weights are its init

    def apply(self, *args, **kw):
        return self.module(*args, **kw)

    def _custom_loss(self, batch):
        return self._loss(self.module, batch)


def wrap_model(model, device=None):
    """An ``nn.Module`` -> :class:`ModuleModel`; an ``(init, apply[,
    loss])`` tuple -> :class:`FunctionalModel`, either on ``device``
    (None: the card); anything else raises JAX's ``TypeError``."""
    if isinstance(model, nn.Module):
        return ModuleModel(model, device=device)
    if isinstance(model, (tuple, list)) and len(model) in (2, 3):
        return FunctionalModel(*model, device=device)
    raise TypeError(
        f"cannot adapt {type(model)!r} into the Model protocol; provide an "
        "object with init/apply/loss/partition_rules, a torch nn.Module, or "
        "an (init, apply[, loss]) tuple")
