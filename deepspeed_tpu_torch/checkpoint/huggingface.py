"""Hugging Face pretrained-checkpoint ingestion (counterpart of
``deepspeed_tpu/checkpoint/huggingface.py``; reference: FastGen's
``inference/v2/checkpoint/huggingface_engine.py:16``
``HuggingFaceCheckpointEngine`` with its safetensors fetch at ``:45``,
``inference/v2/engine_factory.py:69`` ``build_hf_engine``, and v1's
``module_inject/load_checkpoint.py:21``).

It reads an HF checkpoint directory (``config.json`` and
``model.safetensors``, sharded ``*.safetensors`` with
``model.safetensors.index.json``, or ``pytorch_model.bin``), translates the
config into the family's ``ModelConfig``, and maps the per-layer tensors
into the stacked ``[L, ...]`` layout of the port's models, with the JAX
package's fifteen mappers, letter for letter:

- torch ``nn.Linear`` stores ``weight`` as ``[out, in]``; the leaves are
  ``[in, out]`` (``y = x @ W``), so they are transposed. GPT-2's ``Conv1D``
  already stores ``[in, out]``;
- per-layer tensors stack on a leading ``L`` axis;
- fused qkv: Phi-3's ``qkv_proj`` is row-blocked ``[q | k | v]``; GPT-NeoX,
  Bloom and non-multiquery Falcon interleave per head ``[H, 3, dh]``;
  Falcon's multi-query and new-decoder layouts group ``[kv, q_per_kv + 2,
  dh]``;
- RoPE: GPT-J rotates interleaved pairs, so its wq/wk rotary columns are
  permuted (even indices first) for the port's half-split rotation;
- OPT's learned positions carry a +2 offset (two unused rows).

Unlike JAX's reader, which widens every float tensor to fp32 numpy, a
tensor keeps the dtype it is stored in (bf16 stays bf16): every mapper
only moves values (transposes, splits, permutations, slices, stacks), so
each leaf cast to fp32 equals JAX's bit for bit, at half the host memory.
Safetensors files are read by this module's own reader (an 8-byte
little-endian header length, a JSON header, then the raw bytes, mapped
from the file with ``np.memmap``), so neither ``safetensors`` nor
``transformers`` is needed. :meth:`HuggingFaceCheckpointEngine.load_params`
with ``lazy=True`` gives a tree of :class:`~..models.convert.Deferred`
leaves, each stacked when the loader (``models/convert.py``
``load_serving_params``) reaches it, so only one leaf exists at a time;
:func:`hf_model` builds the family's model without weights beside that
tree, and ``build_hf_engine``, ``init_inference(path)`` and
:func:`from_pretrained` load through it, the mappers running on the
model's device (each stored tensor copied there as it is, then transposed
and stacked there).
"""

from __future__ import annotations

import importlib
import json
import math
import os
import struct
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.convert import Deferred, load_serving_params, materialize
from ..utils.device import resolve_device

PyTree = Any

# HF `architectures[0]` -> model-registry family name
ARCH_TO_FAMILY = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "mistral",
    "MixtralForCausalLM": "mixtral",
    "GPT2LMHeadModel": "gpt2",
    "OPTForCausalLM": "opt",
    "PhiForCausalLM": "phi",
    "Phi3ForCausalLM": "phi3",
    "Qwen2ForCausalLM": "qwen2",
    "Qwen2MoeForCausalLM": "qwen2_moe",
    "BloomForCausalLM": "bloom",
    "FalconForCausalLM": "falcon",
    "RWForCausalLM": "falcon",
    "GPTJForCausalLM": "gptj",
    "GPTNeoXForCausalLM": "gptneox",
    "InternLMForCausalLM": "internlm",
}

# the safetensors dtypes this reader takes
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                      "F32": torch.float32, "I64": torch.int64,
                      "BOOL": torch.bool}


# ---------------------------------------------------------------------
# safetensors

class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed, each tensor mapped
    from the file on :meth:`get` (copy-on-write, so the tensor is
    writable and the file is never written). ``dtypes`` are the dtypes
    it takes (a training checkpoint's files add int32)."""

    def __init__(self, path: str, dtypes: dict = SAFETENSORS_DTYPES):
        self.path = path
        self.dtypes = dtypes
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path!r}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None)
        self.entries: dict[str, dict] = header
        self._data_start = 8 + n

    def keys(self) -> list[str]:
        return list(self.entries)

    def get(self, key: str) -> torch.Tensor:
        e = self.entries[key]
        if e["dtype"] not in self.dtypes:
            raise NotImplementedError(
                f"{self.path!r}: tensor {key!r} has dtype {e['dtype']}; the "
                f"reader takes {sorted(self.dtypes)}")
        dtype = self.dtypes[e["dtype"]]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).itemsize
        if end - begin != nbytes:
            raise ValueError(f"{self.path!r}: tensor {key!r} holds "
                             f"{end - begin} bytes, its shape {shape} "
                             f"{e['dtype']} needs {nbytes}")
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        raw = np.memmap(self.path, dtype=np.uint8, mode="c",
                        offset=self._data_start + begin, shape=(nbytes,))
        return torch.from_numpy(raw).view(dtype).reshape(shape)


def save_safetensors(tensors: dict[str, torch.Tensor], path: str,
                     metadata: Optional[dict] = None,
                     dtypes: dict = SAFETENSORS_DTYPES) -> int:
    """Write ``tensors`` (CPU, of ``dtypes``' values) as one safetensors
    file, in the given order, the header padded to 8 bytes. Returns the
    bytes of tensor data written."""
    header: dict[str, Any] = {"__metadata__": dict(metadata or
                                                   {"format": "pt"})}
    names = {v: k for k, v in dtypes.items()}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in names:
            raise NotImplementedError(f"{name}: dtype {t.dtype} has no "
                                      f"safetensors name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype],
                        "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().reshape(-1)
                        .view(torch.uint8).numpy())
    return off


# ---------------------------------------------------------------------
# the checkpoint directory

class HuggingFaceCheckpointEngine:
    """Reads an HF checkpoint dir: single or sharded safetensors, or the
    ``pytorch_model.bin`` fallback (reference: huggingface_engine.py:16;
    the safetensors preference mirrors :45). ``device`` (None: the card)
    is where :meth:`get` puts each tensor, and so where the mappers
    transpose and stack: on the card a transpose runs at its memory rate
    instead of the host's ~1 GB/s."""

    def __init__(self, model_path: str, device=None):
        self.path = model_path
        cfg_path = os.path.join(model_path, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(
                f"{model_path!r} is not an HF checkpoint dir (no "
                "config.json). Pass a local directory (from save_pretrained "
                "or a prior download): nothing is fetched")
        with open(cfg_path) as f:
            self.hf_config = json.load(f)
        self._torch_state = None      # lazy pytorch_model.bin fallback
        self._st_files: dict[str, str] = {}   # key -> safetensors path
        idx = os.path.join(model_path, "model.safetensors.index.json")
        single = os.path.join(model_path, "model.safetensors")
        if os.path.exists(idx):
            with open(idx) as f:
                wm = json.load(f)["weight_map"]
            self._st_files = {k: os.path.join(model_path, v)
                              for k, v in wm.items()}
        elif os.path.exists(single):
            self._st_files = {k: single
                              for k in SafetensorsFile(single).keys()}
        elif not os.path.exists(os.path.join(model_path,
                                             "pytorch_model.bin")):
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] or pytorch_model.bin "
                f"in {model_path!r}")
        self._handles: dict[str, SafetensorsFile] = {}
        self.device = resolve_device(device)

    # -- raw tensor access -------------------------------------------
    def _torch(self) -> dict:
        if self._torch_state is None:
            self._torch_state = torch.load(
                os.path.join(self.path, "pytorch_model.bin"),
                map_location="cpu", weights_only=True)
        return self._torch_state

    def keys(self):
        if self._st_files:
            return list(self._st_files)
        return list(self._torch())

    def has(self, key: str) -> bool:
        if self._st_files:
            return key in self._st_files
        return key in self._torch()

    def get(self, key: str) -> torch.Tensor:
        """One tensor on ``device`` in the dtype it is stored in (a bf16
        checkpoint stays bf16; JAX widens floats to fp32 here, which the
        loaders do where they cast)."""
        if self._st_files:
            fname = self._st_files[key]
            if fname not in self._handles:
                self._handles[fname] = SafetensorsFile(fname)
            t = self._handles[fname].get(key)
        else:
            t = self._torch()[key]
            t = t.to_dense() if t.is_sparse else t
        return t.to(self.device)

    # -- config translation ------------------------------------------
    @property
    def family(self) -> str:
        archs = self.hf_config.get("architectures") or []
        for a in archs:
            if a in ARCH_TO_FAMILY:
                return ARCH_TO_FAMILY[a]
        mt = self.hf_config.get("model_type", "")
        by_type = {"llama": "llama", "mistral": "mistral",
                   "mixtral": "mixtral", "gpt2": "gpt2", "opt": "opt",
                   "phi": "phi", "phi3": "phi3", "qwen2": "qwen2",
                   "qwen2_moe": "qwen2_moe", "bloom": "bloom",
                   "falcon": "falcon", "gptj": "gptj",
                   "gpt_neox": "gptneox", "internlm": "internlm"}
        if mt in by_type:
            return by_type[mt]
        raise ValueError(
            f"unsupported HF architecture {archs or mt!r}; supported: "
            f"{sorted(set(ARCH_TO_FAMILY.values()))}")

    def model_config(self, **overrides):
        """Translate config.json into the family's ModelConfig (the role
        of the per-arch containers' config parsing,
        inference/v2/model_implementations/*/policy.py)."""
        hf = self.hf_config
        fam = self.family
        g = hf.get

        def common(**kw):
            out = dict(
                vocab_size=g("vocab_size"),
                hidden_size=g("hidden_size", g("n_embd")),
                num_layers=g("num_hidden_layers", g("n_layer")),
                num_heads=g("num_attention_heads", g("n_head")),
                max_seq_len=g("max_position_embeddings",
                              g("n_positions", 2048)),
            )
            out.update(kw)
            return {k: v for k, v in out.items() if v is not None}

        if fam in ("llama", "mistral", "mixtral", "phi3", "qwen2",
                   "qwen2_moe", "internlm"):
            kw = common(
                **({"use_bias": bool(g("bias", True)),
                    "attn_qkv_bias": bool(g("bias", True))}
                   if fam == "internlm" else {}),
                intermediate_size=g("intermediate_size"),
                num_kv_heads=g("num_key_value_heads"),
                norm_eps=g("rms_norm_eps", 1e-5),
                rope_theta=g("rope_theta", 10000.0),
                tie_embeddings=bool(g("tie_word_embeddings", False)),
                sliding_window=g("sliding_window"),
            )
            if fam == "mixtral":
                kw.update(num_experts=g("num_local_experts", 8),
                          moe_top_k=g("num_experts_per_tok", 2),
                          router_aux_loss_coef=g("router_aux_loss_coef",
                                                 0.02))
            if fam == "qwen2_moe":
                f_moe = g("moe_intermediate_size")
                f_shared = g("shared_expert_intermediate_size", f_moe)
                if f_shared % f_moe != 0:
                    raise NotImplementedError(
                        f"shared_expert_intermediate_size {f_shared} not "
                        f"a multiple of moe_intermediate_size {f_moe}")
                kw.update(num_experts=g("num_experts", 60),
                          moe_top_k=g("num_experts_per_tok", 4),
                          # the fused shared expert's width is expressed
                          # as a multiple of the routed width
                          moe_num_shared_experts=f_shared // f_moe,
                          moe_norm_topk=bool(g("norm_topk_prob", False)),
                          intermediate_size=f_moe,
                          router_aux_loss_coef=g("router_aux_loss_coef",
                                                 0.001))
        elif fam == "gpt2":
            kw = common(
                intermediate_size=g("n_inner") or 4 * g("n_embd"),
                norm_eps=g("layer_norm_epsilon", 1e-5),
                max_seq_len=g("n_positions", g("n_ctx", 1024)),
                tie_embeddings=True,
            )
        elif fam == "opt":
            if g("word_embed_proj_dim", g("hidden_size")) != g("hidden_size"):
                raise NotImplementedError(
                    "OPT word_embed_proj_dim != hidden_size (350m-style "
                    "projected embeddings) is not supported")
            if not g("do_layer_norm_before", True):
                raise NotImplementedError(
                    "OPT do_layer_norm_before=False (post-norm 350m) "
                    "is not supported")
            kw = common(
                intermediate_size=g("ffn_dim"),
                tie_embeddings=bool(g("tie_word_embeddings", True)),
            )
        elif fam == "phi":
            kw = common(
                intermediate_size=g("intermediate_size"),
                norm_eps=g("layer_norm_eps", 1e-5),
                rope_theta=g("rope_theta", 10000.0),
                rotary_pct=g("partial_rotary_factor", 0.5),
                tie_embeddings=bool(g("tie_word_embeddings", False)),
                lm_head_bias=True,
            )
        elif fam == "bloom":
            kw = common(
                hidden_size=g("hidden_size", g("n_embed")),
                intermediate_size=4 * g("hidden_size", g("n_embed")),
                norm_eps=g("layer_norm_epsilon", 1e-5),
                tie_embeddings=True,
            )
            kw.pop("max_seq_len", None)   # alibi: no position table
        elif fam == "falcon":
            d = g("hidden_size")
            nh = g("num_attention_heads", g("n_head"))
            if g("new_decoder_architecture", False):
                kv = g("num_kv_heads", nh)
            elif g("multi_query", True):
                kv = 1
            else:
                kv = nh
            kw = common(
                num_heads=nh,
                num_kv_heads=kv,
                intermediate_size=g("ffn_hidden_size", 4 * d),
                norm_eps=g("layer_norm_epsilon", 1e-5),
                rope_theta=g("rope_theta", 10000.0),
                tie_embeddings=bool(g("tie_word_embeddings", True)),
                parallel_residual=bool(g("parallel_attn", True)),
            )
            if (g("new_decoder_architecture", False)
                    and g("num_ln_in_parallel_attn", 2) != 1):
                kw["parallel_dual_norm"] = True  # ln_attn + ln_mlp (40B)
            if g("alibi", False):
                raise NotImplementedError(
                    "falcon alibi variants are not supported (rope "
                    "falcon only)")
        elif fam == "gptj":
            dh = g("n_embd") // g("n_head")
            kw = common(
                intermediate_size=g("n_inner") or 4 * g("n_embd"),
                norm_eps=g("layer_norm_epsilon", 1e-5),
                rotary_pct=g("rotary_dim", dh) / dh,
                tie_embeddings=bool(g("tie_word_embeddings", False)),
                lm_head_bias=True,
            )
        elif fam == "gptneox":
            kw = common(
                intermediate_size=g("intermediate_size"),
                norm_eps=g("layer_norm_eps", 1e-5),
                rope_theta=g("rotary_emb_base", 10000.0),
                rotary_pct=g("rotary_pct", 1.0),
                tie_embeddings=bool(g("tie_word_embeddings", False)),
            )
            if not g("use_parallel_residual", True):
                kw.update(parallel_residual=False,
                          parallel_dual_norm=False)
        else:
            raise ValueError(f"no config translation for {fam!r}")
        kw.update(overrides)
        mod = importlib.import_module(f"..models.{_family_module(fam)}",
                                      __package__)
        cfg_fn = getattr(mod, f"{fam}_config")
        return cfg_fn("tiny", **kw)

    # -- parameter mapping -------------------------------------------
    def load_params(self, config=None, lazy: bool = False) -> PyTree:
        """The JAX-layout tree of the checkpoint's weights, each leaf in
        its stored dtype on ``device``. ``lazy``: every leaf stays
        :class:`Deferred` until a loader reads it."""
        cfg = config or self.model_config()
        tree = _MAPPERS[self.family](self, cfg)
        return tree if lazy else materialize(tree)


def _family_module(fam: str) -> str:
    return {"qwen2": "qwen", "qwen2_moe": "qwen", "phi3": "phi"}.get(
        fam, fam)


# ---------------------------------------------------------------------
# mapping helpers

def _t(a: torch.Tensor) -> torch.Tensor:
    return a.T.contiguous()


def _lazy(fn: Callable[[], torch.Tensor]) -> Deferred:
    return Deferred(fn)


def _stack(eng, tmpl: str, L: int,
           tf: Optional[Callable] = None) -> Deferred:
    return _lazy(lambda: torch.stack([
        (tf(eng.get(tmpl.format(i=i))) if tf
         else eng.get(tmpl.format(i=i))) for i in range(L)]))


def _stack_parts(eng, tmpl: str, L: int, split: Callable, j: int) -> Deferred:
    """Part ``j`` of ``split(layer i's tensor)``, stacked over the
    layers (JAX splits every layer first and stacks each part)."""
    return _lazy(lambda: torch.stack([split(eng.get(tmpl.format(i=i)))[j]
                                      for i in range(L)]))


def _interleaved_to_half(w_t: torch.Tensor, n_heads: int, head_dim: int,
                         rot_dim: int) -> torch.Tensor:
    """Permute a transposed q/k weight ``[in, H*dh]`` so interleaved
    (every-two, GPT-J) rotary pairs land in the half-split layout: column
    i < rot/2 reads HF column 2i; column rot/2 + i reads 2i + 1."""
    d_in = w_t.shape[0]
    w = w_t.reshape(d_in, n_heads, head_dim)
    perm = torch.cat([torch.arange(0, rot_dim, 2),
                      torch.arange(1, rot_dim, 2),
                      torch.arange(rot_dim, head_dim)]).to(w_t.device)
    return w[:, :, perm].reshape(d_in, n_heads * head_dim).contiguous()


def _llama_like(eng, cfg, prefix="model.", qkv_bias=False, all_bias=False,
                dense_mlp=True):
    L = cfg.num_layers
    p = prefix + "layers.{i}."
    layers = {
        "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
        "ln2_scale": _stack(eng, p + "post_attention_layernorm.weight", L),
        "wq": _stack(eng, p + "self_attn.q_proj.weight", L, _t),
        "wk": _stack(eng, p + "self_attn.k_proj.weight", L, _t),
        "wv": _stack(eng, p + "self_attn.v_proj.weight", L, _t),
        "wo": _stack(eng, p + "self_attn.o_proj.weight", L, _t),
    }
    if dense_mlp:
        layers.update(
            w_gate=_stack(eng, p + "mlp.gate_proj.weight", L, _t),
            w_up=_stack(eng, p + "mlp.up_proj.weight", L, _t),
            w_down=_stack(eng, p + "mlp.down_proj.weight", L, _t))
    if qkv_bias or all_bias:
        for n in ("q", "k", "v"):
            layers[f"w{n}_b"] = _stack(
                eng, p + f"self_attn.{n}_proj.bias", L)
    if all_bias:
        layers["wo_b"] = _stack(eng, p + "self_attn.o_proj.bias", L)
    params = {
        "embed": {"tokens": _lazy(
            lambda: eng.get(prefix + "embed_tokens.weight"))},
        "final_norm": {"scale": _lazy(
            lambda: eng.get(prefix + "norm.weight"))},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _lazy(lambda: _t(eng.get("lm_head.weight")))
    return params


def _map_llama(eng, cfg):
    return _llama_like(eng, cfg)


def _map_qwen2(eng, cfg):
    return _llama_like(eng, cfg, qkv_bias=True)


def _map_internlm(eng, cfg):
    # InternLM-7B uses q/k/v/o biases (config "bias": true)
    return _llama_like(eng, cfg,
                       all_bias=bool(eng.hf_config.get("bias", True)))


def _experts(eng, tmpl: str, L: int, E: int, hf: str) -> Deferred:
    """[L, E, in, out] from ``tmpl``'s layer-i prefix and each expert's
    ``experts.{e}.{hf}.weight`` (transposed)."""
    return _lazy(lambda: torch.stack([
        torch.stack([_t(eng.get(tmpl.format(i=i) + f"experts.{e}.{hf}.weight"))
                     for e in range(E)])
        for i in range(L)]))


def _map_mixtral(eng, cfg):
    params = _llama_like(eng, cfg, dense_mlp=False)
    L, E = cfg.num_layers, cfg.num_experts
    p = "model.layers.{i}.block_sparse_moe."
    params["layers"]["router"] = _stack(eng, p + "gate.weight", L, _t)
    # HF Mixtral experts: w1 = gate, w2 = down, w3 = up
    hf_names = {"w_gate": "w1", "w_down": "w2", "w_up": "w3"}
    params["layers"]["experts"] = {
        ours: _experts(eng, p, L, E, hf) for ours, hf in hf_names.items()}
    return params


def _map_qwen2_moe(eng, cfg):
    params = _llama_like(eng, cfg, qkv_bias=True, dense_mlp=False)
    L, E = cfg.num_layers, cfg.num_experts
    p = "model.layers.{i}.mlp."
    params["layers"]["router"] = _stack(eng, p + "gate.weight", L, _t)
    names = {"w_gate": "gate_proj", "w_up": "up_proj",
             "w_down": "down_proj"}
    params["layers"]["experts"] = {
        ours: _experts(eng, p, L, E, hf) for ours, hf in names.items()}
    params["layers"]["shared"] = {
        "gate_proj": _stack(eng, p + "shared_expert_gate.weight", L, _t),
        **{ours: _stack(eng, p + f"shared_expert.{hf}.weight", L, _t)
           for ours, hf in names.items()},
    }
    return params


def _map_gpt2(eng, cfg):
    L = cfg.num_layers
    p = "transformer.h.{i}."

    def split_qkv_w(w):      # Conv1D [d, 3d]: already [in, out]
        return w.chunk(3, dim=1)

    def split_qkv_b(b):
        return b.chunk(3)

    w_key, b_key = p + "attn.c_attn.weight", p + "attn.c_attn.bias"
    layers = {
        "ln1_scale": _stack(eng, p + "ln_1.weight", L),
        "ln1_bias": _stack(eng, p + "ln_1.bias", L),
        "ln2_scale": _stack(eng, p + "ln_2.weight", L),
        "ln2_bias": _stack(eng, p + "ln_2.bias", L),
        "wq": _stack_parts(eng, w_key, L, split_qkv_w, 0),
        "wk": _stack_parts(eng, w_key, L, split_qkv_w, 1),
        "wv": _stack_parts(eng, w_key, L, split_qkv_w, 2),
        "wq_b": _stack_parts(eng, b_key, L, split_qkv_b, 0),
        "wk_b": _stack_parts(eng, b_key, L, split_qkv_b, 1),
        "wv_b": _stack_parts(eng, b_key, L, split_qkv_b, 2),
        "wo": _stack(eng, p + "attn.c_proj.weight", L),
        "wo_b": _stack(eng, p + "attn.c_proj.bias", L),
        "w_up": _stack(eng, p + "mlp.c_fc.weight", L),
        "w_up_b": _stack(eng, p + "mlp.c_fc.bias", L),
        "w_down": _stack(eng, p + "mlp.c_proj.weight", L),
        "w_down_b": _stack(eng, p + "mlp.c_proj.bias", L),
    }
    return {
        "embed": {"tokens": _lazy(lambda: eng.get("transformer.wte.weight")),
                  "positions": _lazy(
                      lambda: eng.get("transformer.wpe.weight"))},
        "final_norm": {"scale": _lazy(
                           lambda: eng.get("transformer.ln_f.weight")),
                       "bias": _lazy(
                           lambda: eng.get("transformer.ln_f.bias"))},
        "layers": layers,
    }


def _map_opt(eng, cfg):
    L = cfg.num_layers
    p = "model.decoder.layers.{i}."
    layers = {
        "ln1_scale": _stack(eng, p + "self_attn_layer_norm.weight", L),
        "ln1_bias": _stack(eng, p + "self_attn_layer_norm.bias", L),
        "ln2_scale": _stack(eng, p + "final_layer_norm.weight", L),
        "ln2_bias": _stack(eng, p + "final_layer_norm.bias", L),
        "wq": _stack(eng, p + "self_attn.q_proj.weight", L, _t),
        "wq_b": _stack(eng, p + "self_attn.q_proj.bias", L),
        "wk": _stack(eng, p + "self_attn.k_proj.weight", L, _t),
        "wk_b": _stack(eng, p + "self_attn.k_proj.bias", L),
        "wv": _stack(eng, p + "self_attn.v_proj.weight", L, _t),
        "wv_b": _stack(eng, p + "self_attn.v_proj.bias", L),
        "wo": _stack(eng, p + "self_attn.out_proj.weight", L, _t),
        "wo_b": _stack(eng, p + "self_attn.out_proj.bias", L),
        "w_up": _stack(eng, p + "fc1.weight", L, _t),
        "w_up_b": _stack(eng, p + "fc1.bias", L),
        "w_down": _stack(eng, p + "fc2.weight", L, _t),
        "w_down_b": _stack(eng, p + "fc2.bias", L),
    }
    return {
        "embed": {
            "tokens": _lazy(
                lambda: eng.get("model.decoder.embed_tokens.weight")),
            # HF OPTLearnedPositionalEmbedding: position p reads row p+2
            "positions": _lazy(lambda: eng.get(
                "model.decoder.embed_positions.weight")[2:]),
        },
        "final_norm": {
            "scale": _lazy(
                lambda: eng.get("model.decoder.final_layer_norm.weight")),
            "bias": _lazy(
                lambda: eng.get("model.decoder.final_layer_norm.bias"))},
        "layers": layers,
    }


def _map_phi(eng, cfg):
    L = cfg.num_layers
    p = "model.layers.{i}."
    layers = {
        "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
        "ln1_bias": _stack(eng, p + "input_layernorm.bias", L),
        "wq": _stack(eng, p + "self_attn.q_proj.weight", L, _t),
        "wq_b": _stack(eng, p + "self_attn.q_proj.bias", L),
        "wk": _stack(eng, p + "self_attn.k_proj.weight", L, _t),
        "wk_b": _stack(eng, p + "self_attn.k_proj.bias", L),
        "wv": _stack(eng, p + "self_attn.v_proj.weight", L, _t),
        "wv_b": _stack(eng, p + "self_attn.v_proj.bias", L),
        "wo": _stack(eng, p + "self_attn.dense.weight", L, _t),
        "wo_b": _stack(eng, p + "self_attn.dense.bias", L),
        "w_up": _stack(eng, p + "mlp.fc1.weight", L, _t),
        "w_up_b": _stack(eng, p + "mlp.fc1.bias", L),
        "w_down": _stack(eng, p + "mlp.fc2.weight", L, _t),
        "w_down_b": _stack(eng, p + "mlp.fc2.bias", L),
    }
    return {
        "embed": {"tokens": _lazy(
            lambda: eng.get("model.embed_tokens.weight"))},
        "final_norm": {"scale": _lazy(
                           lambda: eng.get("model.final_layernorm.weight")),
                       "bias": _lazy(
                           lambda: eng.get("model.final_layernorm.bias"))},
        "layers": layers,
        "lm_head": _lazy(lambda: _t(eng.get("lm_head.weight"))),
        "lm_head_b": _lazy(lambda: eng.get("lm_head.bias")),
    }


def _map_phi3(eng, cfg):
    L = cfg.num_layers
    d = cfg.hidden_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    p = "model.layers.{i}."

    def split_qkv(w):        # [d + 2*kvd, d] rows blocked q|k|v
        q, k, v = w.tensor_split([d, d + kvd], dim=0)
        return _t(q), _t(k), _t(v)

    def split_gate_up(w):    # [2f, d] rows blocked gate|up
        gate, up = w.chunk(2, dim=0)
        return _t(gate), _t(up)

    qkv_key = p + "self_attn.qkv_proj.weight"
    gu_key = p + "mlp.gate_up_proj.weight"
    layers = {
        "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
        "ln2_scale": _stack(eng, p + "post_attention_layernorm.weight", L),
        "wq": _stack_parts(eng, qkv_key, L, split_qkv, 0),
        "wk": _stack_parts(eng, qkv_key, L, split_qkv, 1),
        "wv": _stack_parts(eng, qkv_key, L, split_qkv, 2),
        "wo": _stack(eng, p + "self_attn.o_proj.weight", L, _t),
        "w_gate": _stack_parts(eng, gu_key, L, split_gate_up, 0),
        "w_up": _stack_parts(eng, gu_key, L, split_gate_up, 1),
        "w_down": _stack(eng, p + "mlp.down_proj.weight", L, _t),
    }
    params = {
        "embed": {"tokens": _lazy(
            lambda: eng.get("model.embed_tokens.weight"))},
        "final_norm": {"scale": _lazy(lambda: eng.get("model.norm.weight"))},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _lazy(lambda: _t(eng.get("lm_head.weight")))
    return params


def _split_headwise(w, n_heads, head_dim, d):
    """[H*3*dh, d] per-head-interleaved fused qkv (Bloom/GPT-NeoX/
    non-multiquery Falcon) -> three transposed [d, H*dh] mats."""
    g = w.reshape(n_heads, 3, head_dim, d)
    return tuple(_t(g[:, j].reshape(n_heads * head_dim, d))
                 for j in range(3))


def _split_headwise_b(b, n_heads, head_dim):
    g = b.reshape(n_heads, 3, head_dim)
    return tuple(g[:, j].reshape(-1) for j in range(3))


def _map_bloom(eng, cfg):
    L, H, dh, d = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                   cfg.hidden_size)
    p = "transformer.h.{i}."
    w_key = p + "self_attention.query_key_value.weight"
    b_key = p + "self_attention.query_key_value.bias"

    def split_w(w):
        return _split_headwise(w, H, dh, d)

    def split_b(b):
        return _split_headwise_b(b, H, dh)

    layers = {
        "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
        "ln1_bias": _stack(eng, p + "input_layernorm.bias", L),
        "ln2_scale": _stack(eng, p + "post_attention_layernorm.weight", L),
        "ln2_bias": _stack(eng, p + "post_attention_layernorm.bias", L),
        "wq": _stack_parts(eng, w_key, L, split_w, 0),
        "wk": _stack_parts(eng, w_key, L, split_w, 1),
        "wv": _stack_parts(eng, w_key, L, split_w, 2),
        "wq_b": _stack_parts(eng, b_key, L, split_b, 0),
        "wk_b": _stack_parts(eng, b_key, L, split_b, 1),
        "wv_b": _stack_parts(eng, b_key, L, split_b, 2),
        "wo": _stack(eng, p + "self_attention.dense.weight", L, _t),
        "wo_b": _stack(eng, p + "self_attention.dense.bias", L),
        "w_up": _stack(eng, p + "mlp.dense_h_to_4h.weight", L, _t),
        "w_up_b": _stack(eng, p + "mlp.dense_h_to_4h.bias", L),
        "w_down": _stack(eng, p + "mlp.dense_4h_to_h.weight", L, _t),
        "w_down_b": _stack(eng, p + "mlp.dense_4h_to_h.bias", L),
    }
    return {
        "embed": {
            "tokens": _lazy(
                lambda: eng.get("transformer.word_embeddings.weight")),
            "ln_scale": _lazy(lambda: eng.get(
                "transformer.word_embeddings_layernorm.weight")),
            "ln_bias": _lazy(lambda: eng.get(
                "transformer.word_embeddings_layernorm.bias"))},
        "final_norm": {"scale": _lazy(
                           lambda: eng.get("transformer.ln_f.weight")),
                       "bias": _lazy(
                           lambda: eng.get("transformer.ln_f.bias"))},
        "layers": layers,
    }


def _map_falcon(eng, cfg):
    L, H, dh, d = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                   cfg.hidden_size)
    kv = cfg.num_kv_heads
    hf = eng.hf_config
    p = "transformer.h.{i}."
    new_arch = hf.get("new_decoder_architecture", False)
    multi_query = hf.get("multi_query", True)

    def split_qkv(w):
        if not new_arch and not multi_query:
            return _split_headwise(w, H, dh, d)
        # grouped layout [kv, q_per_kv + 2, dh, d]
        g = H // kv
        a = w.reshape(kv, g + 2, dh, d)
        q = _t(a[:, :g].reshape(kv * g * dh, d))
        k = _t(a[:, g].reshape(kv * dh, d))
        v = _t(a[:, g + 1].reshape(kv * dh, d))
        return q, k, v

    w_key = p + "self_attention.query_key_value.weight"
    if cfg.parallel_dual_norm:   # 40B/180B: ln_attn + ln_mlp
        norms = {
            "ln1_scale": _stack(eng, p + "ln_attn.weight", L),
            "ln1_bias": _stack(eng, p + "ln_attn.bias", L),
            "ln2_scale": _stack(eng, p + "ln_mlp.weight", L),
            "ln2_bias": _stack(eng, p + "ln_mlp.bias", L),
        }
    else:
        norms = {
            "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
            "ln1_bias": _stack(eng, p + "input_layernorm.bias", L),
        }
        if not cfg.parallel_residual:   # sequential blocks need ln2
            norms.update(
                ln2_scale=_stack(
                    eng, p + "post_attention_layernorm.weight", L),
                ln2_bias=_stack(
                    eng, p + "post_attention_layernorm.bias", L))
    layers = {
        **norms,
        "wq": _stack_parts(eng, w_key, L, split_qkv, 0),
        "wk": _stack_parts(eng, w_key, L, split_qkv, 1),
        "wv": _stack_parts(eng, w_key, L, split_qkv, 2),
        "wo": _stack(eng, p + "self_attention.dense.weight", L, _t),
        "w_up": _stack(eng, p + "mlp.dense_h_to_4h.weight", L, _t),
        "w_down": _stack(eng, p + "mlp.dense_4h_to_h.weight", L, _t),
    }
    params = {
        "embed": {"tokens": _lazy(
            lambda: eng.get("transformer.word_embeddings.weight"))},
        "final_norm": {"scale": _lazy(
                           lambda: eng.get("transformer.ln_f.weight")),
                       "bias": _lazy(
                           lambda: eng.get("transformer.ln_f.bias"))},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _lazy(lambda: _t(eng.get("lm_head.weight")))
    return params


def _map_gptj(eng, cfg):
    L, H, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    rot = int(dh * cfg.rotary_pct) // 2 * 2
    p = "transformer.h.{i}."

    def rope_fix(w):
        return _interleaved_to_half(_t(w), H, dh, rot)

    layers = {
        "ln1_scale": _stack(eng, p + "ln_1.weight", L),
        "ln1_bias": _stack(eng, p + "ln_1.bias", L),
        "wq": _stack(eng, p + "attn.q_proj.weight", L, rope_fix),
        "wk": _stack(eng, p + "attn.k_proj.weight", L, rope_fix),
        "wv": _stack(eng, p + "attn.v_proj.weight", L, _t),
        "wo": _stack(eng, p + "attn.out_proj.weight", L, _t),
        "w_up": _stack(eng, p + "mlp.fc_in.weight", L, _t),
        "w_up_b": _stack(eng, p + "mlp.fc_in.bias", L),
        "w_down": _stack(eng, p + "mlp.fc_out.weight", L, _t),
        "w_down_b": _stack(eng, p + "mlp.fc_out.bias", L),
    }
    return {
        "embed": {"tokens": _lazy(lambda: eng.get("transformer.wte.weight"))},
        "final_norm": {"scale": _lazy(
                           lambda: eng.get("transformer.ln_f.weight")),
                       "bias": _lazy(
                           lambda: eng.get("transformer.ln_f.bias"))},
        "layers": layers,
        "lm_head": _lazy(lambda: _t(eng.get("lm_head.weight"))),
        "lm_head_b": _lazy(lambda: eng.get("lm_head.bias")),
    }


def _map_gptneox(eng, cfg):
    L, H, dh, d = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                   cfg.hidden_size)
    p = "gpt_neox.layers.{i}."
    w_key = p + "attention.query_key_value.weight"
    b_key = p + "attention.query_key_value.bias"

    def split_w(w):
        return _split_headwise(w, H, dh, d)

    def split_b(b):
        return _split_headwise_b(b, H, dh)

    layers = {
        "ln1_scale": _stack(eng, p + "input_layernorm.weight", L),
        "ln1_bias": _stack(eng, p + "input_layernorm.bias", L),
        "ln2_scale": _stack(eng, p + "post_attention_layernorm.weight", L),
        "ln2_bias": _stack(eng, p + "post_attention_layernorm.bias", L),
        "wq": _stack_parts(eng, w_key, L, split_w, 0),
        "wk": _stack_parts(eng, w_key, L, split_w, 1),
        "wv": _stack_parts(eng, w_key, L, split_w, 2),
        "wq_b": _stack_parts(eng, b_key, L, split_b, 0),
        "wk_b": _stack_parts(eng, b_key, L, split_b, 1),
        "wv_b": _stack_parts(eng, b_key, L, split_b, 2),
        "wo": _stack(eng, p + "attention.dense.weight", L, _t),
        "wo_b": _stack(eng, p + "attention.dense.bias", L),
        "w_up": _stack(eng, p + "mlp.dense_h_to_4h.weight", L, _t),
        "w_up_b": _stack(eng, p + "mlp.dense_h_to_4h.bias", L),
        "w_down": _stack(eng, p + "mlp.dense_4h_to_h.weight", L, _t),
        "w_down_b": _stack(eng, p + "mlp.dense_4h_to_h.bias", L),
    }
    return {
        "embed": {"tokens": _lazy(
            lambda: eng.get("gpt_neox.embed_in.weight"))},
        "final_norm": {
            "scale": _lazy(
                lambda: eng.get("gpt_neox.final_layer_norm.weight")),
            "bias": _lazy(
                lambda: eng.get("gpt_neox.final_layer_norm.bias"))},
        "layers": layers,
        "lm_head": _lazy(lambda: _t(eng.get("embed_out.weight"))),
    }


_MAPPERS = {
    "llama": _map_llama,
    "mistral": _map_llama,
    "mixtral": _map_mixtral,
    "qwen2": _map_qwen2,
    "qwen2_moe": _map_qwen2_moe,
    "internlm": _map_internlm,
    "gpt2": _map_gpt2,
    "opt": _map_opt,
    "phi": _map_phi,
    "phi3": _map_phi3,
    "bloom": _map_bloom,
    "falcon": _map_falcon,
    "gptj": _map_gptj,
    "gptneox": _map_gptneox,
}


def hf_model(model_path: str, device=None, dtype=None, map_device=None,
             **config_overrides):
    """(model, params) for an HF checkpoint directory: the family's model
    built on ``device`` (None: the card) in ``dtype`` (None: its config's)
    without weights (``deferred_weights``), and the lazy JAX-layout tree
    of the checkpoint's weights, each leaf mapped on ``map_device`` (None:
    ``device``) when a loader reads it. ``config_overrides`` pass through
    to the family's ModelConfig (``max_seq_len=...``,
    ``attn_impl="flash"``)."""
    from ..models import get_model_class
    from ..models.transformer import deferred_weights
    dev = resolve_device(device)
    eng = HuggingFaceCheckpointEngine(
        model_path, device=dev if map_device is None else map_device)
    cfg = eng.model_config(**config_overrides)
    with deferred_weights():        # the loader gives every leaf
        model = get_model_class(eng.family)(cfg, device=dev, dtype=dtype)
    return model, eng.load_params(cfg, lazy=True)


def from_pretrained(model_path: str, device=None, **config_overrides):
    """(model, params) from an HF checkpoint directory, the top-level
    ingestion entry (reference: engine_factory.py:69 build_hf_engine's
    policy + checkpoint-engine pairing). The model is built on ``device``
    (None: the card) in its config's dtype with the checkpoint's weights
    loaded leaf by leaf, each mapped on ``device``; ``params`` is
    :func:`hf_model`'s lazy tree, each leaf read again in its stored
    dtype only when used (``initialize(model=model,
    model_parameters=params)`` fine-tunes from it; ``materialize`` gives
    the tensors). ``config_overrides`` as :func:`hf_model`'s."""
    model, params = hf_model(model_path, device, **config_overrides)
    load_serving_params(model, params, None, model.config.param_dtype,
                        quantize=False)
    return model, params
