"""Model families of the port (importing this registers them)."""

from .adapters import FunctionalModel, ModuleModel, wrap_model  # noqa: F401
from .base import ModelConfig, get_model_class, register_model  # noqa: F401
from .bert import Bert, BertConfig, bert_config  # noqa: F401
from .bloom import Bloom, bloom_config  # noqa: F401
from .convert import load_jax_params  # noqa: F401
from .falcon import Falcon, falcon_config  # noqa: F401
from .gpt2 import GPT2, gpt2_config  # noqa: F401
from .gptj import GPTJ, gptj_config  # noqa: F401
from .gptneox import GPTNeoX, gptneox_config  # noqa: F401
from .internlm import InternLM, internlm_config  # noqa: F401
from .llama import Llama, llama_config  # noqa: F401
from .mistral import Mistral, mistral_config  # noqa: F401
from .mixtral import Mixtral, mixtral_config  # noqa: F401
from .opt import OPT, opt_config  # noqa: F401
from .phi import Phi, Phi3, phi3_config, phi_config  # noqa: F401
from .qwen import (Qwen, Qwen2, Qwen2MoE, qwen2_config,  # noqa: F401
                   qwen2_moe_config, qwen_config)
from .transformer import DecoderLM  # noqa: F401
