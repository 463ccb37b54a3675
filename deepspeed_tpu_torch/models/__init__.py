"""Model families of the port (importing this registers them)."""

from .base import ModelConfig, get_model_class, register_model  # noqa: F401
from .convert import load_jax_params  # noqa: F401
from .gpt2 import GPT2, gpt2_config  # noqa: F401
from .llama import Llama, llama_config  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
