"""Checkpoint package of the port (counterpart of
``deepspeed_tpu/checkpoint/``; reference: deepspeed/checkpoint/): the
universal format (``universal.py``), fp32 consolidation
(``zero_to_fp32.py``) and Hugging Face checkpoint directories
(``huggingface.py``)."""

from .huggingface import HuggingFaceCheckpointEngine, from_pretrained
from .universal import (ds_to_universal, flatten_with_names,
                        load_universal_checkpoint)
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                           get_fp32_state_dict_from_zero_checkpoint)

__all__ = ["HuggingFaceCheckpointEngine", "from_pretrained",
           "ds_to_universal", "flatten_with_names",
           "load_universal_checkpoint",
           "convert_zero_checkpoint_to_fp32_state_dict",
           "get_fp32_state_dict_from_zero_checkpoint"]
