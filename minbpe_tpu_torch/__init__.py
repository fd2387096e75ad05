"""minbpe_tpu_torch — the PyTorch and CUDA port of minbpe_tpu.

Byte-level BPE (the karpathy/minbpe contract: train, encode, decode,
``minbpe v1`` save/load, special tokens, GPT-4's ranks and byte shuffle)
for one NVIDIA H100. Training and
encode run through hand-written sm_90a kernels (csrc/bpe_kernels.cu);
``device="cpu"`` runs their plain PyTorch versions instead. The public API
mirrors minbpe_tpu's.
"""

from .base import Tokenizer
from .basic import BasicTokenizer
from .regex import RegexTokenizer, GPT2_SPLIT_PATTERN, GPT4_SPLIT_PATTERN
from .gpt4 import GPT4Tokenizer

__all__ = [
    "Tokenizer",
    "BasicTokenizer",
    "RegexTokenizer",
    "GPT4Tokenizer",
    "GPT2_SPLIT_PATTERN",
    "GPT4_SPLIT_PATTERN",
]
